"""Kernels A and D: fused multi-context decode cross-attention over an fp
K/V cache (A) or an int8 / nibble-packed int4 one (D); kernel F: the
single-shot form of the same attention, with its int4-split form.

Kernel A replaces tell_tpu/ops/kernels/decode_attention.py::
fused_decode_attention (pallas_call at :216) AND its S-tiled
online-softmax form _tiled_decode_attention (pallas_call at :177) with one
CUDA kernel (tell_tpu_torch/csrc/decode_attention.cu); kernel D replaces
fused_decode_attention_q8 (:399) and _tiled_decode_attention_q8 (:347),
int8 and int4, on the same body (csrc/decode_attention_q8.cu, the body in
csrc/decode_attention.cuh).

Semantics (decoder.py's stacked attention): query row x = m*G + g of
batch row b attends the source columns s with bias[b, x, s] == 0 (its own
modality, not padding); softmax in fp32.

What bounds them on the H100: the K/V stream, 2*B*H*hd*S elements per
layer per decode step (H=16, hd=64, S=637 at the flagship); one byte per
element (int8) or half a byte (int4) plus two fp32 scales per column for
D. Both cut S into chunks of CHUNK columns, one block per (b, h, chunk),
each block's partial softmax combined in chunk order by a second launch;
the number of chunks depends on S alone, so a row's output is the same
bits at any batch size (decode_attention_split_plain and
decode_attention_q8_split_plain compute the same routes in PyTorch). D
dequantises in registers as it loads. The JAX layout [B, H, hd, S] is
kept; see the sources' headers for the design and what is left for later
work.

Kernel F (tell_tpu_torch/csrc/decode_attention_single.cu, on the same
body) replaces the single-shot Pallas kernels of the JAX package's
measurement tools: tools/kernel_variants.py::fused_batched (pallas_call at
:51) and fused_q4split (:111), and the BB=1 inline fn of
tools/longctx_variants.py:52. It takes the exact softmax and rounds the
normalised probabilities to q's dtype before the PV product, over the same
CHUNK-column chunks: the chunks' scores go to an fp32 scratch, the global
max and sum come from per-chunk statistics in chunk order, and the
chunks' PV partials are summed in chunk order
(decode_attention_single_split_plain computes the same route in
PyTorch). `bb`, the variants' knob, must divide B and changes no bit. Its
plain versions are decode_attention_plain and decode_attention_q8_plain,
which compute the same functions.
"""
from __future__ import annotations

import collections

import torch

from .build import check_launch, load_library
from .dispatch import check_kernel_args, use_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 256                 # kernels A, D: source columns per block
HEAD_DIMS = (32, 64, 128)   # kernel A's head-dim instantiations
Q8_HEAD_DIMS = (32, 64)     # kernel D's
MAX_ROWS = 40               # kernels A, D: query rows MG, at most


def split_count(S: int) -> int:
    """Kernel A's and D's chunks over a source of S columns, ceil(S /
    CHUNK): set by S alone, never by B or H, so a row's output is the same
    at any batch."""
    return -(-S // CHUNK)


def _split_scratch(q: torch.Tensor, S: int) -> torch.Tensor | None:
    """The chunks' partials (acc [MG, hd], m, l) in fp32 for kernels A and
    D, where S takes more than one chunk; else None."""
    B, H, MG, hd = q.shape
    n_split = split_count(S)
    if n_split == 1:
        return None
    return torch.empty(B * H * n_split * MG * (hd + 2), dtype=torch.float32,
                       device=q.device)


def segment_bias(seg: torch.Tensor, pad: torch.Tensor, M: int, G: int
                 ) -> torch.Tensor:
    """Additive mask [B, MG, S]: 0 where query row m*G+g may attend source
    row s (seg[s]==m and not padded), -inf elsewhere.
    seg: [S] int modality ids; pad: [B, S] bool, True = padding."""
    modality = torch.arange(M, device=seg.device)
    seg_ok = seg[None, :] == modality[:, None]                      # [M,S]
    allowed = seg_ok[None] & ~pad[:, None, :]                       # [B,M,S]
    allowed = allowed.repeat_interleave(G, dim=1)                   # [B,MG,S]
    bias = torch.zeros(allowed.shape, dtype=torch.float32,
                       device=seg.device)
    return bias.masked_fill_(~allowed, float("-inf"))


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, with_probs: bool = False):
    """Plain PyTorch version (tell_tpu's reference_decode_attention):
    fp32 scores and softmax, probabilities cast to q's dtype before the
    value contraction, fp32 accumulation. with_probs also returns the fp32
    probabilities [B, H, MG, S] (the attention maps' route)."""
    scores = torch.einsum("bhxd,bhds->bhxs", q.float(), k.float())
    p = torch.softmax(scores + bias[:, None], dim=-1)
    out = torch.einsum("bhxs,bhds->bhxd", p.to(q.dtype).float(), v.float())
    return (out.to(q.dtype), p) if with_probs else out.to(q.dtype)


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, bias: torch.Tensor
                                 ) -> torch.Tensor:
    """Kernel A's function by kernel A's route, in PyTorch: per chunk of
    CHUNK columns the partial (m, l, acc) in fp32, the max starting at
    -1e30 (a chunk masked for a row gives l = 0, acc = 0 and weight 0),
    then the partials combined in chunk order. No path calls it; the tests
    hold it to tell_tpu's kernels."""
    return _split_route(q, k.float(), None, v.float(), None, bias)


def _split_route(q: torch.Tensor, kf: torch.Tensor, k_scale, vf: torch.Tensor,
                 v_scale, bias: torch.Tensor) -> torch.Tensor:
    """Kernels A's and D's route over fp32 K/V [B, H, hd, S]: per chunk of
    CHUNK columns the scores (times k_scale, if given, before the bias),
    m from -1e30, the raw exponentials summed into l and, times v_scale if
    given, contracted with V into acc; the partials combined in chunk
    order."""
    qf = q.float()
    parts = []
    for s0 in range(0, kf.shape[3], CHUNK):
        cols = slice(s0, s0 + CHUNK)
        sc = torch.einsum("bhxd,bhds->bhxs", qf, kf[..., cols])
        if k_scale is not None:
            sc = sc * k_scale[..., cols]
        sc = sc + bias[:, None, :, cols]
        m = sc.amax(-1).clamp_min(-1e30)
        p = torch.exp(sc - m[..., None])
        pw = p if v_scale is None else p * v_scale[..., cols]
        parts.append((m, p.sum(-1),
                      torch.einsum("bhxs,bhds->bhxd", pw, vf[..., cols])))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    num = den = 0.0
    for m, l, acc in parts:
        w = torch.exp(m - m_all)
        num = num + acc * w[..., None]
        den = den + l * w
    return (num / den[..., None]).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """q: [B, H, MG, hd]; k, v: [B, H, hd, S] (head-major, transposed);
    bias: [B, MG, S] fp32 additive mask. Returns [B, H, MG, hd].
    CUDA tensors launch kernel A (one call counted in
    decode_attention.launches, and by its query rows in .rows[MG]; its
    combine pass, launched where S > CHUNK, in .combine_launches); the
    kernel takes hd in HEAD_DIMS, 1 <= MG <=
    MAX_ROWS and S >= 1, and raises ValueError on other shapes. CPU
    tensors take decode_attention_plain."""
    if not use_kernel(q, k, v, bias):
        return decode_attention_plain(q, k, v, bias)
    B, H, MG, hd = q.shape
    S = k.shape[3]
    _check_fp_args("decode_attention", q, k, v, bias)
    if hd not in HEAD_DIMS or not 1 <= MG <= MAX_ROWS or S < 1:
        raise ValueError(f"decode_attention: the kernel takes hd in "
                         f"{HEAD_DIMS}, 1 <= MG <= {MAX_ROWS} and S >= 1, "
                         f"not hd={hd}, MG={MG}, S={S}")
    out = torch.empty_like(q)
    part = _split_scratch(q, S)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.tt_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(), B, H,
            MG, hd, S, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    check_launch(lib, "decode_attention", code)
    decode_attention.launches += 1
    decode_attention.rows[MG] += 1
    decode_attention.combine_launches += int(part is not None)
    decode_attention.max_columns = max(decode_attention.max_columns, S)
    return out


decode_attention.launches = 0
decode_attention.rows = collections.Counter()
decode_attention.combine_launches = 0
decode_attention.max_columns = 0   # the widest source S a launch attended


def _check_fp_args(name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, bias: torch.Tensor) -> None:
    """Shapes, dtypes and contiguity of kernels A and F over an fp cache."""
    B, H, MG, hd = q.shape
    S = k.shape[3]
    if k.shape != (B, H, hd, S) or v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if bias.shape != (B, MG, S):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} is not "
                         f"{(B, MG, S)}")
    check_kernel_args(name, {"q": q, "k": k, "v": v, "bias": bias},
                      {"q": tuple(_DTYPE_CODE), "k": (q.dtype,),
                       "v": (q.dtype,), "bias": (torch.float32,)})


def unpack_int4(x8: torch.Tensor, dtype: torch.dtype = torch.int8
                ) -> torch.Tensor:
    """Packed int4 [..., hd/2, S] -> `dtype` [..., hd, S] (tell_tpu's
    unpack_int4): byte d holds row d in its low nibble and row d + hd/2 in
    its high nibble, both two's complement in [-7, 7]. The shifts run in
    int32, which sign-extends the same way on every backend."""
    xi = x8.to(torch.int32)
    lo = (xi << 28) >> 28
    hi = (xi << 24) >> 28
    return torch.cat([lo, hi], dim=-2).to(dtype)


def decode_attention_q8_plain(q: torch.Tensor, k8: torch.Tensor,
                              k_scale: torch.Tensor, v8: torch.Tensor,
                              v_scale: torch.Tensor, bias: torch.Tensor,
                              with_probs: bool = False):
    """Plain PyTorch version (tell_tpu's reference_decode_attention_q8):
    the scales factor out of both contractions. fp32 scores times k_scale
    plus the bias, softmax, the normalised probabilities times v_scale cast
    to q's dtype before the value contraction, fp32 accumulation. Packed
    int4 K/V are unpacked first. with_probs also returns the softmax
    [B, H, MG, S] (before v_scale)."""
    if k8.shape[2] != q.shape[3]:
        k8, v8 = unpack_int4(k8), unpack_int4(v8)
    scores = torch.einsum("bhxd,bhds->bhxs", q.float(), k8.float())
    scores = scores * k_scale + bias[:, None]
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhxs,bhds->bhxd", (p * v_scale).to(q.dtype).float(),
                       v8.float())
    return (out.to(q.dtype), p) if with_probs else out.to(q.dtype)


def decode_attention_q8_split_plain(q: torch.Tensor, k8: torch.Tensor,
                                    k_scale: torch.Tensor, v8: torch.Tensor,
                                    v_scale: torch.Tensor, bias: torch.Tensor
                                    ) -> torch.Tensor:
    """Kernel D's function by kernel D's route, in PyTorch: K/V dequantised
    exactly (packed int4 unpacked), then per chunk of CHUNK columns the
    scores times k_scale plus the bias, the partial (m, l, acc) in fp32
    with m from -1e30, l the sum of the raw exponentials and acc their
    product times v_scale with V (the TPU's tiled q8 kernel), combined in
    chunk order. No path calls it; the tests hold it to tell_tpu's
    kernels."""
    if k8.shape[2] != q.shape[3]:
        k8, v8 = unpack_int4(k8), unpack_int4(v8)
    return _split_route(q, k8.float(), k_scale, v8.float(), v_scale, bias)


def decode_attention_q8(q: torch.Tensor, k8: torch.Tensor,
                        k_scale: torch.Tensor, v8: torch.Tensor,
                        v_scale: torch.Tensor, bias: torch.Tensor
                        ) -> torch.Tensor:
    """q: [B, H, MG, hd] fp32 or bf16; k8, v8: int8 [B, H, hd, S] or
    nibble-packed int4 [B, H, hd/2, S]; k_scale, v_scale: fp32 [B, H, 1, S];
    bias: [B, MG, S] fp32. Returns [B, H, MG, hd] in q's dtype.
    CUDA tensors launch kernel D (counted in decode_attention_q8.launches,
    by query rows in .rows[MG], the packed int4 form also in
    .int4_launches, its combine pass, launched
    where S > CHUNK, in .combine_launches); the kernel takes hd in
    Q8_HEAD_DIMS, 1 <= MG <= MAX_ROWS and S >= 1, and raises ValueError on
    other shapes. CPU tensors take decode_attention_q8_plain."""
    if not use_kernel(q, k8, k_scale, v8, v_scale, bias):
        return decode_attention_q8_plain(q, k8, k_scale, v8, v_scale, bias)
    B, H, MG, hd = q.shape
    S = k8.shape[3]
    packed4 = _check_q8_args("decode_attention_q8", q, k8, k_scale, v8,
                             v_scale, bias)
    if hd not in Q8_HEAD_DIMS or not 1 <= MG <= MAX_ROWS or S < 1:
        raise ValueError(f"decode_attention_q8: the kernel takes hd in "
                         f"{Q8_HEAD_DIMS}, 1 <= MG <= {MAX_ROWS} and S >= 1, "
                         f"not hd={hd}, MG={MG}, S={S}")
    out = torch.empty_like(q)
    part = _split_scratch(q, S)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.tt_decode_attention_q8(
            q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
            v_scale.data_ptr(), bias.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(), B, H,
            MG, hd, S, int(packed4), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    check_launch(lib, "decode_attention_q8", code)
    decode_attention_q8.launches += 1
    decode_attention_q8.rows[MG] += 1
    decode_attention_q8.int4_launches += int(packed4)
    decode_attention_q8.combine_launches += int(part is not None)
    return out


decode_attention_q8.launches = 0
decode_attention_q8.rows = collections.Counter()
decode_attention_q8.int4_launches = 0
decode_attention_q8.combine_launches = 0


def _check_q8_args(name: str, q: torch.Tensor, k8: torch.Tensor,
                   k_scale: torch.Tensor, v8: torch.Tensor,
                   v_scale: torch.Tensor, bias: torch.Tensor) -> bool:
    """Shapes, dtypes and contiguity of kernels D and F over a quantised
    cache; returns True for packed int4 K/V, False for int8."""
    B, H, MG, hd = q.shape
    hd_store, S = k8.shape[2], k8.shape[3]
    packed4 = hd_store != hd
    if packed4 and 2 * hd_store != hd:
        raise ValueError(f"{name}: k8 holds {hd_store} rows, neither hd={hd} "
                         "(int8) nor hd/2 (packed int4)")
    if k8.shape != (B, H, hd_store, S) or v8.shape != k8.shape:
        raise ValueError(f"{name}: k8 {tuple(k8.shape)} / v8 "
                         f"{tuple(v8.shape)} do not match q {tuple(q.shape)}")
    for arg, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.shape != (B, H, 1, S):
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} is not "
                             f"{(B, H, 1, S)}")
    if bias.shape != (B, MG, S):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} is not "
                         f"{(B, MG, S)}")
    f32 = (torch.float32,)
    check_kernel_args(name, {"q": q, "k8": k8, "k_scale": k_scale, "v8": v8,
                             "v_scale": v_scale, "bias": bias},
                      {"q": tuple(_DTYPE_CODE), "k8": (torch.int8,),
                       "v8": (torch.int8,), "k_scale": f32, "v_scale": f32,
                       "bias": f32})
    return packed4


# ---------------------------------------------------------------------------
# kernel F: single-shot decode attention
# ---------------------------------------------------------------------------

SINGLE_HEAD_DIMS = (64,)    # kernel F's head-dim instantiation


def decode_attention_single_split_plain(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor, bias: torch.Tensor
                                        ) -> torch.Tensor:
    """Kernel F's function by kernel F's route, in PyTorch: per chunk of
    CHUNK columns the fp32 scores and their (max from -1e30, sum of exp);
    the global max m and sum l from those in chunk order; then per chunk p
    = exp(s - m) / l rounded to q's dtype and its fp32 product with V, the
    chunks' products summed in chunk order. Packed int4 K/V (k [B, H,
    hd/2, S]) are not taken here: decode_attention_q4split_split_plain. No
    path calls it; the tests hold it to tell_tpu's kernels."""
    return _single_route(q, k.float(), None, v.float(), None, bias)


def decode_attention_q4split_split_plain(q: torch.Tensor, k4: torch.Tensor,
                                         k_scale: torch.Tensor,
                                         v4: torch.Tensor,
                                         v_scale: torch.Tensor,
                                         bias: torch.Tensor) -> torch.Tensor:
    """Kernel F's int4-split form by its route, in PyTorch: the nibbles
    unpacked exactly, the scores times k_scale before the bias, and p
    times v_scale before the rounding; otherwise
    decode_attention_single_split_plain."""
    return _single_route(q, unpack_int4(k4).float(), k_scale,
                         unpack_int4(v4).float(), v_scale, bias)


def _single_route(q: torch.Tensor, kf: torch.Tensor, k_scale,
                  vf: torch.Tensor, v_scale, bias: torch.Tensor
                  ) -> torch.Tensor:
    qf = q.float()
    cols = [slice(s0, s0 + CHUNK) for s0 in range(0, kf.shape[3], CHUNK)]
    scores, stats = [], []
    for c in cols:
        sc = torch.einsum("bhxd,bhds->bhxs", qf, kf[..., c])
        if k_scale is not None:
            sc = sc * k_scale[..., c]
        sc = sc + bias[:, None, :, c]
        m = sc.amax(-1).clamp_min(-1e30)
        scores.append(sc)
        stats.append((m, torch.exp(sc - m[..., None]).sum(-1)))
    m_all = torch.stack([m for m, _ in stats]).amax(0)
    l_all = 0.0
    for m, l in stats:
        l_all = l_all + l * torch.exp(m - m_all)
    out = 0.0
    for c, sc in zip(cols, scores):
        p = torch.exp(sc - m_all[..., None]) / l_all[..., None]
        if v_scale is not None:
            p = p * v_scale[..., c]
        out = out + torch.einsum("bhxs,bhds->bhxd", p.to(q.dtype).float(),
                                 vf[..., c])
    return out.to(q.dtype)


def _check_bb(name: str, B: int, bb: int) -> None:
    """Kernel F's bb, checked on every device so that a CPU run follows
    the card's rule: it must divide B (the TPU grid is B // BB steps)."""
    if bb < 1 or B % bb:
        raise ValueError(f"{name}: B={B} is not a multiple of bb={bb}")


def _launch_single(name: str, entry: str, q: torch.Tensor, kv_args: list,
                   bias: torch.Tensor, S: int) -> torch.Tensor:
    """Kernel F's scratch and launch: stats (m, l) pairs [B, H, MG,
    n_split], scores [B, H, MG, S] and, where S takes more than one chunk,
    the partials [B, H, n_split, MG, hd], all fp32, carved from one
    allocation (the pairs first, so they sit on 8-byte boundaries)."""
    B, H, MG, hd = q.shape
    if hd not in SINGLE_HEAD_DIMS or not 1 <= MG <= MAX_ROWS or S < 1:
        raise ValueError(f"{name}: the kernel takes hd in {SINGLE_HEAD_DIMS}"
                         f", 1 <= MG <= {MAX_ROWS} and S >= 1, not hd={hd}, "
                         f"MG={MG}, S={S}")
    n_split = split_count(S)
    rows = B * H * MG
    n_part = rows * n_split * hd if n_split > 1 else 0
    scratch = torch.empty(rows * (2 * n_split + S) + n_part,
                          dtype=torch.float32, device=q.device)
    base = scratch.data_ptr()
    stats, scores = base, base + 4 * rows * 2 * n_split
    part = scores + 4 * rows * S if n_part else None
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(
            q.data_ptr(), *(t.data_ptr() for t in kv_args), bias.data_ptr(),
            scores, stats, part, out.data_ptr(), B, H, MG, hd, S,
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    check_launch(lib, name, code)
    return out


def decode_attention_single(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor,
                            bb: int = 1) -> torch.Tensor:
    """Single-shot decode attention, kernel A's function with p normalised
    before it is rounded (q [B, H, MG, hd]; k, v [B, H, hd, S]; bias [B,
    MG, S] fp32). bb, the batch rows a TPU grid step takes, must divide B
    (ValueError otherwise) and changes no bit of the result. CUDA tensors
    launch kernel F (counted in decode_attention_single.launches); the
    kernel takes hd in SINGLE_HEAD_DIMS, 1 <= MG <= MAX_ROWS and any S >=
    1, and raises ValueError on other shapes. CPU tensors take
    decode_attention_plain, which computes the same function."""
    _check_bb("decode_attention_single", q.shape[0], bb)
    if not use_kernel(q, k, v, bias):
        return decode_attention_plain(q, k, v, bias)
    _check_fp_args("decode_attention_single", q, k, v, bias)
    out = _launch_single("decode_attention_single",
                         "tt_decode_attention_single", q, [k, v], bias,
                         k.shape[3])
    decode_attention_single.launches += 1
    return out


decode_attention_single.launches = 0


def decode_attention_q4split(q: torch.Tensor, k4: torch.Tensor,
                             k_scale: torch.Tensor, v4: torch.Tensor,
                             v_scale: torch.Tensor, bias: torch.Tensor,
                             bb: int = 1) -> torch.Tensor:
    """Single-shot decode attention over a nibble-packed int4 cache (k4, v4
    int8 [B, H, hd/2, S]; k_scale, v_scale fp32 [B, H, 1, S]), each nibble
    half contracted against its half of q; bb and the shapes as
    decode_attention_single. CUDA tensors launch kernel F's int4-split
    form (counted in decode_attention_q4split.launches); CPU tensors take
    decode_attention_q8_plain, which computes the same function."""
    hd = q.shape[3]
    if 2 * k4.shape[2] != hd:
        raise ValueError(f"decode_attention_q4split: k4 holds {k4.shape[2]} "
                         f"rows, not hd/2 = {hd / 2} (packed int4)")
    _check_bb("decode_attention_q4split", q.shape[0], bb)
    if not use_kernel(q, k4, k_scale, v4, v_scale, bias):
        return decode_attention_q8_plain(q, k4, k_scale, v4, v_scale, bias)
    _check_q8_args("decode_attention_q4split", q, k4, k_scale, v4, v_scale,
                   bias)
    out = _launch_single("decode_attention_q4split",
                         "tt_decode_attention_q4split", q,
                         [k4, k_scale, v4, v_scale], bias, k4.shape[3])
    decode_attention_q4split.launches += 1
    return out


decode_attention_q4split.launches = 0
