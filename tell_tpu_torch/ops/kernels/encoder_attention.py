"""Kernel B: flash-style self-attention for the RoBERTa article encoder.

Replaces the library Pallas kernel jax.experimental.pallas.ops.tpu.
flash_attention that tell_tpu/models/backbones/roberta.py::roberta_encode
calls at S >= 512 (call at :219, gate _flash_ok at :111), at every bucket
width, with tell_tpu_torch/csrc/encoder_attention.cu.

Padding follows the einsum path of roberta_encode (:206, :227-232), the CPU
reference: pad keys get an additive -1e9, so every query row, pad rows
included, matches it. (The TPU flash path let pads attend only pads.)

What bounds it on the H100: arithmetic, 4*S*S*hd FLOPs per (b, h), so it
runs on the tensor cores (mma.sync: bf16 in bf16, 3xTF32 in fp32, which
keeps fp32's accuracy). The kernel streams 64-key K/V tiles through a
two-stage cp.async ring with an fp32 online softmax, so the S x S scores
never reach device memory, and skips the tiles that hold only pad keys
(exact: such a tile adds 0). encoder_attention_tiled models that schedule
in plain PyTorch for the tests. See the source's header for the design.
"""
from __future__ import annotations

import torch

from .build import check_launch, load_library
from .dispatch import check_kernel_args, use_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)  # RoBERTa-large and -base; the kernel is built for it
TILE = 64           # keys per tile, as the kernel walks them


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, key_pad: torch.Tensor
                            ) -> torch.Tensor:
    """Plain PyTorch version: roberta_encode's einsum attention with the
    -1e9 key-padding mask, fp32 scores and softmax, probabilities cast to
    q's dtype before the value contraction."""
    hd = q.shape[-1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    neg = torch.zeros(key_pad.shape, dtype=torch.float32,
                      device=key_pad.device).masked_fill_(key_pad, -1e9)
    scores = scores * (hd ** -0.5) + neg[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
    return out.to(q.dtype)


def kept_tiles(key_pad: torch.Tensor) -> torch.Tensor:
    """[B, ceil(S/TILE)] bool: the key tiles the kernel walks. A tile is
    kept where it holds a real key; a row of pads only keeps every tile."""
    B, S = key_pad.shape
    nt = -(-S // TILE)
    real = torch.nn.functional.pad(~key_pad, (0, nt * TILE - S))
    kept = real.reshape(B, nt, TILE).any(-1)
    return kept | ~kept.any(-1, keepdim=True)


def encoder_attention_tiled(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, key_pad: torch.Tensor,
                            skip: bool = True) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch, for the tests: TILE-key
    tiles in order, an online softmax with the running max from -1e30,
    the unnormalised probabilities rounded to q's dtype before the value
    contraction, and (skip) the tiles kept_tiles drops left out."""
    B, S, H, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    neg = torch.zeros(key_pad.shape, dtype=torch.float32,
                      device=key_pad.device).masked_fill_(key_pad, -1e9)
    kept = kept_tiles(key_pad) if skip else None
    m = torch.full((B, H, S), -1e30, device=q.device)
    l = torch.zeros(B, H, S, device=q.device)
    o = torch.zeros(B, H, S, hd, device=q.device)
    for j in range(-(-S // TILE)):
        cols = slice(j * TILE, min(S, (j + 1) * TILE))
        s = (torch.einsum("bthd,bshd->bhts", qf, kf[:, cols]) * hd ** -0.5
             + neg[:, None, None, cols])
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        pv = torch.einsum("bhts,bshd->bhtd", p.to(q.dtype).float(),
                          vf[:, cols])
        l_new = l * alpha + p.sum(-1)
        o_new = o * alpha[..., None] + pv
        if kept is None:
            m, l, o = m_new, l_new, o_new
        else:
            keep = kept[:, j, None, None]
            m = torch.where(keep, m_new, m)
            l = torch.where(keep, l_new, l)
            o = torch.where(keep[..., None], o_new, o)
    return (o / l[..., None]).transpose(1, 2).to(q.dtype)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_pad: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, S, H, hd]; key_pad: [B, S] bool, True = pad.
    Returns [B, S, H, hd]. CUDA tensors launch kernel B (counted in
    encoder_attention.launches; .sequences adds the B sequences, e.g.
    article windows, of each launch); CPU tensors take
    encoder_attention_plain."""
    if not use_kernel(q, k, v, key_pad):
        return encoder_attention_plain(q, k, v, key_pad)
    B, S, H, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"encoder_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} differ")
    if key_pad.shape != (B, S):
        raise ValueError(f"encoder_attention: key_pad "
                         f"{tuple(key_pad.shape)} is not {(B, S)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"encoder_attention: head dim {hd} not in "
                         f"{_HEAD_DIMS}")
    check_kernel_args("encoder_attention",
                      {"q": q, "k": k, "v": v, "key_pad": key_pad},
                      {"q": tuple(_DTYPE_CODE), "k": (q.dtype,),
                       "v": (q.dtype,), "key_pad": (torch.bool,)})
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"encoder_attention: {name} is not 16-byte "
                             "aligned (the kernel loads 16-byte rows)")
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.tt_encoder_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_pad.data_ptr(),
            out.data_ptr(), B, S, H, hd, hd ** -0.5, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    check_launch(lib, "encoder_attention", code)
    encoder_attention.launches += 1
    encoder_attention.sequences += B
    return out


encoder_attention.launches = 0
encoder_attention.sequences = 0
