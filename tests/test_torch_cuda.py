"""Kernels A-E on the card against their plain versions, at edge shapes
the main paths do not reach (S below and across one tile, single query
rows, other head dims for kernel A; for A also S at and across its
256-column chunks, rows open in one chunk only, B=1 against B=8 bit for
bit, and the shapes it refuses; T=1, T<K, T across a time tile and a
ragged last tile, 8 and 16 heads, no softmax, T < K at the training
batch (16-row tiles), two heads a block with 8 and 32 logit columns, a
ragged last 128-byte slot of C, and C / H not a multiple of 8, an
unaligned x and K > 32 refused for kernel C; S=1 segments, a
ragged last tile, an all-padded article, int4 against int8 and bf16, S at
and across its 256-column chunks, rows open in one chunk only, B=1
against B=8 bit for bit and the shapes it refuses for kernel D; V below
and across one chunk, k=1 and 8, equal logits, N=1, rows launched among 5,
17, 40 and 640 equal bit for bit, D not a multiple of 8 and an unaligned
x refused for kernel E; key pads on the right, on the left and in the middle with
whole pad tiles, an all-pad row, S = 1, 63, 130, 256 and 512, and each
sequence alone equal to its row of B=4 bit for bit for kernel B),
kernels A and D repeating bit for bit over 200 launches, A at the
sibling configurations' rows (MG = 1, 2, 3, 5, 10, 15 at S = 514, 565,
571; a batch row at B=1 bit for bit) and D at MG = 5 and 15 (S=571),
kernel C's gradient through its autograd Function, kernel F (single-shot
decode attention) at bb 1/2/4, MG 4 and 20, S 637, 2173 and a ragged S,
a row masked but for one column, its int4-split form and a 200-launch
repeat probe, S at and across its 256-column chunks up to 4096 against
the plain versions and F's route, bb = 1, 2, 4 and a batch row alone
equal bit for bit (fp and int4-split), and the inputs the wrappers must
refuse (F: B not a multiple of bb, hd other than 64; B: an input not
16-byte aligned). Marked `cuda`: each test skips without a GPU.

This file imports no JAX, so it also runs where JAX is absent (the card's
machine; tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: A, B and F fp32 atol 1e-5, rtol 1e-4 (online vs two-pass
softmax, other summation order); C fp32 atol = rtol = 2e-5 (the JAX kernel
test's), C gradients 1e-4; D as A; E 1e-5 on values and lse (the same
fp32 products summed in another order), ids equal; bf16 inputs: 2e-2
absolute against the plain version in fp32 on the same bf16-rounded inputs
(for C without softmax, 2e-2 of the output's largest magnitude: the raw
tap logits are not normalised, and bf16 output rounding is relative).
"""
import pytest
import torch

from tell_tpu_torch.ops.kernels.decode_attention import (
    MAX_ROWS, decode_attention, decode_attention_plain,
    Q8_HEAD_DIMS, decode_attention_q4split, decode_attention_q8,
    decode_attention_q4split_split_plain, decode_attention_q8_plain,
    decode_attention_q8_split_plain, decode_attention_single,
    decode_attention_single_split_plain, decode_attention_split_plain,
    segment_bias, split_count)
from tell_tpu_torch.ops.kernels.dynamic_conv import (
    dynamic_conv_plain, fused_dynamic_conv)
from tell_tpu_torch.ops.kernels.encoder_attention import (
    encoder_attention, encoder_attention_plain)
from tell_tpu_torch.ops.kernels.topk_logits import (topk_logits,
                                                    topk_logits_plain,
                                                    topk_logits_tiled)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _decode_inputs(gen, B, H, M, G, S, hd, dtype):
    q = torch.randn(B, H, M * G, hd, generator=gen, device="cuda") * hd ** -0.5
    k = torch.randn(B, H, hd, S, generator=gen, device="cuda")
    v = torch.randn(B, H, hd, S, generator=gen, device="cuda")
    seg = torch.sort(torch.randint(0, M, (S,), generator=gen,
                                   device="cuda")).values
    seg[:M] = torch.arange(M, device="cuda")
    seg = torch.sort(seg).values
    pad = torch.rand(B, S, generator=gen, device="cuda") < 0.3
    first = torch.searchsorted(seg, torch.arange(M, device="cuda"))
    pad[:, first] = False                  # every modality keeps a column
    return [t.to(dtype) for t in (q, k, v)] + [segment_bias(seg, pad, M, G)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,M,G,S,hd", [
    (1, 1, 1, 1, 5, 64),        # S below one tile, one query row
    (3, 2, 4, 5, 64, 64),       # exactly one tile
    (2, 16, 4, 5, 65, 64),      # one column past a tile
    (2, 4, 3, 11, 300, 32),     # MG=33: more rows than warps, other hd
    (1, 2, 2, 1, 1000, 128),    # wide head
])
def test_decode_attention_kernel_matches_plain(gen, B, H, M, G, S, hd,
                                               dtype):
    q, k, v, bias = _decode_inputs(gen, B, H, M, G, S, hd, dtype)
    launches = decode_attention.launches
    out = decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert decode_attention.launches == launches + 1
    ref = decode_attention_plain(q.float(), k.float(), v.float(), bias)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    else:
        assert out.dtype == torch.bfloat16
        assert (out.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,G,S", [
    (1, 1, 514), (1, 5, 514),   # no image: greedy, beam 5
    (2, 1, 565), (2, 5, 565),   # flattened
    (3, 1, 571), (3, 5, 571),   # faces
])
def test_decode_attention_at_sibling_rows(gen, M, G, S, dtype):
    """The siblings' decode shapes (MG = 1, 2, 3, 5, 10, 15: partial row
    tiles and PV passes) against plain, and a batch row at B=1 equal to
    its row of B=8 bit for bit."""
    q, k, v, bias = _decode_inputs(gen, 8, 16, M, G, S, 64, dtype)
    out = decode_attention(q, k, v, bias)
    ref = decode_attention_plain(q.float(), k.float(), v.float(), bias)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    else:
        assert (out.float() - ref).abs().max().item() <= 2e-2
    one = decode_attention(*(t[5:6].contiguous() for t in (q, k, v, bias)))
    assert torch.equal(one, out[5:6])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [256, 257, 512, 513, 2173])
def test_decode_attention_chunk_boundaries(gen, S, dtype):
    """S at and one column past kernel A's chunks, and the long article's
    source (9 chunks): against the plain version and the chunked route;
    one combine launch where S > 256."""
    q, k, v, bias = _decode_inputs(gen, 2, 4, 4, 5, S, 64, dtype)
    combines = decode_attention.combine_launches
    out = decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert decode_attention.combine_launches == combines + (S > 256)
    args = (q.float(), k.float(), v.float(), bias)
    for ref in (decode_attention_plain(*args),
                decode_attention_split_plain(*args)):
        _check_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_rows_open_in_one_chunk(gen, dtype):
    """S=637 (chunks of 256, 256, 125): row 0 open in one column of the
    last chunk only (its output is that column of V), row 1 in the middle
    chunk only, the rest as the segment bias gives them. Every other
    chunk's weight must be exactly 0."""
    B, H, MG, S = 2, 4, 20, 637
    q, k, v, bias = _decode_inputs(gen, B, H, 4, 5, S, 64, dtype)
    bias[:, :2] = float("-inf")
    bias[:, 0, S - 3] = 0.0
    bias[:, 1, 300:400] = 0.0
    out = decode_attention(q, k, v, bias)
    ref = decode_attention_plain(q.float(), k.float(), v.float(), bias)
    _check_close(out, ref, dtype)
    torch.testing.assert_close(out[:, :, 0], v[..., S - 3], atol=0, rtol=0)


def test_decode_attention_row_equals_itself_at_batch_one(gen):
    """A (b, h) row's output does not depend on the batch: B=1 on row b
    gives the B=8 launch's row b bit for bit (the chunk count depends on S
    alone), at S across one and several chunks, fp32 and bf16."""
    for S in (200, 637, 2173):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = _decode_inputs(gen, 8, 16, 4, 5, S, 64, dtype)
            full = decode_attention(q, k, v, bias)
            for b in (0, 5):
                one = decode_attention(*(t[b:b + 1].contiguous()
                                         for t in (q, k, v, bias)))
                assert torch.equal(one[0], full[b]), (S, dtype, b)
    assert split_count(2173) == 9 and split_count(256) == 1


def test_decode_attention_refuses_shapes_it_has_no_kernel_for(gen):
    launches = decode_attention.launches
    q, k, v, bias = _decode_inputs(gen, 1, 2, 1, 1, 40, 48, torch.float32)
    with pytest.raises(ValueError, match="hd=48"):
        decode_attention(q, k, v, bias)
    rows = MAX_ROWS + 1
    q, k, v, bias = _decode_inputs(gen, 1, 2, 1, rows, 40, 64, torch.float32)
    with pytest.raises(ValueError, match=f"MG={rows}"):
        decode_attention(q, k, v, bias)
    q, k, v, bias = _decode_inputs(gen, 1, 2, 1, MAX_ROWS, 40, 64,
                                   torch.float32)
    _check_close(decode_attention(q, k, v, bias),
                 decode_attention_plain(q, k, v, bias), torch.float32)
    assert decode_attention.launches == launches + 1


def _encoder_key_pad(gen, B, S, padding):
    """Random 30% pads; row 0 padded on the right, on the left or in the
    middle (keys 5..S-3, so at S >= 130 whole 64-key pad tiles lie
    between real ones); the last row all pads."""
    key_pad = torch.rand(B, S, generator=gen, device="cuda") < 0.3
    row = torch.zeros(S, dtype=torch.bool, device="cuda")
    if padding == "right":
        row[max(1, S // 3):] = True
    elif padding == "left":
        row[:S - max(1, S // 3)] = True
    else:
        row[5:S - 2] = True
    key_pad[0] = row
    key_pad[-1] = True                     # an all-pad row
    return key_pad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padding", ["right", "left", "middle"])
@pytest.mark.parametrize("B,S,H,hd", [
    (2, 1, 1, 64), (2, 63, 3, 64), (3, 130, 2, 64), (2, 256, 16, 64),
    (2, 512, 4, 64)])
def test_encoder_attention_kernel_matches_plain(gen, B, S, H, hd, padding,
                                                dtype):
    q, k, v = (torch.randn(B, S, H, hd, generator=gen, device="cuda")
               for _ in range(3))
    key_pad = _encoder_key_pad(gen, B, S, padding)
    launches = encoder_attention.launches
    q, k, v = (t.to(dtype) for t in (q, k, v))
    out = encoder_attention(q, k, v, key_pad)
    torch.cuda.synchronize()
    assert encoder_attention.launches == launches + 1
    ref = encoder_attention_plain(q.float(), k.float(), v.float(), key_pad)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    else:
        assert (out.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [130, 512])
def test_encoder_attention_row_alone_equals_batch(gen, S, dtype):
    """Each sequence launched alone (B=1) equals its row of B=4 bit for
    bit: a block reads only its own (b, h) and walks its kept tiles in
    order, whatever the grid."""
    q, k, v = (torch.randn(4, S, 16, 64, generator=gen,
                           device="cuda").to(dtype) for _ in range(3))
    key_pad = _encoder_key_pad(gen, 4, S, "middle")
    full = encoder_attention(q, k, v, key_pad)
    for r in range(4):
        one = encoder_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                key_pad[r:r + 1])
        assert torch.equal(one, full[r:r + 1])


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q, k, v, bias = _decode_inputs(gen, 2, 2, 2, 1, 40, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         v, bias)
    with pytest.raises(TypeError, match="dtype"):
        decode_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(TypeError, match="dtype"):
        decode_attention(q, k.to(torch.bfloat16), v, bias)
    with pytest.raises(ValueError, match="bias"):
        decode_attention(q, k, v, bias[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="different devices"):
        decode_attention(q, k, v, bias.cpu())
    x = torch.randn(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        encoder_attention(x, x, x, torch.zeros(1, 8, dtype=torch.bool,
                                               device="cuda"))
    x = torch.randn(1, 8, 2, 64, device="cuda")
    with pytest.raises(TypeError, match="key_pad"):
        encoder_attention(x, x, x, torch.zeros(1, 8, device="cuda"))
    x = torch.randn(1 * 8 * 2 * 64 + 1, device="cuda")[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        encoder_attention(x, x, x, torch.zeros(1, 8, dtype=torch.bool,
                                               device="cuda"))


def _conv_inputs(gen, B, T, C, H, K):
    x = torch.randn(B, T, C, generator=gen, device="cuda")
    bound = (6.0 / (C + K * H)) ** 0.5
    w_km = (torch.rand(C, K * H, generator=gen, device="cuda") * 2 - 1) * bound
    return x, w_km


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,H,K,sm", [
    (2, 1, 128, 4, 3, True),          # one row
    (2, 15, 1024, 16, 31, True),      # T < K: a 16-token caption, K=31
    (3, 33, 256, 8, 31, True),        # one row past a 32-row time tile
    (2, 70, 1024, 16, 7, True),       # ragged last tile
    (1, 40, 512, 8, 15, False),       # raw tap logits
    (16, 15, 1024, 16, 31, True),     # T < K at the training batch: TT=16
    (16, 5, 1024, 16, 7, True),       # T < K, K=7
    (32, 32, 1024, 16, 3, True),      # 2 heads a block, 8 columns, 4 warps
    (32, 32, 1024, 16, 15, False),    # 2 heads, 32 columns, raw logits
    (3, 20, 136, 17, 5, True),        # C past a 128-byte slot (ragged)
])
def test_dynamic_conv_kernel_matches_plain(gen, B, T, C, H, K, sm, dtype):
    x, w_km = _conv_inputs(gen, B, T, C, H, K)
    x, w_km = x.to(dtype), w_km.to(dtype)
    launches = fused_dynamic_conv.launches
    out = fused_dynamic_conv(x, w_km, K, H, sm)
    torch.cuda.synchronize()
    assert fused_dynamic_conv.launches == launches + 1
    assert out.dtype == dtype and out.shape == x.shape
    ref = dynamic_conv_plain(x.float(), w_km.float(), K, H, sm)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    else:
        scale = 1.0 if sm else max(1.0, ref.abs().max().item())
        assert (out.float() - ref).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("sm", [True, False])
def test_dynamic_conv_gradient_through_function(gen, sm):
    x, w_km = _conv_inputs(gen, 2, 40, 256, 8, 31)
    g = torch.randn(x.shape, generator=gen, device="cuda")
    xk, wk = x.clone().requires_grad_(), w_km.clone().requires_grad_()
    (fused_dynamic_conv(xk, wk, 31, 8, sm) * g).sum().backward()
    xr, wr = x.clone().requires_grad_(), w_km.clone().requires_grad_()
    (dynamic_conv_plain(xr, wr, 31, 8, sm) * g).sum().backward()
    torch.testing.assert_close(xk.grad, xr.grad, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(wk.grad, wr.grad, atol=1e-4, rtol=1e-4)


def test_dynamic_conv_refuses_what_the_kernel_does_not_take(gen):
    x, w_km = _conv_inputs(gen, 2, 8, 64, 4, 3)
    with pytest.raises(TypeError, match="dtype"):
        fused_dynamic_conv(x.half(), w_km.half(), 3, 4)
    with pytest.raises(TypeError, match="w_km"):
        fused_dynamic_conv(x, w_km.to(torch.bfloat16), 3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dynamic_conv(x.transpose(0, 1).contiguous().transpose(0, 1),
                           w_km, 3, 4)
    with pytest.raises(ValueError, match="multiple of num_heads"):
        fused_dynamic_conv(torch.randn(2, 8, 66, device="cuda"),
                           torch.randn(66, 12, device="cuda"), 3, 4)
    with pytest.raises(ValueError, match="w_km"):
        fused_dynamic_conv(x, w_km[:, :-1].contiguous(), 3, 4)
    with pytest.raises(ValueError, match="kernel_size 33"):
        fused_dynamic_conv(x, torch.randn(64, 33 * 4, device="cuda"), 33, 4)
    with pytest.raises(ValueError, match="16-byte"):       # C / H = 9
        fused_dynamic_conv(torch.randn(2, 8, 36, device="cuda"),
                           torch.randn(36, 12, device="cuda"), 3, 4)
    xu = torch.randn(2 * 8 * 64 + 1, device="cuda")[1:].view(2, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):       # unaligned x
        fused_dynamic_conv(xu, w_km, 3, 4)


def _q8_inputs(gen, B, H, M, G, S, hd, dtype, packed4=False, seg=None,
               pad=None):
    """Kernel D inputs: random int8 (or packed int4 bytes) K/V with positive
    per-column scales and a segment bias."""
    lim = 8 if packed4 else 128
    rows = hd // 2 if packed4 else hd
    q = torch.randn(B, H, M * G, hd, generator=gen, device="cuda") * hd ** -0.5
    k8, v8 = (torch.randint(-lim, lim, (B, H, rows, S), generator=gen,
                            device="cuda").to(torch.int8) for _ in range(2))
    if packed4:   # two nibbles in [-7, 7] per byte
        k8, v8 = (_pack4(torch.randint(-7, 8, (B, H, hd, S), generator=gen,
                                       device="cuda")) for _ in range(2))
    ks, vs = (torch.rand(B, H, 1, S, generator=gen, device="cuda") * 0.05
              + 1e-3 for _ in range(2))
    if seg is None:
        seg = torch.sort(torch.randint(0, M, (S,), generator=gen,
                                       device="cuda")).values
    if pad is None:
        pad = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    return [q.to(dtype), k8, ks, v8, vs, segment_bias(seg, pad, M, G)]


def _pack4(vals):
    """int values in [-7, 7] [B, H, hd, S] -> packed bytes [B, H, hd/2, S]
    (row d in the low nibble, row d + hd/2 in the high one)."""
    hd = vals.shape[2]
    lo = vals[:, :, :hd // 2].to(torch.int32) & 0x0F
    hi = (vals[:, :, hd // 2:].to(torch.int32) << 4) & 0xFF
    b = lo | hi
    return torch.where(b > 127, b - 256, b).to(torch.int8)


def _check_q8(args, dtype):
    launches = decode_attention_q8.launches
    out = decode_attention_q8(*args)
    torch.cuda.synchronize()
    assert decode_attention_q8.launches == launches + 1
    assert out.dtype == dtype and torch.isfinite(out).all()
    ref = decode_attention_q8_plain(args[0].float(), *args[1:])
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    else:
        assert (out.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("B,H,M,G,S,hd", [
    (1, 1, 1, 1, 1, 64),        # one column
    (2, 4, 4, 5, 65, 64),       # one column past a tile
    (2, 16, 4, 5, 637, 64),     # the flagship's source, ragged last tile
    (1, 2, 3, 2, 300, 32),      # other hd
    (2, 16, 1, 5, 571, 64),     # MG=5 over the faces sibling's source
    (2, 16, 3, 5, 571, 64),     # MG=15: the faces sibling's int8 engine
])
def test_decode_attention_q8_kernel_matches_plain(gen, B, H, M, G, S, hd,
                                                  packed4, dtype):
    _check_q8(_q8_inputs(gen, B, H, M, G, S, hd, dtype, packed4), dtype)


def test_decode_attention_q8_single_column_segments_and_padded_article(gen):
    """Segments of one column each beside a 62-column article whose rows
    are all padding: that modality keeps only its bias column."""
    M, S = 4, 65
    seg = torch.tensor([0, 1] + [2] * 62 + [3], device="cuda")
    pad = torch.zeros(2, S, dtype=torch.bool, device="cuda")
    pad[:, 2:63] = True                       # column 63 plays the bias one
    for packed4 in (False, True):
        _check_q8(_q8_inputs(gen, 2, 4, M, 5, S, 64, torch.float32, packed4,
                             seg=seg, pad=pad), torch.float32)


def test_decode_attention_int4_equals_int8_on_nibble_values(gen):
    """Values in [-7, 7] stored as int8 and as packed int4 give the same
    output: the nibble unpack is exact."""
    B, H, M, G, S, hd = 2, 4, 4, 5, 200, 64
    q, _, ks, _, vs, bias = _q8_inputs(gen, B, H, M, G, S, hd, torch.float32)
    kv = [torch.randint(-7, 8, (B, H, hd, S), generator=gen, device="cuda")
          for _ in range(2)]
    out8 = decode_attention_q8(q, kv[0].to(torch.int8), ks,
                               kv[1].to(torch.int8), vs, bias)
    out4 = decode_attention_q8(q, _pack4(kv[0]), ks, _pack4(kv[1]), vs, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(out4, out8, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kv", ["fp", "int8", "int4"])
def test_decode_attention_repeats_bit_for_bit(gen, kv):
    """Kernels A (fp) and D at the greedy path's shape (B=8, H=16, MG=4,
    S=637): 200 launches on one input, each after a launch on another
    input, all equal the first output bit for bit, which holds the plain
    version's value. A race between the block's phases would show as
    outputs that change from launch to launch."""
    B, H, M, G, S, hd = 8, 16, 4, 1, 637, 64
    if kv == "fp":
        fn, plain = decode_attention, decode_attention_plain
        a, b = (_decode_inputs(gen, B, H, M, G, S, hd, torch.float32)
                for _ in range(2))
    else:
        fn, plain = decode_attention_q8, decode_attention_q8_plain
        a, b = (_q8_inputs(gen, B, H, M, G, S, hd, torch.float32,
                           packed4=kv == "int4") for _ in range(2))
    first = fn(*a)
    torch.testing.assert_close(first, plain(*a), atol=1e-5, rtol=1e-4)
    changed = torch.zeros((), dtype=torch.long, device="cuda")
    for _ in range(200):
        fn(*b)
        changed += (fn(*a) != first).sum()
    assert changed.item() == 0


def test_decode_attention_q8_refuses_what_the_kernel_does_not_take(gen):
    q, k8, ks, v8, vs, bias = _q8_inputs(gen, 2, 2, 2, 1, 40, 64,
                                         torch.float32)
    with pytest.raises(ValueError, match="neither"):
        decode_attention_q8(q, k8[:, :, :31].contiguous(), ks,
                            v8[:, :, :31].contiguous(), vs, bias)
    with pytest.raises(ValueError, match="k_scale"):
        decode_attention_q8(q, k8, ks[..., :-1].contiguous(), v8, vs, bias)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_q8(q, k8.transpose(2, 3).contiguous().transpose(
            2, 3), ks, v8, vs, bias)
    with pytest.raises(TypeError, match="k8"):
        decode_attention_q8(q, k8.float(), ks, v8, vs, bias)
    with pytest.raises(TypeError, match="v_scale"):
        decode_attention_q8(q, k8, ks, v8, vs.double(), bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("S", [256, 257, 513, 2173])
def test_decode_attention_q8_chunk_boundaries(gen, S, packed4, dtype):
    """S at and one column past kernel D's 256-column chunks, and the long
    article's source (9 chunks): against the plain version and D's
    chunked route; one combine launch where S > 256."""
    args = _q8_inputs(gen, 2, 4, 4, 5, S, 64, dtype, packed4)
    combines = decode_attention_q8.combine_launches
    _check_q8(args, dtype)
    assert decode_attention_q8.combine_launches == combines + (S > 256)
    out = decode_attention_q8(*args)
    ref = decode_attention_q8_split_plain(args[0].float(), *args[1:])
    _check_close(out, ref, dtype)


def test_decode_attention_q8_row_equals_itself_at_batch_one(gen):
    """Kernel D's (b, h) rows do not depend on the batch: B=1 on row b
    gives the B=8 launch's row b bit for bit, int8 and int4, q in fp32
    and bf16, at S within one chunk and across several."""
    for S in (200, 637, 2173):
        for packed4 in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                args = _q8_inputs(gen, 8, 16, 4, 5, S, 64, dtype, packed4)
                full = decode_attention_q8(*args)
                for b in (0, 5):
                    one = decode_attention_q8(*(t[b:b + 1].contiguous()
                                                for t in args))
                    assert torch.equal(one[0], full[b]), (S, packed4, dtype,
                                                          b)


def test_decode_attention_q8_rows_open_in_one_chunk(gen):
    """S=637: row 0 open in one column of the last chunk only (its output
    is that column of V dequantised, v8 * v_scale), row 1 in the middle
    chunk only; every other chunk's weight must be exactly 0."""
    S = 637
    q, k8, ks, v8, vs, bias = _q8_inputs(gen, 2, 4, 4, 5, S, 64,
                                         torch.float32)
    bias[:, :2] = float("-inf")
    bias[:, 0, S - 3] = 0.0
    bias[:, 1, 300:400] = 0.0
    _check_q8([q, k8, ks, v8, vs, bias], torch.float32)
    out = decode_attention_q8(q, k8, ks, v8, vs, bias)
    col = v8[..., S - 3].float() * vs[..., S - 3]
    torch.testing.assert_close(out[:, :, 0], col, atol=1e-6, rtol=1e-6)


def test_decode_attention_q8_refuses_shapes_it_has_no_kernel_for(gen):
    launches = decode_attention_q8.launches
    args = _q8_inputs(gen, 1, 2, 1, 1, 40, 128, torch.float32)
    with pytest.raises(ValueError, match="hd=128"):
        decode_attention_q8(*args)
    rows = MAX_ROWS + 1
    args = _q8_inputs(gen, 1, 2, 1, rows, 40, 64, torch.float32)
    with pytest.raises(ValueError, match=f"MG={rows}"):
        decode_attention_q8(*args)
    assert decode_attention_q8.launches == launches
    assert Q8_HEAD_DIMS == (32, 64)
    _check_q8(_q8_inputs(gen, 1, 2, 1, MAX_ROWS, 40, 64, torch.float32),
              torch.float32)


def _check_topk(x, table, k, zero_row=-1):
    launches = topk_logits.launches
    vals, ids, lse = topk_logits(x, table, k, zero_row)
    torch.cuda.synchronize()
    assert topk_logits.launches == launches + 1
    assert ids.dtype == torch.int32 and vals.shape == ids.shape == (
        x.shape[0], k)
    rv, ri, rl = topk_logits_plain(x, table, k, zero_row)
    torch.testing.assert_close(vals, rv, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, rl, atol=1e-5, rtol=1e-5)
    assert torch.equal(ids, ri)
    return vals, ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,V,D,k", [
    (1, 5, 16, 1),          # V below one chunk, one row
    (3, 64, 40, 5),         # exactly one chunk, ragged depth
    (70, 130, 64, 8),       # V and N past a chunk and a row tile
    (40, 5000, 1024, 5),    # the flagship's head band at N = 8 x 5
    (2, 5000, 1024, 4),     # top-k sampling (k=4) of a 2-request batch
    (2, 15000, 1024, 4),    # (chip_smoke.py's phase 13) over the
    (2, 30265, 1024, 4),    # flagship's three bands
])
def test_topk_logits_kernel_matches_plain(gen, N, V, D, k, dtype):
    x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
    table = (torch.randn(V, D, generator=gen, device="cuda") * 0.05).to(dtype)
    _check_topk(x, table, k, zero_row=V // 2)


def test_topk_logits_equal_logits_lower_id_first(gen):
    """Duplicated table rows across and inside chunks give equal logits:
    the lower id must come first."""
    x = torch.randn(4, 32, generator=gen, device="cuda")
    table = torch.randn(300, 32, generator=gen, device="cuda")
    table[[3, 70, 200, 201]] = table[250].clone()  # 5 equal rows
    x[0] = table[250] * 10                        # row 0: those win
    vals, ids = _check_topk(x, table, 8)
    assert ids[0, :5].tolist() == [3, 70, 200, 201, 250]
    assert torch.equal(vals[0, :5], vals[0, :1].expand(5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_logits_rows_do_not_depend_on_the_batch(gen, dtype):
    """Rows launched as N=5, N=40 and N=17 (one, three and two row tiles
    of 16) give their rows of the N=640 launch bit for bit: values, ids
    and lse. The model of the schedule agrees with the kernel."""
    x = torch.randn(640, 1024, generator=gen, device="cuda").to(dtype)
    table = (torch.randn(5000, 1024, generator=gen, device="cuda")
             * 1024 ** -0.5).to(dtype)
    full = topk_logits(x, table, 5, 1)
    for rows in (slice(0, 5), slice(0, 40), slice(300, 317), slice(635, 640)):
        part = topk_logits(x[rows].contiguous(), table, 5, 1)
        for a, b in zip(full, part):
            assert torch.equal(a[rows], b), (rows, dtype)
    vals, ids, lse = topk_logits_tiled(x.float(), table.float(), 5, 1)
    torch.testing.assert_close(full[0], vals, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(full[2], lse, atol=1e-5, rtol=1e-5)


def test_topk_logits_refuses_what_the_kernel_does_not_take(gen):
    x = torch.randn(4, 32, generator=gen, device="cuda")
    table = torch.randn(100, 32, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        topk_logits(x[:, :12].contiguous(), table[:, :12].contiguous(), 5)
    with pytest.raises(ValueError, match="16-byte aligned"):
        topk_logits(torch.randn(4 * 32 + 1, device="cuda")[1:].view(4, 32),
                    table, 5)
    with pytest.raises(ValueError, match="k=9"):
        topk_logits(x, table, 9)
    with pytest.raises(TypeError, match="table"):
        topk_logits(x, table.to(torch.bfloat16), 5)
    with pytest.raises(ValueError, match="contiguous"):
        topk_logits(x, table.T.contiguous().T, 5)
    with pytest.raises(ValueError, match="not"):
        topk_logits(x, table[:, :16].contiguous(), 5)


def _check_close(out, ref, dtype):
    assert out.dtype == dtype and torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    else:
        assert (out.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,G,S,bb", [
    (8, 4, 1, 637, 1),          # greedy rows, the flagship's source
    (8, 4, 5, 637, 2),          # beam 5: MG=20
    (8, 4, 5, 2173, 4),         # the long article's source, 201 KB of smem
    (4, 4, 1, 2173, 1),
    (2, 3, 1, 100, 2),          # ragged S, other MG
    (1, 1, 1, 1, 1),            # one column
])
def test_decode_attention_single_matches_plain(gen, B, M, G, S, bb, dtype):
    q, k, v, bias = _decode_inputs(gen, B, 16, M, G, S, 64, dtype)
    launches = decode_attention_single.launches
    out = decode_attention_single(q, k, v, bias, bb=bb)
    torch.cuda.synchronize()
    assert decode_attention_single.launches == launches + 1
    _check_close(out, decode_attention_plain(q.float(), k.float(), v.float(),
                                             bias), dtype)


def test_decode_attention_single_one_open_column(gen):
    """Every row masked but for one column: the output is that column of
    V exactly (p = 1 there, 0 elsewhere)."""
    B, H, MG, hd, S = 2, 4, 20, 64, 300
    q, k, v, _ = _decode_inputs(gen, B, H, 4, 5, S, hd, torch.float32)
    col = torch.randint(0, S, (B, MG), generator=gen, device="cuda")
    bias = torch.full((B, MG, S), float("-inf"), device="cuda")
    bias.scatter_(2, col[..., None], 0.0)
    out = decode_attention_single(q, k, v, bias, bb=2)
    want = v.permute(0, 1, 3, 2)[torch.arange(B, device="cuda")[:, None, None],
                                 torch.arange(H, device="cuda")[None, :, None],
                                 col[:, None, :]]
    torch.testing.assert_close(out, want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,G,S,bb", [
    (8, 4, 5, 637, 2), (4, 4, 5, 2173, 1), (2, 3, 1, 65, 2)])
def test_decode_attention_q4split_matches_plain(gen, B, M, G, S, bb, dtype):
    args = _q8_inputs(gen, B, 16, M, G, S, 64, dtype, packed4=True)
    launches = decode_attention_q4split.launches
    out = decode_attention_q4split(*args, bb=bb)
    torch.cuda.synchronize()
    assert decode_attention_q4split.launches == launches + 1
    _check_close(out, decode_attention_q8_plain(args[0].float(), *args[1:]),
                 dtype)


def test_decode_attention_single_repeats_bit_for_bit(gen):
    """Kernel F at B=8, H=16, MG=20, S=637, bb=2: 200 launches on one input,
    each after a launch on another, all equal the first output."""
    a, b = (_decode_inputs(gen, 8, 16, 4, 5, 637, 64, torch.float32)
            for _ in range(2))
    first = decode_attention_single(*a, bb=2)
    torch.testing.assert_close(first, decode_attention_plain(*a), atol=1e-5,
                               rtol=1e-4)
    changed = torch.zeros((), dtype=torch.long, device="cuda")
    for _ in range(200):
        decode_attention_single(*b, bb=2)
        changed += (decode_attention_single(*a, bb=2) != first).sum()
    assert changed.item() == 0


def test_decode_attention_single_refuses_what_the_kernel_does_not_take(gen):
    """S=4096 (past what a block's shared memory could hold of the [MG,
    S] score row) runs and equals the plain version; bb not dividing B,
    other head dims, a strided or mixed-dtype input and an int8 cache are
    refused before any launch."""
    q, k, v, bias = _decode_inputs(gen, 2, 2, 4, 5, 4096, 64, torch.float32)
    _check_close(decode_attention_single(q, k, v, bias),
                 decode_attention_plain(q, k, v, bias), torch.float32)
    launches = decode_attention_single.launches
    q32, k32, v32, b32 = _decode_inputs(gen, 2, 2, 4, 5, 100, 32,
                                        torch.float32)
    with pytest.raises(ValueError, match="hd in"):
        decode_attention_single(q32, k32, v32, b32)
    q, k, v, bias = _decode_inputs(gen, 6, 2, 4, 5, 100, 64, torch.float32)
    with pytest.raises(ValueError, match="multiple of bb=4"):
        decode_attention_single(q, k, v, bias, bb=4)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_single(
            q, k.transpose(2, 3).contiguous().transpose(2, 3), v, bias)
    with pytest.raises(TypeError, match="dtype"):
        decode_attention_single(q, k.to(torch.bfloat16), v, bias)
    args = _q8_inputs(gen, 2, 2, 4, 5, 100, 64, torch.float32)   # int8
    with pytest.raises(ValueError, match="packed int4"):
        decode_attention_q4split(*args)
    assert decode_attention_single.launches == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [256, 257, 512, 513, 2173, 4096])
def test_decode_attention_single_chunk_boundaries(gen, S, dtype):
    """S at and one column past kernel F's 256-column chunks, the long
    article's source and S=4096, fp and int4-split forms: against the
    plain versions and F's route (decode_attention_single_split_plain,
    decode_attention_q4split_split_plain)."""
    q, k, v, bias = _decode_inputs(gen, 2, 4, 4, 5, S, 64, dtype)
    out = decode_attention_single(q, k, v, bias, bb=2)
    args = (q.float(), k.float(), v.float(), bias)
    for ref in (decode_attention_plain(*args),
                decode_attention_single_split_plain(*args)):
        _check_close(out, ref, dtype)
    args = _q8_inputs(gen, 2, 4, 4, 5, S, 64, dtype, packed4=True)
    out = decode_attention_q4split(*args)
    qf = args[0].float()
    for ref in (decode_attention_q8_plain(qf, *args[1:]),
                decode_attention_q4split_split_plain(qf, *args[1:])):
        _check_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_single_bb_and_batch_change_no_bit(gen, dtype):
    """Kernel F at B=8, H=16, MG=20, S=637: bb = 1, 2 and 4 give the same
    bits, and batch row 3 launched alone at B=1 equals its row of B=8, in
    the fp and int4-split forms (S alone sets the chunks)."""
    q, k, v, bias = _decode_inputs(gen, 8, 16, 4, 5, 637, 64, dtype)
    q8 = _q8_inputs(gen, 8, 16, 4, 5, 637, 64, dtype, packed4=True)
    for fn, args in ((decode_attention_single, (q, k, v, bias)),
                     (decode_attention_q4split, q8)):
        outs = [fn(*args, bb=bb) for bb in (1, 2, 4)]
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
        one = fn(*(t[3:4].contiguous() for t in args))
        assert torch.equal(one, outs[0][3:4])

