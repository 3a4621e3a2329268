"""Kernels A, B and C on the card against their plain versions, at edge
shapes the main paths do not reach (S below and across one tile, single
query rows, other head dims for kernel A; T=1, T<K, T across a time tile
and a ragged last tile, 8 and 16 heads, no softmax for kernel C), kernel
C's gradient through its autograd Function, and the inputs the wrappers
must refuse. Marked `cuda`: each test skips without a GPU.

This file imports no JAX, so it also runs where JAX is absent (the card's
machine; tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: A and B fp32 atol 1e-5, rtol 1e-4 (online vs two-pass
softmax, other summation order); C fp32 atol = rtol = 2e-5 (the JAX kernel
test's), C gradients 1e-4; bf16 inputs: 2e-2 absolute against the plain
version in fp32 on the same bf16-rounded inputs (for C without softmax,
2e-2 of the output's largest magnitude: the raw tap logits are not
normalised, and bf16 output rounding is relative).
"""
import pytest
import torch

from tell_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, decode_attention_plain, segment_bias)
from tell_tpu_torch.ops.kernels.dynamic_conv import (
    dynamic_conv_plain, fused_dynamic_conv)
from tell_tpu_torch.ops.kernels.encoder_attention import (
    encoder_attention, encoder_attention_plain)

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
@pytest.mark.parametrize("B,S,H,hd", [
    (1, 1, 1, 64), (2, 63, 3, 64), (3, 130, 2, 64), (2, 256, 16, 64)])
def test_encoder_attention_kernel_matches_plain(gen, B, S, H, hd, dtype):
    q, k, v = (torch.randn(B, S, H, hd, generator=gen, device="cuda")
               for _ in range(3))
    key_pad = torch.rand(B, S, generator=gen, device="cuda") < 0.3
    key_pad[-1] = True                     # an all-pad row
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
