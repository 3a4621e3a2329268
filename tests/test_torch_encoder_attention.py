"""Kernel B's schedule against tell_tpu on the CPU.

encoder_attention_tiled models what the CUDA kernel does (64-key tiles in
order, an online softmax with the running max from -1e30, probabilities
rounded to q's dtype before PV, tiles of pad keys only skipped where the
row has a real key). Here it is held to roberta_encode's einsum attention
in JAX (tell_tpu/models/backbones/roberta.py:206, 227-232), the CPU
reference, with pads on the right, on the left, in the middle (whole pad
tiles between real ones) and everywhere, at S = 1, 63, 130 and 512;
skipping is shown to change no bit; and the kernel's fp32 route, 3xTF32
tensor-core products, is emulated (tell_tpu_torch/ops/kernels/tf32.py:
operands split into TF32 high and low parts on the int32 view, rounded to
nearest with ties away as cvt.rna.tf32 does, or cut as the kernel does)
and held to a float64 reference within chip_smoke.py's FP32_TOL.

Tolerances: fp32 atol = rtol = 1e-5 against the einsum path (the same math
summed in another order); 3xTF32 atol 1e-5, rtol 1e-4 (FP32_TOL, what the
kernel is held to on the card).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tell_tpu_torch.ops.kernels.encoder_attention import (
    TILE, encoder_attention_plain, encoder_attention_tiled, kept_tiles)
from tell_tpu_torch.ops.kernels.tf32 import mm_3xtf32, mm_tf32

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
FP32_TOL = dict(atol=1e-5, rtol=1e-4)
PADDINGS = ("right", "left", "middle", "all")


def _jax_einsum_attention(q, k, v, key_pad):
    """roberta_encode's einsum attention on [B, S, H, hd] inputs."""
    hd = q.shape[-1]
    neg = jnp.where(~key_pad, 0.0, -1e9)[:, None, None, :]
    scores = jnp.einsum("bthd,bshd->bhts", q, k,
                        preferred_element_type=jnp.float32)
    scores = scores * (hd ** -0.5) + neg
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    return jnp.einsum("bhts,bshd->bthd", probs, v,
                      preferred_element_type=jnp.float32)


def _inputs(S, padding, seed, B=2, H=2, hd=64):
    """Row 0 padded as named ("middle": keys 5..S-3 are pads, so at S=130
    and 512 whole pad tiles lie between real ones); row 1 has 30% random
    pads."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    key_pad = rng.random((B, S)) < 0.3
    row = np.zeros(S, bool)
    if padding == "right":
        row[max(1, S // 3):] = True
    elif padding == "left":
        row[:S - max(1, S // 3)] = True
    elif padding == "middle":
        row[5:S - 2] = True
    else:
        row[:] = True
    key_pad[0] = row
    return q, k, v, key_pad


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("S", [1, 63, 130, 512])
def test_tiled_schedule_matches_jax_einsum(S, padding):
    q, k, v, key_pad = _inputs(S, padding, seed=S)
    out = encoder_attention_tiled(*map(torch.from_numpy, (q, k, v, key_pad)))
    ref = _jax_einsum_attention(*map(jnp.asarray, (q, k, v, key_pad)))
    # every row, pad rows included, matches the einsum path
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if padding == "all":  # an all-pad row gives the mean of V
        np.testing.assert_allclose(
            out[0].numpy(), np.broadcast_to(v[0].mean(0), v[0].shape),
            **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("S", [130, 512])
def test_skipping_pad_tiles_changes_no_bit(S, padding, dtype):
    q, k, v, key_pad = (torch.from_numpy(a)
                        for a in _inputs(S, padding, seed=7 + S))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    on = encoder_attention_tiled(q, k, v, key_pad, skip=True)
    off = encoder_attention_tiled(q, k, v, key_pad, skip=False)
    assert torch.equal(on, off)
    kept = kept_tiles(key_pad)
    if padding in ("right", "left", "middle"):
        assert not bool(kept[0].all())      # the rule did skip a tile


def test_kept_tiles_of_the_phase3_case():
    """chip_smoke.py's phase-3 case (B=4, S=512, lengths 512/384/170/1):
    18 of 32 tiles kept, 1152 keys in them; an all-pad row keeps all."""
    lens = torch.tensor([512, 384, 170, 1])
    key_pad = torch.arange(512)[None, :] >= lens[:, None]
    kept = kept_tiles(key_pad)
    assert kept.sum(1).tolist() == [8, 6, 3, 1]
    assert int(kept.sum()) * TILE == 1152
    assert kept_tiles(torch.ones(2, 130, dtype=torch.bool)).all()


def _attention_tf32x3(q, k, v, key_pad, rounding="truncate", split=True):
    """The kernel's fp32 route on the CPU: 64-key tiles, online softmax,
    q.k and p.v as 3xTF32 products (split=False: one TF32 product)."""
    def mm(eq, a, b):
        return (mm_3xtf32 if split else mm_tf32)(eq, a, b, rounding)
    B, S, H, hd = q.shape
    neg = torch.zeros(key_pad.shape).masked_fill_(key_pad, -1e9)
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros(B, H, S)
    o = torch.zeros(B, H, S, hd)
    for j in range(-(-S // TILE)):
        cols = slice(j * TILE, min(S, (j + 1) * TILE))
        s = (mm("bthd,bshd->bhts", q, k[:, cols]) * hd ** -0.5
             + neg[:, None, None, cols])
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm("bhts,bshd->bhtd", p, v[:, cols])
        m = m_new
    return (o / l[..., None]).transpose(1, 2)


@pytest.mark.parametrize("rounding", ["rna", "truncate"])
def test_tf32x3_emulation_keeps_fp32_tolerance(rounding):
    """At S=512 the 3xTF32 route stays within FP32_TOL of a float64
    reference (and of the plain fp32 version), with the split rounded to
    nearest (cvt.rna.tf32) or cut (the kernel's two masks); one TF32
    product per element would not: it keeps about three digits."""
    q, k, v, key_pad = (torch.from_numpy(a)
                        for a in _inputs(512, "right", seed=3, B=2, H=4))
    neg = torch.zeros(key_pad.shape, dtype=torch.float64)
    scores = (torch.einsum("bthd,bshd->bhts", q.double(), k.double()) / 8.0
              + neg.masked_fill_(key_pad, -1e9)[:, None, None, :])
    ref64 = torch.einsum("bhts,bshd->bthd", torch.softmax(scores, -1),
                         v.double())
    x3 = _attention_tf32x3(q, k, v, key_pad, rounding)
    one = _attention_tf32x3(q, k, v, key_pad, rounding, split=False)
    err3 = (x3.double() - ref64).abs().max().item()
    err1 = (one.double() - ref64).abs().max().item()
    torch.testing.assert_close(x3.double(), ref64, **FP32_TOL)
    torch.testing.assert_close(x3, encoder_attention_plain(q, k, v, key_pad),
                               **FP32_TOL)
    # rna 8.3e-07, truncate 7.5e-07; one product 5.6e-04 (rna)
    assert err3 < FP32_TOL["atol"] / 5 < 10 * FP32_TOL["atol"] < err1, (
        err3, err1)
