"""Kernel C's plain version and the port's full-sequence dynamic_conv
against tell_tpu on the CPU.

The JAX side runs as its own tests run it here: _reference (the kernel's
jnp twin), dynamic_conv on its jnp path, and once fused_dynamic_conv
itself, the Pallas kernel in interpret mode. The CUDA kernel needs the
card: tests/test_torch_cuda.py and chip_smoke.py hold it to
dynamic_conv_plain there. Its schedule, dynamic_conv_tiled (the tap logits
as the kernel's mma fragments accumulate them under
tf32.mma_accumulate's model, 3xTF32 for fp32, a fresh fragment per
128-byte slot of C, the slot's k-steps shared by the warps of a logit
tile), is held to the JAX _reference at K=31 and K=3, C=1024, at the
tilings conv_tiling picks for the flagship's training shape and for a
small batch. Inputs come from a numpy seed.
Tolerances: forward 2e-5 (the JAX kernel test's), gradients 1e-4; bf16
2e-2 absolute (the output is rounded to bf16).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tell_tpu.ops.dynamic_conv import dynamic_conv as j_dynamic_conv
from tell_tpu.ops.kernels.dynamic_conv import (
    _reference as j_reference, fused_dynamic_conv as j_fused)
from tell_tpu_torch.ops import dynamic_conv as port_dc
from tell_tpu_torch.ops.dynamic_conv import _can_fuse, dynamic_conv
from tell_tpu_torch.ops.kernels.dynamic_conv import (
    conv_tiling, dynamic_conv_plain, dynamic_conv_tiled, fused_dynamic_conv)

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(B, T, C, H, K, seed):
    """x [B, T, C] and the h-major predictor [C, H*K] (xavier bound), plus
    its k-major rearrangement [C, K*H]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    bound = (6.0 / (C + H * K)) ** 0.5
    w = rng.uniform(-bound, bound, size=(C, H * K)).astype(np.float32)
    w_km = w.reshape(C, H, K).transpose(0, 2, 1).reshape(C, K * H)
    return x, w, np.ascontiguousarray(w_km)


SHAPES = [(2, 16, 128, 4, 3, True), (1, 40, 128, 8, 7, True),
          (2, 130, 256, 16, 31, True), (1, 15, 128, 4, 31, True),
          (2, 9, 128, 4, 5, False)]
IDS = ["k3", "k7_ragged", "k31_long", "t_below_k", "no_softmax"]


@pytest.mark.parametrize("B,T,C,H,K,sm", SHAPES, ids=IDS)
def test_plain_matches_jax_reference_and_dynamic_conv(B, T, C, H, K, sm):
    x, w, w_km = _inputs(B, T, C, H, K, seed=B * T + K)
    out = dynamic_conv_plain(torch.from_numpy(x), torch.from_numpy(w_km),
                             K, H, sm)
    ref = j_reference(jnp.asarray(x), jnp.asarray(w_km), K, H, sm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    params = {"weight_linear": {"w": jnp.asarray(w)}}
    ref_dc = j_dynamic_conv(params, jnp.asarray(x), kernel_size=K,
                            num_heads=H, weight_softmax=sm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_dc), **TOL)
    # the port's op (gate open: the wrapper's plain version on the CPU)
    port = dynamic_conv({"weight_linear": {"w": torch.from_numpy(w)}},
                        torch.from_numpy(x), kernel_size=K, num_heads=H,
                        weight_softmax=sm)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref_dc), **TOL)


def test_plain_matches_pallas_kernel_in_interpret_mode():
    B, T, C, H, K = 1, 20, 128, 4, 7
    x, _, w_km = _inputs(B, T, C, H, K, seed=3)
    ref = j_fused(jnp.asarray(x), jnp.asarray(w_km), K, H, True)
    out = fused_dynamic_conv(torch.from_numpy(x), torch.from_numpy(w_km),
                             K, H, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert fused_dynamic_conv.launches == 0     # CPU: the plain version


@pytest.mark.parametrize("sm", [True, False])
def test_gradients_match_jax_grad_of_reference(sm):
    B, T, C, H, K = 2, 12, 128, 4, 5
    x, w, w_km = _inputs(B, T, C, H, K, seed=7)
    g = np.random.default_rng(8).normal(size=(B, T, C)).astype(np.float32)

    def j_loss(xx, ww):
        return jnp.sum(j_reference(xx, ww, K, H, sm) * g)

    jgx, jgw = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w_km))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w_km).requires_grad_()
    (fused_dynamic_conv(xt, wt, K, H, sm) * torch.from_numpy(g)).sum(
        ).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), **GRAD_TOL)

    # through the public op: the k-major layout transpose carries the
    # gradient back to the h-major weight_linear.w
    def j_dc_loss(xx, ww):
        return jnp.sum(j_dynamic_conv({"weight_linear": {"w": ww}}, xx,
                                      kernel_size=K, num_heads=H,
                                      weight_softmax=sm) * g)

    jgx2, jgw2 = jax.grad(j_dc_loss, argnums=(0, 1))(jnp.asarray(x),
                                                     jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = dynamic_conv({"weight_linear": {"w": wt}}, xt, kernel_size=K,
                       num_heads=H, weight_softmax=sm)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx2), **GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw2), **GRAD_TOL)


def test_can_fuse_routing(monkeypatch):
    p = {"weight_linear": {"w": torch.zeros(64, 12)}}
    # the TPU lane condition C % 128 == 0 is dropped: C = 64 fuses (whole
    # heads of a multiple of 8 channels)
    assert _can_fuse(p, None, 0.1, True, 4, 64)
    assert _can_fuse(p, None, 0.0, False, 4, 64)
    assert not _can_fuse(p, None, 0.1, False, 4, 64)   # active dropout
    assert not _can_fuse(p, torch.zeros(1), 0.0, True, 4, 64)  # query
    assert not _can_fuse({"weight_linear": {"w": p["weight_linear"]["w"],
                                            "b": torch.zeros(12)}},
                         None, 0.0, True, 4, 64)
    assert not _can_fuse({**p, "conv_bias": torch.zeros(64)}, None, 0.0,
                         True, 4, 64)
    assert not _can_fuse(p, None, 0.0, True, 5, 64)      # C % H != 0
    assert not _can_fuse(p, None, 0.0, True, 16, 64)     # 4 channels a head

    calls = []

    def spy(x, w_km, k, h, sm):
        calls.append((tuple(x.shape), tuple(w_km.shape), k, h, sm))
        return dynamic_conv_plain(x, w_km, k, h, sm)

    monkeypatch.setattr(port_dc, "fused_dynamic_conv", spy)
    x = torch.randn(2, 6, 64)
    w = torch.randn(64, 4 * 3) * 0.1
    dynamic_conv({"weight_linear": {"w": w}}, x, kernel_size=3, num_heads=4)
    assert calls == [((2, 6, 64), (64, 12), 3, 4, True)]
    # active weight dropout: the unfused ops, as tell_tpu routes it
    gen = torch.Generator().manual_seed(0)
    out = dynamic_conv({"weight_linear": {"w": w}}, x, kernel_size=3,
                       num_heads=4, weight_dropout=0.5, gen=gen,
                       deterministic=False)
    assert len(calls) == 1 and out.shape == x.shape


def test_heads_per_block():
    """conv_tiling's (time rows, heads) per block: at the flagship's
    training shape (B=16, T=32, H=16) every layer gets 256 blocks; a
    larger batch takes more heads a block; a short caption takes 16-row
    tiles; too small a batch for 256 blocks takes the most blocks."""
    assert [conv_tiling(16, 32, k, 16) for k in (3, 7, 15, 31)] == [
        (32, 1)] * 4
    assert conv_tiling(16, 100, 31, 16) == (32, 1)
    assert conv_tiling(16, 15, 31, 16) == (16, 1)
    assert conv_tiling(32, 32, 3, 16) == (32, 2)
    assert conv_tiling(128, 32, 3, 16) == (32, 8)
    assert conv_tiling(2, 40, 31, 16) == (16, 1)


# (T, K, tiling): the training shape's tiling, (32, 1), at K=31 (32 logit
# columns, one warp a logit tile) and K=3 (8 columns, four warps a tile);
# conv_tiling's own pick at B=1, T=20, (16, 1), two warps a tile. Two time
# rows past a 16-row tile, fewer than K: the logits of a row do not depend
# on the tile's other rows.
@pytest.mark.parametrize("T,K,tiling", [(18, 31, (32, 1)),
                                        (18, 3, (32, 1)), (20, 31, None)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_tiled_schedule_matches_jax_reference(T, K, tiling, dtype):
    B, C, H = 1, 1024, 16
    if tiling is None:
        assert conv_tiling(B, T, K, H) == (16, 1)
    x, _, w_km = _inputs(B, T, C, H, K, seed=T + K)
    if dtype == "bf16":
        x, w_km = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (x, w_km))
    ref = np.asarray(jax.jit(j_reference, static_argnums=(2, 3, 4))(
        jnp.asarray(x), jnp.asarray(w_km), K, H, True))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w_km)
    if dtype == "bf16":
        out = dynamic_conv_tiled(xt.bfloat16(), wt.bfloat16(), K, H,
                                 tiling=tiling)
        assert out.dtype == torch.bfloat16
        assert np.abs(out.float().numpy() - ref).max() <= 2e-2
    else:
        out = dynamic_conv_tiled(xt, wt, K, H, tiling=tiling)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_profile_conv_tool_on_cpu(capsys):
    """The kernel C profile tool at CPU-sized shapes: every shape and
    dtype timed, the plain version on the host clock, no device time."""
    from tell_tpu_torch.tools import profile_conv
    res = profile_conv.run(device="cpu", small=True, calls=1)
    assert len(res) == 2 * len(profile_conv.SHAPES)
    assert all(ms > 0 and layout == 0 for ms, layout in res.values())
    out = capsys.readouterr().out
    assert "plain version" in out and "timed the plain version" in out

