"""Kernel E's plain version and the fused adaptive top-k route of
tell_tpu_torch against tell_tpu on the CPU.

topk_logits_plain against reference_topk_logits and against the JAX
Pallas topk_logits in interpret mode (a ragged last 2048-row tile, k from
1 to 8, a forced tie, the pinned padding row); adaptive_top_k(fused=True)
against JAX's _adaptive_top_k_fused under TELL_TPU_TOPK=1, and against the
port's exact per-cluster route.

Inputs from numpy seeds; weights from tell_tpu's init_decoder carried
across with the bridge. Tolerances: values and logsumexp 1e-5 (the same
fp32 products summed in another order); ids exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tell_tpu.config import small_test_config
from tell_tpu.models import decoder as jd
from tell_tpu.ops import adaptive as ja
from tell_tpu.ops.kernels import topk_logits as jt
from tell_tpu_torch.bridge import to_numpy, to_torch
from tell_tpu_torch.ops.adaptive import adaptive_top_k
from tell_tpu_torch.ops.kernels.topk_logits import topk_logits

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(N, V, D, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    table = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    return x, table


def _check(out, ref):
    vals, ids, lse = out
    assert ids.dtype == torch.int32
    np.testing.assert_allclose(to_numpy(vals), np.asarray(ref[0]), **TOL)
    np.testing.assert_array_equal(to_numpy(ids), np.asarray(ref[1]))
    np.testing.assert_allclose(to_numpy(lse), np.asarray(ref[2]), **TOL)


@pytest.mark.parametrize("k", range(1, 9))
def test_topk_logits_plain_matches_jax_reference(k):
    x, table = _case(6, 300, 24, k)
    out = topk_logits(torch.from_numpy(x), torch.from_numpy(table), k)
    _check(out, jt.reference_topk_logits(jnp.asarray(x), jnp.asarray(table),
                                         k))


@pytest.mark.parametrize("k", [1, 5, 8])
def test_topk_logits_plain_matches_jax_kernel(k):
    """The Pallas kernel in interpret mode over a ragged second 2048-row
    tile, with a tie inside a tile: the lower id first."""
    x, table = _case(3, 2100, 16, 10 + k)
    table[[40, 90]] = table[2050]                  # three equal rows
    x[0] = table[2050] * 8.0                       # row 0: they win
    out = topk_logits(torch.from_numpy(x), torch.from_numpy(table), k)
    ref = jt.topk_logits(jnp.asarray(x), jnp.asarray(table), k)
    _check(out, ref)
    assert to_numpy(out[1])[0, :min(k, 3)].tolist() == [40, 90, 2050][:k]


def test_topk_logits_ties_across_tiles_lower_id_first():
    """Equal logits in the second and fourth 2048-row tiles: the port
    gives the lower id first, as reference_topk_logits (jax.lax.top_k)
    does. (tell_tpu's Pallas kernel orders this tie by its running slots
    instead, [0, 6144, 2048]: a behaviour of the reference, ROADMAP.md
    queue 3.)"""
    V = 4 * 2048
    table = np.full((V, 1), -100.0, np.float32)
    table[[0, 1, 2, 2048, 2049, 4096, 6144], 0] = [9, 5, 1, 8, 6, 7, 8]
    x = np.ones((1, 1), np.float32)
    out = topk_logits(torch.from_numpy(x), torch.from_numpy(table), 3)
    _check(out, jt.reference_topk_logits(jnp.asarray(x), jnp.asarray(table),
                                         3))
    assert to_numpy(out[1]).tolist() == [[0, 2048, 6144]]


def test_topk_logits_plain_zero_row():
    """zero_row pins a vocabulary entry's logit to 0, as zeroing the
    table's padding row does."""
    x, table = _case(4, 70, 8, 3)
    zeroed = table.copy()
    zeroed[5] = 0.0
    out = topk_logits(torch.from_numpy(x), torch.from_numpy(table), 4,
                      zero_row=5)
    _check(out, jt.reference_topk_logits(jnp.asarray(x),
                                         jnp.asarray(zeroed), 4))


CFG = small_test_config().decoder


@pytest.fixture(scope="module")
def heads():
    params = jax.jit(lambda r: jd.init_decoder(r, CFG))(
        jax.random.PRNGKey(2))
    tparams = to_torch(jax.tree.map(np.asarray, params), "cpu")
    x = np.random.default_rng(0).normal(size=(7, CFG.embed_dim)).astype(
        np.float32)
    return params, tparams, x


@pytest.mark.parametrize("k", [1, 3, 5])
def test_fused_adaptive_top_k_matches_jax(heads, monkeypatch, k):
    """tell_tpu's TELL_TPU_TOPK route (its Pallas kernel in interpret
    mode) against the port's fused route, and the port's fused route
    against its exact one."""
    monkeypatch.setenv("TELL_TPU_TOPK", "1")       # read when JAX traces
    params, tparams, x = heads
    args = (CFG.full_cutoffs, k)
    rv, ri = jax.jit(lambda p, h: ja.adaptive_top_k(
        p["adaptive_softmax"], p["embed"], h, *args,
        padding_idx=CFG.embed_padding_idx))(params, jnp.asarray(x))
    tx = torch.from_numpy(x)
    fv, fi = adaptive_top_k(tparams["adaptive_softmax"], tparams["embed"],
                            tx, *args, padding_idx=CFG.embed_padding_idx,
                            fused=True)
    ev, ei = adaptive_top_k(tparams["adaptive_softmax"], tparams["embed"],
                            tx, *args, padding_idx=CFG.embed_padding_idx)
    assert fi.dtype == torch.int64
    np.testing.assert_allclose(to_numpy(fv), np.asarray(rv), **TOL)
    np.testing.assert_array_equal(to_numpy(fi), np.asarray(ri))
    torch.testing.assert_close(fv, ev, **TOL)
    assert torch.equal(fi, ei)
