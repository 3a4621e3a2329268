"""The MoE's routing over the global batch under data parallelism
(tell_tpu_torch/ops/moe.py with a group) on 2 gloo ranks, each holding
half the tokens, against tell_tpu's moe_ffn over the whole batch on the
CPU, as GSPMD runs it: every (token, choice) pair's expert, slot
position and drop equal tell_tpu's (its _route and its cumulative count
over the [k, N] priority order, with the capacity from the global token
count), each rank's output rows within 1e-5 and the aux within 1e-6.

Two routers: tell_tpu's init with pads taking no slot (top-2, capacity
factor 1.25), and a skewed one (top-2, capacity factor 1.0) that sends
rank 0's tokens and three of rank 1's to expert 0 first: rank 1's own
tokens fit the capacity it would have alone, but the global order fills
expert 0 with rank 0's first, so tell_tpu drops rank 1's, and so does
the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tell_tpu.ops import moe as jmoe
from tell_tpu_torch.parallel import Ranks
from tests import _torch_parallel_workers as W

N, D, F, E = 16, 8, 12, 4


def _cases():
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, jmoe.init_moe_ffn(
        jax.random.PRNGKey(1), D, F, E))
    x = rng.normal(size=(N, D)).astype(np.float32)
    mask = np.ones(N, bool)
    mask[[3, 12, 13]] = False
    skew = dict(params)
    w = np.zeros((D, E), np.float32)
    for e in range(E):
        w[e, e] = 6.0
    skew["router"] = {"w": w}
    xs = 0.1 * rng.normal(size=(N, D)).astype(np.float32)
    xs[:11, 0] += 1.0              # rank 0's 8 tokens and 3 of rank 1's
    xs[11:, 1] += 1.0
    xs[:, 2] += 0.5                # every token's second choice
    return {"init": (params, x, mask, 2, 1.25),
            "skewed": (params | {"router": skew["router"]}, xs,
                       np.ones(N, bool), 2, 1.0)}


def _jax_routing(params, x, mask, top_k, cf):
    """tell_tpu's moe_ffn routing (tell_tpu/ops/moe.py:92-105) over the
    whole batch: experts [k, N], positions [k, N], kept [k, N]."""
    k = min(top_k, E)
    cap = min(max(1, int(-(-N * k // E) * cf)), N)
    _, chosen, _ = jmoe._route(params, jnp.asarray(x), top_k)
    live = jnp.asarray(mask, jnp.float32)
    sel = jax.nn.one_hot(jnp.stack(chosen), E) * live[None, :, None]
    flat = sel.reshape(k * N, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, -1).reshape(k, N)
    keep = (pos < cap) & (live[None] > 0)
    return (np.asarray(jnp.stack(chosen)), np.asarray(pos).astype(int),
            np.asarray(keep), cap)


@pytest.fixture(scope="module")
def runs():
    cases = _cases()
    todo = [("moe_dp", case) for case in cases.values()]
    return cases, Ranks(W.jobs, 2, (todo,), deadline_s=120).join()


@pytest.mark.parametrize("name", ["init", "skewed"])
def test_routing_output_and_aux_equal_tell_tpu_over_the_batch(runs, name):
    cases, outs = runs
    params, x, mask, top_k, cf = cases[name]
    i = list(cases).index(name)
    experts, pos, keep, cap = _jax_routing(params, x, mask, top_k, cf)
    jp = jax.tree.map(jnp.asarray, params)
    want, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), top_k, cf,
                              jnp.asarray(mask))
    n = N // 2
    for r, rank_out in enumerate(outs):
        got = rank_out[i]
        cols = slice(r * n, (r + 1) * n)
        g = got["global"]
        assert g["cap"] == cap
        np.testing.assert_array_equal(g["expert"].reshape(top_k, n),
                                      experts[:, cols])
        live = np.broadcast_to(mask[cols], (top_k, n))    # pads: no slot
        np.testing.assert_array_equal(g["keep"].reshape(top_k, n),
                                      keep[:, cols])
        np.testing.assert_array_equal(
            np.where(live, g["pos"].reshape(top_k, n), -1),
            np.where(live, pos[:, cols], -1))
        np.testing.assert_allclose(got["out"], np.asarray(want)[cols],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["aux"], float(jaux), rtol=1e-6)
    if name == "skewed":
        # rank 1's expert-0 pairs fit its own capacity, not the global one
        local, glob = outs[1][i]["local"], outs[1][i]["global"]
        first = local["expert"][:n] == 0
        assert first.sum() == 3 and local["keep"][:n][first].all()
        assert not glob["keep"][:n][first].any()
