"""The MoE FFN under training (tell_tpu_torch.ops.moe.moe_ffn and expt
12's MoE llm_loss) against tell_tpu's on the CPU.

tell_tpu's init_moe_ffn / init_llm_decoder make the weights (carried
across with bridge.to_torch), numpy seeds the tokens. At capacity factor
1.25, where (token, choice) pairs past an expert's capacity are dropped,
with pads that take no slot, and at top-1 (the raw gate) and top-2:
the output and the Switch aux loss within 1e-4, and the gradients of a
loss that reads both (the router's through the gate and through P in the
aux, the experts' through index_add_, the tokens') within 1e-4 relative
L2 of jax.grad's. Expt 12's form of the LM (8 experts, top-2, 1.25):
llm_loss, its moe_aux and every gradient leaf against tell_tpu's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.models import llm_decoder as J
from tell_tpu.ops import moe as jmoe
from tell_tpu_torch.bridge import to_torch, tree_map
from tell_tpu_torch.ops import moe as pmoe
from tests.test_torch_llm_decoder import configs
from tests.test_torch_llm_training import (LOSS_RTOL, TRAIN,
                                           jax_loss_and_grads,
                                           port_loss_and_grads, rel_l2,
                                           train_batch)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_REL_L2 = 1e-4
CF = 1.25


def _objective(out, aux, w):
    """A scalar that reads every output element and the aux loss."""
    return (out * w).sum() + 3.0 * aux


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("pads", [False, True], ids=["no_pads", "pads"])
def test_moe_ffn_gradients_equal_jax(top_k, pads):
    d, f, e, n = 12, 16, 4, 40
    jp = jmoe.init_moe_ffn(jax.random.PRNGKey(top_k), d, f, e)
    rng = np.random.default_rng(top_k + 10 * pads)
    # a shared offset leans the router towards some experts, so pairs
    # overflow their capacity
    x = (rng.normal(size=(n, d)) + 1.5 * rng.normal(size=d)).astype(
        np.float32)
    w = rng.normal(size=(n, d)).astype(np.float32)
    mask = np.ones(n, bool)
    if pads:
        mask[rng.choice(n, 9, replace=False)] = False
    jmask = jnp.asarray(mask) if pads else None

    def j_fn(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, top_k=top_k, capacity_factor=CF,
                                token_mask=jmask)
        return _objective(out, aux, jnp.asarray(w)), (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(),
                  to_torch(jax.tree.map(np.asarray, jp), "cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = pmoe.moe_ffn(tp, tx, top_k=top_k, capacity_factor=CF,
                            token_mask=torch.from_numpy(mask) if pads
                            else None)
    _objective(out, aux, torch.from_numpy(w)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    # capacity min(n, ceil(n k / e) * 1.25) drops pairs here
    routed = pmoe._route(tp, tx.detach(), top_k)[1]
    live = torch.from_numpy(mask)
    cap = min(int(-(-n * top_k // e) * CF), n)
    per_expert = torch.bincount(routed[:, live].reshape(-1), minlength=e)
    assert int(per_expert.max()) > cap, "no pair was dropped"
    if pads:
        assert not out[~live].detach().any()
    got = [tx, tp["router"]["w"], tp["w1"], tp["w3"], tp["w2"]]
    want = [jgx, jgp["router"]["w"], jgp["w1"], jgp["w3"], jgp["w2"]]
    errs = [rel_l2(g.grad, j) for g, j in zip(got, want)]
    assert max(errs) <= GRAD_REL_L2, errs


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_llm_loss_and_gradients_equal_jax(top_k):
    jcfg, pcfg = configs(moe_experts=8, moe_top_k=top_k,
                         moe_capacity_factor=CF, **TRAIN)
    params = J.init_llm_decoder(jax.random.PRNGKey(11), jcfg)
    batch = train_batch(B=3, T=12, seed=12)
    jl, jaux, jg = jax_loss_and_grads(jcfg, params, batch)
    pl, paux, pg = port_loss_and_grads(pcfg, params, batch)
    np.testing.assert_allclose(paux["moe_aux"].item(), float(jaux["moe_aux"]),
                               **TOL)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    errs = [rel_l2(g, j) for g, j in zip(pg, jg)]
    assert len(errs) == len(jg) and max(errs) <= GRAD_REL_L2, max(errs)
