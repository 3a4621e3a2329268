"""Tensor parallelism of the modern family's training loss
(tell_tpu_torch/models/llm_decoder.py's llm_loss with tp, the grid's
"model" axis) on 2 gloo ranks, n_model 2, against tell_tpu's llm_loss
on the CPU: expt 10's shape (GQA, 4 query heads over 2 K/V heads, one
K/V head a rank; SwiGLU's w1/w3 columns and w2 rows; the tied vocabulary
table's rows with the masked lookup and the vocabulary-parallel
llm_xent, a ragged chunk on each rank) and expt 12's (the MoE, its 4
experts 2 a rank: expert parallelism over "model", the router and
routing replicated). tests/test_torch_llm_training.py's small config and
batch, weights from tell_tpu's init_llm_decoder.

The loss within 1e-5 relative of tell_tpu's; the gradients gathered over
"model" within 1e-4 relative L2 per leaf and 1e-5 over the tree; each
rank's shard is its slice of the whole leaf by the rules.
"""
import jax
import numpy as np
import pytest

from tell_tpu.models import llm_decoder as J
from tell_tpu_torch.bridge import to_torch, tree_leaves_with_path
from tell_tpu_torch.parallel import Ranks
from tell_tpu_torch.parallel.mesh import Mesh, param_sharding_rules
from tests import _torch_parallel_workers as W
from tests.test_torch_llm_decoder import configs
from tests.test_torch_llm_training import (LOSS_RTOL, TRAIN,
                                           jax_loss_and_grads, train_batch)
from tests.test_torch_tensor_parallel import check_grads

CASES = {"expt10": dict(), "expt12": dict(moe_experts=4, moe_top_k=2,
                                          moe_capacity_factor=1.25)}


@pytest.fixture(scope="module")
def runs():
    """Each case's configs, tell_tpu params and batch, and the two ranks'
    results of every case from one spawn."""
    cases = {}
    for name, over in CASES.items():
        jcfg, pcfg = configs(**TRAIN, **over)
        jp = jax.jit(J.init_llm_decoder, static_argnums=1)(
            jax.random.PRNGKey(5), jcfg)
        cases[name] = (jcfg, pcfg, jp, train_batch(B=4))
    todo = [("tp_loss", (2, "llm", pcfg, jax.tree.map(np.asarray, jp),
                         batch)) for _, pcfg, jp, batch in cases.values()]
    ranks = Ranks(W.jobs, 2, (todo,), deadline_s=120)
    return cases, ranks


@pytest.fixture(scope="module")
def outs(runs):
    return runs[1].join()


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_parallel_llm_loss_equals_tell_tpu(runs, outs, case):
    cases, _ = runs
    jcfg, pcfg, jp, batch = cases[case]
    jloss, jaux, jgrads = jax_loss_and_grads(jcfg, jp, batch)
    i = list(CASES).index(case)
    whole = jax.tree.map(np.asarray, jp)
    specs = param_sharding_rules(to_torch(whole, "cpu"),
                                 Mesh((1, 2), ("data", "model")))
    assert any("model" in s for s in specs.values())
    for r, rank_out in enumerate(outs):
        got = rank_out[i]
        np.testing.assert_allclose(got["loss"], jloss, rtol=LOSS_RTOL)
        if pcfg.moe_experts:
            np.testing.assert_allclose(got["aux"]["moe_aux"],
                                       float(jaux["moe_aux"]), rtol=1e-5)
        check_grads(got["grads"], jgrads)
        for path, b in tree_leaves_with_path(got["shards"]):
            spec = specs[path]
            want = _leaf(whole, path)
            if "model" in spec:
                d = spec.index("model")
                k = want.shape[d] // 2
                want = np.take(want, range(r * k, (r + 1) * k), axis=d)
            np.testing.assert_array_equal(np.asarray(b), want)


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return np.asarray(tree)
