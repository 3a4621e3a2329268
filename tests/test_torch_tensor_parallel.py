"""Tensor parallelism of the flagship's training (tell_tpu_torch/parallel/
mesh.py's shard_params and Mesh.model_axis, models/decoder.py's split
heads, column- and row-parallel FFN and masked vocabulary lookup,
ops/adaptive.py's gathered softmax bands, BertAdam's whole-leaf clip, the
train step's reductions and the Trainer) on gloo ranks of a small
captioner in fp32 (its image and article contexts), dropout off, with
the adaptive softmax's tail capacity on, against tell_tpu's unsharded
train step on the whole batch.

A grid of n_data 1 x n_model 2 here, and n_data 2 x n_model 2 in
tests/test_torch_tensor_parallel_dp.py, each a Trainer epoch of two
steps and a validation batch:
* each step's loss within 1e-5 relative of tell_tpu's, and the
  validation loss too;
* the first step's gradients, after the reduction and gathered over
  "model", within 1e-4 relative L2 per leaf and 1e-5 over the tree of
  tell_tpu's (jax.grad of its loss on the whole batch), and BertAdam's
  first moments after it (its clipped gradients' share, each leaf
  clipped by the whole leaf's norm) too;
* each rank's shard of the params equals the slice that
  tell_tpu.parallel.mesh's rules give the matching device of its mesh;
* the params after the steps within 1e-4 of tell_tpu's train step's, and
  equal on every rank.
"""
import jax
import numpy as np

from tell_tpu.config import small_test_config as j_small_config
from tell_tpu.models.captioner import captioner_loss as j_loss
from tell_tpu.models.captioner import init_captioner as j_init
from tell_tpu.parallel.mesh import make_mesh as j_make_mesh
from tell_tpu.parallel.mesh import shard_params as j_shard
from tell_tpu.training.optimizer import bert_adam as j_bert_adam
from tell_tpu_torch.config import small_test_config
from tell_tpu_torch.parallel import Ranks
from tests import _torch_parallel_workers as W
from tests.test_torch_dp_training import _batch

CAPACITY = dict(tail_capacity_frac=(0.25, 0.125))
N_CONTEXTS = 2                    # image and article: a smaller compile
LOSS_REL = 1e-5
LEAF_REL_L2, TREE_REL_L2 = 1e-4, 1e-5


def _configs():
    """(tell_tpu's small captioner config, the port's): the tail capacity
    on, the first N_CONTEXTS contexts."""
    return tuple(c(**CAPACITY, contexts=c().decoder.contexts[:N_CONTEXTS])
                 for c in (j_small_config, small_test_config))


def _leaves(tree):
    """A numpy tree's leaves in jax's (sorted-key) order."""
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def check_grads(got, want):
    """Per leaf within LEAF_REL_L2 and over the tree within TREE_REL_L2
    (relative L2)."""
    diff = ref = 0.0
    for a, b in zip(_leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert rel_l2(a, b) <= LEAF_REL_L2
        diff += float(np.sum((a - b) ** 2))
        ref += float(np.sum(b ** 2))
    assert np.sqrt(diff / ref) <= TREE_REL_L2


def _jax_run(jparams, train, val):
    """tell_tpu's train steps on the global batches (its loss's gradients
    and its BertAdam update, as its train step composes them; no batch
    here is skipped): the first step's (gradients, first moments), the
    params after the steps, the losses, and the validation loss."""
    import optax
    jcfg = _configs()[0]
    opt = j_bert_adam(warmup=0.0, t_total=100)
    loss_grad = jax.jit(jax.value_and_grad(
        lambda q, b: j_loss(q, jcfg, b)[0]))
    update = jax.jit(opt.update)
    p, o = jparams, opt.init(jparams)
    losses, first = [], None
    for b in train:
        loss, g = loss_grad(p, b)
        losses.append(float(loss))
        u, o = update(g, o, p)
        first = (g, o.m) if first is None else first
        p = optax.apply_updates(p, u)
    return first, p, losses, float(loss_grad(p, val[0])[0])


def _rule_slices(jparams, world, n_model):
    """Each rank's slice of every leaf as tell_tpu's rules place it: the
    addressable shard of the mesh device at the rank's grid position."""
    jmesh = j_make_mesh(n_data=world // n_model, n_model=n_model,
                        devices=jax.devices()[:world])
    placed = j_shard(jparams, jmesh)
    devices = list(np.asarray(jmesh.devices).reshape(-1))
    return [[np.asarray(next(s.data for s in a.addressable_shards
                             if s.device == d))
             for a in jax.tree.leaves(placed)] for d in devices]


def check_grid(tmp_path, world, n_model):
    """A Trainer epoch on the world / n_model x n_model grid held to
    tell_tpu's (the module's limits)."""
    jcfg, cfg = _configs()
    jparams = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params = jax.tree.map(np.asarray, jparams)
    train = [_batch(cfg, 8, 12, s) for s in (1, 2)]
    val = [_batch(cfg, 8, 12, 4)]
    ranks = Ranks(W.tp_train, world, (n_model, cfg, params, train, val,
                                      str(tmp_path / "run")),
                  deadline_s=150)
    j_grads, j_after, j_losses, j_val = _jax_run(jparams, train, val)
    outs = ranks.join()
    slices = _rule_slices(jparams, world, n_model)
    for r, out in enumerate(outs):
        for a, b in zip(_leaves(out["shards"]), slices[r]):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(out["losses"], j_losses, rtol=LOSS_REL)
        np.testing.assert_allclose(out["val_loss"], j_val, rtol=LOSS_REL)
        check_grads(out["grads"], j_grads[0])
        check_grads(out["moments"], j_grads[1])
        for a, b in zip(_leaves(out["params"]), jax.tree.leaves(j_after)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        for a, b in zip(_leaves(out["params"]), _leaves(outs[0]["params"])):
            np.testing.assert_array_equal(a, b)


def test_flagship_tensor_parallel_equals_tell_tpu(tmp_path):
    """n_data 1 x n_model 2 (the 2 x 2 grid:
    tests/test_torch_tensor_parallel_dp.py)."""
    check_grid(tmp_path, 2, 2)
