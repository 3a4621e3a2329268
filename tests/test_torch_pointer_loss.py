"""pointer_loss v1 (tell_tpu_torch.models.pointer, expt a1: the
per-entity mean of the copy log-probs) against tell_tpu's on the CPU, at
tests/test_torch_pointer.py's small faces configuration with weigh_bert
on and off, on a batch with entities, one with no entity token (loss 0)
and one with repeated proper ids, a padded article tail, a padded
caption and an entity index of 25 (which neither copy loss counts, as
in tell_tpu). v2 is held the same way in tests/test_torch_pointer_v2.py.
The loss and its aux (gen, entity and copy losses) within 1e-5, every
gradient leaf within 1e-5 relative L2 (zero where tell_tpu's is: the
generation loss trains nothing); tell_tpu's loss and gradients jitted
once per configuration.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from tell_tpu.models import pointer as J
from tell_tpu_torch.bridge import init_pointer, tree_leaves, tree_map
from tell_tpu_torch.models import pointer as P
from tests.test_torch_pointer import (_close, _jb, _t, _tb, configs,
                                      jax_params, make_batch)

torch.set_num_threads(2)
GRAD_REL_L2 = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: J.pointer_loss(p, jcfg, b), has_aux=True))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def check_loss_and_gradients(version, weigh_bert, kind):
    """pointer_loss, its aux and every gradient against tell_tpu's."""
    jcfg, pcfg = configs(version, weigh_bert)
    jp = jax_params(1, weigh_bert)
    batch = make_batch(pcfg, seed=3, kind=kind)

    (jloss, jaux), jgrads = _jax_loss_grads(jcfg)(jp, _jb(batch))
    tp = tree_map(lambda x: x.requires_grad_(), _t(jp))
    loss, aux = P.pointer_loss(tp, pcfg, _tb(batch))
    loss.backward()
    _close(loss, jloss)
    for key in ("gen_loss", "entity_loss", "copy_loss"):
        _close(aux[key], jaux[key])
    if kind == "none":
        assert float(loss.detach()) == 0.0
    else:
        assert float(loss.detach()) > 0
        assert float(aux["copy_loss"].detach()) > 0
    jleaves = jax.tree.leaves(jgrads)
    leaves = tree_leaves(tp)
    assert len(leaves) == len(jleaves)
    for x, jg in zip(leaves, jleaves):
        g = torch.zeros_like(x) if x.grad is None else x.grad
        if not np.any(np.asarray(jg)):
            assert not g.any()
        else:
            assert rel_l2(g, jg) <= GRAD_REL_L2


KINDS = ("entities", "none", "repeated")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("weigh_bert", [True, False])
def test_pointer_loss_v1_and_gradients_equal_jax(weigh_bert, kind):
    check_loss_and_gradients(1, weigh_bert, kind)


def test_entity_index_past_24_counts_in_no_mean():
    """An entity index of 25 is dropped by both copy losses, as in
    tell_tpu: the batch's loss is the loss with that token's mask at 0."""
    _, pcfg = configs(1)
    params = init_pointer(torch.Generator().manual_seed(0), pcfg)
    batch = make_batch(pcfg, seed=3, kind="repeated")
    zeroed = dict(batch, caption_copy_masks=np.where(
        batch["caption_copy_masks"] == 25, 0, batch["caption_copy_masks"]))
    for version in (1, 2):
        cfg = dataclasses.replace(pcfg, copy_loss_version=version)
        a = P.pointer_loss(params, cfg, _tb(batch))[1]["copy_loss"]
        b = P.pointer_loss(params, cfg, _tb(zeroed))[1]["copy_loss"]
        assert torch.equal(a, b)
