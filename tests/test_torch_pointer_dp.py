"""The pointer models' loss over the global batch under data parallelism
(tell_tpu_torch/models/pointer.py's pointer_loss with a group) on 2 gloo
ranks, against tell_tpu's pointer_loss over the whole batch on the CPU:
v1 (expt a1) and v2 (expt a3) at tests/test_torch_pointer.py's small
faces configuration, weights from tell_tpu's init_pointer.

Rank 0 holds the "repeated" batch's rows (entities repeated over the
article, a padded caption, an entity index of 25) and rank 1 the
"entities" batch's, so the ranks' entity token counts differ. The loss
and its parts (gen, entity and copy losses) within 1e-6 relative of
tell_tpu's, and the gradients summed over the ranks within 1e-5
relative L2 per leaf; the average of the two ranks' own losses misses
that limit, as the per-entity means are the global batch's.
"""
import jax
import numpy as np
import pytest

from tell_tpu.models import pointer as J
from tell_tpu_torch.models import pointer as P
from tell_tpu_torch.parallel import Ranks
from tests import _torch_parallel_workers as W
from tests.test_torch_pointer import _jb, _t, _tb, configs, jax_params
from tests.test_torch_pointer import make_batch
from tests.test_torch_pointer_loss import rel_l2

PART_REL = 1e-6
GRAD_REL_L2 = 1e-5
VERSIONS = (1, 2)


def _batch(pcfg):
    a = make_batch(pcfg, seed=3, kind="repeated")
    b = make_batch(pcfg, seed=4, kind="entities")
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def pointer_runs(n_model: int):
    """tell_tpu's params, the cases {version: (tell_tpu config, the port's,
    batch)} and each rank's tp_loss of every version on a (2 / n_model) x
    n_model grid of 2 gloo ranks."""
    jp = jax_params(1)
    cases = {}
    for v in VERSIONS:
        jcfg, pcfg = configs(v)
        cases[v] = (jcfg, pcfg, _batch(pcfg))
    todo = [("tp_loss", (n_model, "pointer", pcfg,
                         jax.tree.map(np.asarray, jp), batch))
            for _, pcfg, batch in cases.values()]
    return jp, cases, Ranks(W.jobs, 2, (todo,), deadline_s=120).join()


@pytest.fixture(scope="module")
def runs():
    return pointer_runs(1)


def held_to_tell_tpu(runs, version):
    """Every rank's loss, parts and gathered gradients against tell_tpu's
    pointer_loss over the whole batch -> (tell_tpu's params, the port's
    config, the batch, tell_tpu's loss)."""
    jp, cases, outs = runs
    jcfg, pcfg, batch = cases[version]
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: J.pointer_loss(p, jcfg, b), has_aux=True))(
            jp, _jb(batch))
    for rank_out in outs:
        got = rank_out[VERSIONS.index(version)]
        np.testing.assert_allclose(got["loss"], float(jloss), rtol=PART_REL)
        for key in ("gen_loss", "entity_loss", "copy_loss"):
            np.testing.assert_allclose(got["aux"][key], float(jaux[key]),
                                       rtol=PART_REL)
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray,
                                                     got["grads"])),
                        jax.tree.leaves(jgrads)):
            if np.any(np.asarray(b)):
                assert rel_l2(a, b) <= GRAD_REL_L2
            else:
                assert not np.any(a)
    return jp, pcfg, batch, jloss


@pytest.mark.parametrize("version", VERSIONS)
def test_pointer_loss_over_two_ranks_equals_tell_tpu(runs, version):
    jp, pcfg, batch, jloss = held_to_tell_tpu(runs, version)
    # each rank's own means, averaged, are not the global batch's
    halves = [{k: v[r * 2:(r + 1) * 2] for k, v in batch.items()}
              for r in range(2)]
    own = [float(P.pointer_loss(_t(jp), pcfg, _tb(h))[0].detach())
           for h in halves]
    assert abs(np.mean(own) - float(jloss)) > PART_REL * abs(float(jloss))
