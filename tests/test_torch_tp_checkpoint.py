"""Checkpoints across tensor-parallel grids (the Trainer's gather_params
before rank 0 writes, shard_params after a restore): a run stopped after
its first step at n_model 2 (two gloo ranks) resumes at n_model 1 in one
process, and one stopped at n_model 1 resumes at n_model 2, each
step-exactly: the same batches in the same order from the stop on, each
resumed step's loss and the params at the end within 1e-5 of one
uninterrupted run at n_model 1. The small captioner's image and article
contexts, fp32, dropout off, weights from tell_tpu's init.
"""
import jax
import numpy as np

from tell_tpu.models.captioner import init_captioner as j_init
from tell_tpu_torch.parallel import Ranks
from tests import _torch_parallel_workers as W
from tests.test_torch_dp_training import _batch
from tests.test_torch_tensor_parallel import _configs, _leaves


def test_a_run_resumes_across_n_model_step_exactly(tmp_path):
    jcfg, cfg = _configs()
    params = jax.tree.map(np.asarray, jax.jit(j_init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    train = [_batch(cfg, 4, 12, s) for s in (1, 2, 3)]
    two = str(tmp_path / "from2")
    stop2 = Ranks(W.tp_resume, 2, (2, cfg, params, train, two, 1),
                  deadline_s=120)
    one = str(tmp_path / "from1")
    ref = W.tp_resume(0, 1, 1, cfg, params, train, str(tmp_path / "ref"))
    stopped1 = W.tp_resume(0, 1, 1, cfg, params, train, one, 1)
    resume2 = Ranks(W.tp_resume, 2, (2, cfg, None, train, one),
                    deadline_s=120)
    stopped2 = stop2.join()
    resumed1 = W.tp_resume(0, 1, 1, cfg, None, train, two)
    assert [r["step"] for r in stopped2] == [1, 1] and stopped1["step"] == 1
    np.testing.assert_allclose(stopped2[0]["losses"], ref["losses"][:1],
                               rtol=1e-5)
    for got in [resumed1] + resume2.join():
        assert got["step"] == 3
        np.testing.assert_allclose(got["losses"], ref["losses"][1:],
                                   rtol=1e-5)
        for a, b in zip(_leaves(got["params"]), _leaves(ref["params"])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
