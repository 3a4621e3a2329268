"""The port's process layer (tell_tpu_torch/parallel/multihost.py) on 2
gloo ranks spawned by run_ranks (tests/_torch_parallel_workers.py, which
imports neither JAX nor tell_tpu).

As tests/test_multihost.py holds tell_tpu's two processes: rank 0 alone
is primary; a flag raised on one rank reaches both through global_any
(and a flag raised on none reaches neither); barrier returns; the global
batch is the ranks' rows in rank order; and the loss and gradient norm of
tests/_multihost_worker.py's linear model, each rank holding its rows,
equal its numpy reference over the whole batch (1e-6 relative). In one
process the primitives are the identity. A rank that fails ends the
others and its traceback is raised; a deadline kills ranks that hang.
"""
import numpy as np
import pytest
import torch

from tell_tpu_torch.parallel import (barrier, global_any, is_primary,
                                     make_mesh, place_global_batch,
                                     run_ranks)
from tests import _torch_parallel_workers as W


def _reference():
    B, D = 16, 8
    x = np.arange(B * D, dtype=np.float32).reshape(B, D) / (B * D)
    y = np.sin(np.arange(B, dtype=np.float32))[:, None]
    w = np.full((D, 1), 0.1, np.float32)
    err = x @ w - y
    return x, float(np.mean(err ** 2)), float(np.linalg.norm(
        2.0 / B * x.T @ err))


def test_two_ranks_agree_with_the_reference():
    outs = run_ranks(W.multihost, 2, deadline_s=120)
    x, loss, gnorm = _reference()
    assert [o["primary"] for o in outs] == [True, False]
    assert all(o["none"] is False for o in outs)
    assert all(o["one_sided"] is True for o in outs)
    for o in outs:
        # the ranks' rows concatenated in rank order are the global batch
        assert np.array_equal(o["gathered_x"].numpy(), x)
        np.testing.assert_allclose(o["loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(o["gnorm"], gnorm, rtol=1e-6)
    assert outs[0]["loss"] == outs[1]["loss"]


def test_single_process_is_the_identity():
    assert make_mesh().shape == {"data": 1, "model": 1}
    assert is_primary() and global_any(True) and not global_any(False)
    barrier("alone")
    b = {"x": np.arange(8, dtype=np.float32).reshape(4, 2)}
    placed = place_global_batch(b, "cpu")
    assert torch.equal(placed["x"], torch.from_numpy(b["x"]))


def test_a_failing_rank_raises_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(W.fail_on, 2, (1,), deadline_s=60)


def test_hung_ranks_are_killed_at_the_deadline():
    with pytest.raises(TimeoutError, match="deadline"):
        run_ranks(W.hang, 2, deadline_s=6)
