"""The port's asynchronous checkpoints (training/checkpoint.py) on the CPU,
with tell_tpu's consistency rules: save() returns before the write commits,
with a staged copy that later in-place updates do not reach; keep-N and
meta.json wait for the flush; a worker error is raised at flush() (and by
the next save); restore() equals the saved tree, flushed by restore() or
by save() then flush() (a synchronous save).
"""
import json
import os
import threading

import pytest
import torch

from tell_tpu_torch.bridge import tree_leaves
from tell_tpu_torch.training import checkpoint as ckpt_mod
from tell_tpu_torch.training.checkpoint import CheckpointManager


@pytest.fixture
def held_save(monkeypatch):
    """torch.save in the checkpoint module blocks until the event is set."""
    release = threading.Event()
    real = torch.save

    def save(obj, path):
        assert release.wait(timeout=30)
        real(obj, path)

    monkeypatch.setattr(ckpt_mod.torch, "save", save)
    yield release
    release.set()


def _state(i):
    return {"params": {"w": torch.arange(4, dtype=torch.float32) + i,
                       "h": torch.ones(2, 3, dtype=torch.bfloat16) * i},
            "opt": {"step": torch.tensor(i), "m": [torch.zeros(3)]}}


def test_async_save_returns_before_commit_on_a_staged_copy(tmp_path,
                                                           held_save):
    cm = CheckpointManager(str(tmp_path / "ck"), keep=2)
    state = _state(1)
    cm.save(0, state, {"step": 0})           # returns with torch.save held
    assert not (tmp_path / "ck" / "ckpt-0").exists()
    state["params"]["w"].add_(100.0)         # the next step, in place
    held_save.set()
    cm.flush()
    restored, meta = cm.restore(0)
    assert meta == {"step": 0}
    torch.testing.assert_close(restored["params"]["w"],
                               torch.arange(4, dtype=torch.float32) + 1)


def test_async_keep_and_meta_wait_for_the_flush(tmp_path, held_save):
    held_save.set()
    cm = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for i in range(2):
        cm.save(i, _state(i), {"step": i})
    assert cm.list() == [0, 1]
    held_save.clear()
    cm.save(2, _state(2), {"step": 2})
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert "ckpt-0" in names and "ckpt-2" not in names      # GC waits
    assert not any((tmp_path / "ck").glob("ckpt-2*/meta.json"))
    held_save.set()
    assert cm.list() == [1, 2]                               # list flushes
    assert json.loads((tmp_path / "ck" / "ckpt-2" / "meta.json")
                      .read_text()) == {"step": 2}
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt-1", "ckpt-2"]


def test_async_worker_error_raises_at_flush(tmp_path, monkeypatch):
    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", broken)
    cm = CheckpointManager(str(tmp_path / "ck"))
    cm.save(0, _state(0))                    # returns; the worker fails
    with pytest.raises(OSError, match="disk full"):
        cm.flush()
    cm.flush()                               # raised once, then clear
    cm.save_best(_state(0))
    with pytest.raises(OSError, match="disk full"):
        cm.save(1, _state(1))                # the next save flushes first
    assert list((tmp_path / "ck").iterdir()) == []


@pytest.mark.parametrize("flush", [False, True],
                         ids=["restore_flushes", "save_then_flush"])
def test_restore_equals_the_saved_tree(tmp_path, flush):
    cm = CheckpointManager(str(tmp_path / "ck"), keep=3)
    cm.save(7, _state(7), {"step": 7, "epoch": 1})
    cm.save_best(_state(3), {"metric": 0.5})
    if flush:                                # a synchronous save
        cm.flush()
        assert cm._pending is None
        assert sorted(os.listdir(tmp_path / "ck")) == ["best", "ckpt-7"]
    for tag, i in ((None, 7), (7, 7), ("best", 3)):
        state, _ = cm.restore(tag)
        want = _state(i)
        assert state.keys() == want.keys()
        for a, b in zip(tree_leaves(state), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert cm.restore(7)[1] == {"step": 7, "epoch": 1}
