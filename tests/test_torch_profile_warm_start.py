"""The port trainer's profiler window and warm start on the CPU: steps
[profile_at, profile_at + profile_steps) run under torch.profiler and no
other, a window that would cross an epoch's end is cut there (as
tell_tpu's), the trace written also when the run fails inside the window; a warm start takes a checkpoint's params
bit for bit, refuses a directory without state.pt and a tree of another
model. The setup is test_torch_trainer_options.py's.
"""
import dataclasses
import glob
import json
import os

import pytest
import torch

from tell_tpu_torch.bridge import tree_leaves
from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.training.trainer import Trainer, TrainerConfig
from tests.test_torch_trainer_options import CFG, _feeds, _trainer, data

__all__ = ["data"]     # the shared fixture


@pytest.mark.parametrize("at,steps,marked", [
    (1, 2, {1, 2}),          # inside epoch 0 (steps 0-2)
    (4, 1, {4}),             # inside epoch 1
    (2, 3, {2}),             # cut at the end of epoch 0, no validation
], ids=["epoch0", "epoch1", "cut"])
def test_profiler_window_covers_its_steps(data, tmp_path, at, steps,
                                          marked):
    """3 batches an epoch: the window marks [at, at + steps) within its
    epoch and no other step; no TensorBoard directory with
    summary_interval 0."""
    tt = _trainer(data, tmp_path / "run", summary_interval=0,
                  profile_at=at, profile_steps=steps)
    tt.train()
    assert tt.state["step"] == 6 and tt._profiler is None
    (trace,) = glob.glob(str(tmp_path / "run" / "profile" / "*.json"))
    assert os.path.basename(trace) == f"trace-{at}.json"
    with open(trace) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    got = {int(n.split(":")[1]) for n in names
           if n.startswith("train_step:")}
    assert got == marked
    assert not (tmp_path / "run" / "tb").exists()


def test_profiler_window_closes_when_the_run_fails(data, tmp_path):
    tt = _trainer(data, tmp_path / "run", summary_interval=0, profile_at=1,
                  profile_steps=10)
    inner = tt._step_fn

    def fail_at_third(*args):
        if tt.state["step"] == 2:
            raise RuntimeError("boom")
        return inner(*args)

    tt._step_fn = fail_at_third
    with pytest.raises(RuntimeError, match="boom"):
        tt.train()
    assert tt._profiler is None
    (trace,) = glob.glob(str(tmp_path / "run" / "profile" / "*.json"))
    with open(trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"train_step:1", "train_step:2"} <= names


def test_warm_start_takes_the_checkpoint_params(data, tmp_path):
    first = _trainer(data, tmp_path / "a", num_epochs=1)
    first.train()
    best = tmp_path / "a" / "checkpoints" / "best"
    saved = torch.load(best / "state.pt", weights_only=True)["params"]
    warm = _trainer(data, tmp_path / "b", warm_start=str(best))
    warm.initialize()
    fresh = _trainer(data, tmp_path / "c")
    fresh.initialize()
    for a, b, c in zip(tree_leaves(warm.state["params"]),
                       tree_leaves(saved),
                       tree_leaves(fresh.state["params"])):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert any(not torch.equal(a, c) for a, c in zip(
        tree_leaves(warm.state["params"]),
        tree_leaves(fresh.state["params"])))
    assert int(warm.state["opt"].step) == 0 and warm.state["step"] == 0
    assert "preempted" not in warm.train()

    with pytest.raises(NotPortedError, match="state.pt"):
        _trainer(data, tmp_path / "d", warm_start=str(tmp_path)).initialize()
    other = dataclasses.replace(CFG, decoder=dataclasses.replace(
        CFG.decoder, kernel_sizes=(3, 7)))
    train, valid = _feeds(data)
    with pytest.raises(ValueError, match="tree"):
        Trainer(other, TrainerConfig(serialization_dir=str(tmp_path / "e"),
                                     warm_start=str(best)),
                train, valid, data[3], device="cpu").initialize()
