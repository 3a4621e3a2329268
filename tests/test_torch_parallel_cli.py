"""`python -m tell_tpu_torch.commands train` on several ranks, on the CPU
(gloo), on tests/test_e2e_cli.py's corpus and tests/test_torch_cli.py's
small config (one bucket shape; 8 examples an epoch, so every global
batch is whole):

* trainer.n_data: 2 spawns 2 local ranks;
* --coordinator file://<store> --num-processes 2 --process-id I, run as
  two commands, is one rank each;
both end with the params of the one-rank run after the same steps
(1e-5), rank 0 alone writing the run's files. trainer.n_model: 2 (tensor
parallelism) runs the same two ways and ends with those params too.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from tell_tpu_torch.bridge import tree_leaves
from tell_tpu_torch.commands.__main__ import main
from tests.test_torch_cli import write_e2e_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dp_cli")
    cfg = write_e2e_config(root)
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["preprocess", cfg, "-s", "train"]) == 0
        assert main(["preprocess", cfg, "-s", "valid"]) == 0
    return cfg, root


def _over(run_dir, n_data, **trainer):
    return json.dumps({"trainer": {"serialization_dir": str(run_dir),
                                   "n_data": n_data, "num_epochs": 1,
                                   **trainer},
                       "data": {"instances_per_epoch": 8}})


def _params(run_dir):
    state = torch.load(os.path.join(run_dir, "checkpoints", "ckpt-0",
                                    "state.pt"), weights_only=True)
    return tree_leaves(state["params"])


def test_n_data_and_coordinator_runs_equal_one_rank(corpus, tmp_path):
    cfg, root = corpus
    env = {**os.environ, "PYTHONPATH": ROOT}
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tell_tpu_torch.commands", "train", cfg,
         "-o", _over(tmp_path / "coord", 2), "--device", "cpu",
         "--coordinator", f"file://{store}", "--num-processes", "2",
         "--process-id", str(i)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["train", cfg, "-o", _over(tmp_path / "one", 1),
                         "--device", "cpu"]) == 0
            assert main(["train", cfg, "-o", _over(tmp_path / "two", 2),
                         "--device", "cpu", "--report-launches",
                         str(tmp_path / "launches.json")]) == 0
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    results = [json.loads(line) for line in buf.getvalue().splitlines()
               if line.startswith("{")]
    assert results[0]["epochs"] == results[1]["epochs"] == 1
    assert json.loads(outs[0][0].strip().splitlines()[-1])["epochs"] == 1
    one = _params(tmp_path / "one")
    for run in ("two", "coord"):
        for a, b in zip(_params(tmp_path / run), one):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # rank 0 alone writes the metrics (one line an epoch)
    for run in ("one", "two", "coord"):
        lines = open(tmp_path / run / "metrics.jsonl").read().splitlines()
        assert len(lines) == 1
    assert set(json.load(open(tmp_path / "launches.json"))) == {
        "decode_attention", "encoder_attention", "fused_dynamic_conv",
        "decode_attention_q8", "topk_logits"}



def test_n_model_runs_locally_and_across_coordinator(corpus, tmp_path):
    """trainer.n_model 2: two local ranks, and two commands joined by
    --coordinator; each checkpoint is the whole tree, within 1e-5 of the
    one-rank run's."""
    cfg, root = corpus
    env = {**os.environ, "PYTHONPATH": ROOT}
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tell_tpu_torch.commands", "train", cfg,
         "-o", _over(tmp_path / "coord", 1, n_model=2), "--device", "cpu",
         "--coordinator", f"file://{store}", "--num-processes", "2",
         "--process-id", str(i)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["train", cfg, "-o", _over(tmp_path / "one", 1),
                         "--device", "cpu"]) == 0
            assert main(["train", cfg, "-o",
                         _over(tmp_path / "tp", 1, n_model=2),
                         "--device", "cpu"]) == 0
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    one = _params(tmp_path / "one")
    for run in ("tp", "coord"):
        got = _params(tmp_path / run)
        assert [a.shape for a in got] == [b.shape for b in one]
        for a, b in zip(got, one):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
