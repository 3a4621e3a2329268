"""The port's trainer options against tell_tpu on the CPU: TensorBoard
scalars (train/loss at the interval, equal to the logged losses and, for
the same steps from the same weights, to tell_tpu's Trainer within 1e-4;
the default interval writes when the step count reaches it). (The profiler
window and warm start are in test_torch_profile_warm_start.py, the
asynchronous checkpoints in test_torch_checkpoint.py.)

small_test_config with its article context 32 wide (dropout off in both
packages, whose random bits differ), a 2-layer RoBERTa from tell_tpu's
initialiser carried across with the bridge, batches packed once from a
seeded shard set and handed to both trainers.
"""
import dataclasses
import glob
import json
import logging
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from tell_tpu.config import small_test_config as j_small_config
from tell_tpu.models.backbones import RobertaConfig as JRobertaConfig
from tell_tpu.models.backbones import init_roberta as j_init_roberta
from tell_tpu.models.captioner import init_captioner as j_init_captioner
from tell_tpu.parallel import shard_params
from tell_tpu.training.trainer import Trainer as JTrainer
from tell_tpu.training.trainer import TrainerConfig as JTrainerConfig
from tell_tpu_torch.bridge import to_torch
from tell_tpu_torch.config import small_test_config
from tell_tpu_torch.data.bucketing import BucketingConfig, bucket_batches
from tell_tpu_torch.data.records import RecordDataset, write_shard
from tell_tpu_torch.models.backbones.roberta import RobertaConfig
from tell_tpu_torch.training.tensorboard import read_events
from tell_tpu_torch.training.trainer import Trainer, TrainerConfig
from tests.test_tensorboard import read_events as reference_read_events

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _article_32(cfg):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, contexts=tuple(
            dataclasses.replace(c, kv_dim=32) if c.name == "article" else c
            for c in cfg.decoder.contexts)))


CFG, JCFG = _article_32(small_test_config()), _article_32(j_small_config())
RKW = dict(vocab_size=500, dim=32, num_layers=2, num_heads=2, ffn_dim=64,
           max_positions=20)
BCFG = BucketingConfig(article_lengths=(16,), caption_lengths=(12,),
                       token_budget=112, max_batch=4, max_faces=4,
                       face_dim=16, max_objects=8, object_dim=32)
RUN = dict(num_epochs=2, patience=5, lr=3e-3, t_total=100, log_every=1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(train batches, valid batches, tell_tpu's frozen tower, the port's)
    from 12 + 4 seeded examples: 3 train batches and 1 valid batch."""
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(0)
    ex = [{"context_ids": np.concatenate(
               [[0], rng.randint(4, 90, rng.randint(6, 15)), [2]]
           ).astype(np.int32),
           "caption_ids": np.concatenate(
               [[0], rng.randint(4, 90, rng.randint(5, 11)), [2]]
           ).astype(np.int32),
           "image_grid": rng.randn(9, 32).astype(np.float32),
           "face_embeds": rng.randn(rng.randint(0, 3), 16).astype(
               np.float32),
           "obj_embeds": rng.randn(3, 32).astype(np.float32)}
          for _ in range(16)]
    write_shard(str(d / "train-00000.npz"), ex[:12])
    write_shard(str(d / "valid-00000.npz"), ex[12:])
    train = list(bucket_batches(RecordDataset(str(d / "train-*.npz"))
                                .epoch(lazy=True), BCFG))
    valid = list(bucket_batches(RecordDataset(str(d / "valid-*.npz"))
                                .epoch(lazy=True), BCFG))
    jroberta = j_init_roberta(jax.random.PRNGKey(5), JRobertaConfig(**RKW))
    frozen = {"roberta": to_torch(jax.tree.map(np.array, jroberta), "cpu"),
              "roberta_cfg": RobertaConfig(**RKW)}
    return train, valid, {"roberta": jroberta,
                          "roberta_cfg": JRobertaConfig(**RKW)}, frozen


def _feeds(data):
    train, valid = data[:2]
    copy = lambda bs: [{k: v.copy() for k, v in b.items()} for b in bs]  # noqa: E731
    return (lambda epoch: iter(copy(train))), (lambda: iter(copy(valid)))


def _trainer(data, run_dir, **kw):
    train, valid = _feeds(data)
    tcfg = TrainerConfig(serialization_dir=str(run_dir), **{**RUN, **kw})
    return Trainer(CFG, tcfg, train, valid, data[3], device="cpu")


def _events(run_dir):
    (path,) = glob.glob(os.path.join(str(run_dir), "tb", "events.out.*"))
    events = read_events(path)
    assert events == reference_read_events(path)
    return events


def _scalars(events, tag):
    return {e["step"]: e["scalars"][tag] for e in events
            if tag in e["scalars"]}


def test_scalars_equal_logged_losses_and_jax_trainer(data, tmp_path,
                                                     caplog):
    """The same steps from the same weights and batches in both trainers
    (one epoch of 3): train/loss at every step equal to the port's log and,
    within 1e-4, to tell_tpu's scalars; the epoch scalars likewise, and
    the epoch mean equal to metrics.jsonl's loss."""
    run = {**RUN, "num_epochs": 1}
    jtrain, jvalid = _feeds(data)
    jt = JTrainer(JCFG, JTrainerConfig(serialization_dir=str(tmp_path / "j"),
                                       summary_interval=1, n_data=1, **run),
                  jtrain, jvalid, frozen=data[2])
    init = shard_params(jax.jit(lambda r: j_init_captioner(r, JCFG))(
        jax.random.PRNGKey(0)), jt.mesh)      # as jt.initialize() places it
    params = jax.tree.map(np.array, init)
    opt = jt.optimizer.init(init)
    # the step counter on the mesh too, as the step's outputs are (else the
    # second step compiles again)
    opt = opt._replace(step=jax.device_put(opt.step, NamedSharding(
        jt.mesh, PartitionSpec())))
    jt.state = {"params": init, "opt": opt, "step": 0, "epoch": 0,
                "best_metric": float("inf"), "bad_epochs": 0}
    jt.train()

    tt = _trainer(data, tmp_path / "t", summary_interval=1, num_epochs=1)
    tt.initialize()
    tt.state["params"] = to_torch(params, "cpu")
    tt.state["opt"] = tt.optimizer.init(tt.state["params"])
    with caplog.at_level(logging.INFO, logger="tell_tpu_torch.trainer"):
        tt.train()
    logged = {int(m.group(1)): float(m.group(2)) for m in (
        re.search(r"step (\d+) loss (\S+)", r.getMessage())
        for r in caplog.records) if m}

    ours, theirs = _events(tmp_path / "t"), _events(tmp_path / "j")
    losses = _scalars(ours, "train/loss")
    assert sorted(losses) == sorted(logged) == [1, 2, 3]
    for s, v in losses.items():
        assert abs(v - logged[s]) <= 1e-6
    jlosses = _scalars(theirs, "train/loss")
    assert sorted(jlosses) == [1, 2, 3]
    np.testing.assert_allclose([losses[s] for s in (1, 2, 3)],
                               [jlosses[s] for s in (1, 2, 3)], **TOL)
    tags = {t for e in ours for t in e["scalars"] if t.startswith("epoch/")}
    assert tags == {t for e in theirs for t in e["scalars"]
                    if t.startswith("epoch/")}
    for tag in ("epoch/loss", "epoch/val_loss"):
        a, b = _scalars(ours, tag), _scalars(theirs, tag)
        assert sorted(a) == sorted(b) == [3]
        np.testing.assert_allclose([a[s] for s in a], [b[s] for s in a],
                                   **TOL)
    with open(tmp_path / "t" / "metrics.jsonl") as f:
        hist = [json.loads(line) for line in f]
    assert [h["loss"] for h in hist] == pytest.approx(
        [np.mean([logged[s] for s in (1, 2, 3)])], abs=1e-6)


def test_default_interval_writes_when_the_step_count_reaches_it(data,
                                                                tmp_path):
    """summary_interval 512 (the default, as in every expt/ YAML): an
    events file with epoch scalars from the first epoch, and train/loss at
    step 512, as tell_tpu writes them (a run resumed at step 510)."""
    assert TrainerConfig.summary_interval == JTrainerConfig.summary_interval
    tt = _trainer(data, tmp_path / "run")
    tt.initialize()
    tt.state["step"] = 510
    tt.train()
    events = _events(tmp_path / "run")
    assert _scalars(events, "train/loss").keys() == {512}
    assert sorted(_scalars(events, "epoch/loss")) == [513, 516]
