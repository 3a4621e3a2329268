"""The training loop on one device (counterpart of
tell_tpu/training/trainer.py) and its entry point, train_from_shards
(the sequence `tnt train` runs: RecordDataset over train-*.npz and
valid-*.npz, bucket_batches with an epoch_index-seeded order, then
Trainer.train, or Trainer.recover first).

Kept from tell_tpu: the epoch loop, validation and patience, best and
keep-N checkpoints every `checkpoint_every` epochs, request_stop / SIGTERM
with a mid-epoch batch_cursor so a resumed run is step-exact, the
tail-capacity overflow warning, and metrics.jsonl. Dropout draws from a
generator seeded from (seed, step), as tell_tpu folds the step into its
key, so a resumed step draws the same masks. Not ported yet (ROADMAP): the
mesh and multi-host parts, TensorBoard, the profiler window and warm
start.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from ..bridge import init_captioner, tree_map
from ..config import CaptionerConfig
from ..data.bucketing import BucketingConfig, bucket_batches
from ..data.prefetch import DevicePrefetcher
from ..data.records import RecordDataset
from ..models.captioner import captioner_loss, encode_contexts
from .checkpoint import CheckpointManager
from .optimizer import BertAdamState, bert_adam
from .train_step import cast_tree, make_train_step

log = logging.getLogger("tell_tpu_torch.trainer")


@dataclass
class TrainerConfig:
    serialization_dir: str = "runs/default"
    num_epochs: int = 100
    patience: int = 30
    keep_checkpoints: int = 10
    # epochs between checkpoint writes (resume snapshot and best-so-far)
    checkpoint_every: int = 1
    log_every: int = 50
    seed: int = 0
    lr: float = 1e-4
    warmup: float = 0.05
    t_total: int = 437600
    weight_decay: float = 1e-5
    max_grad_norm: float = 0.1
    b1: float = 0.9
    b2: float = 0.98
    # tell_tpu's fields for what the port does not run yet; config_io
    # refuses a value other than these defaults (a mesh of one device,
    # no warm start, the default TensorBoard interval, no profiler window)
    n_data: int | None = None
    n_model: int = 1
    warm_start: str = ""
    summary_interval: int = 512
    profile_steps: int = 0
    profile_at: int = 10


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one train step: a pure function of (seed,
    step), so a resumed run draws the same masks at the same step."""
    state = np.random.SeedSequence([seed + 17, step]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


class Trainer:
    def __init__(self, cfg: CaptionerConfig, tcfg: TrainerConfig,
                 train_batches: Callable[[int], Iterator[dict]],
                 val_batches: Callable[[], Iterator[dict]] | None,
                 frozen: dict | None, *, device):
        """train_batches(epoch) / val_batches() yield fixed-shape numpy
        batches (data/bucketing.py). frozen: {"roberta": params tree,
        "roberta_cfg": RobertaConfig}, moved to `device` and cast to the
        compute dtype once, here, not on every step. device: where training
        runs (explicit: no default that could quietly train on the CPU)."""
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.train_batches = train_batches
        self.val_batches = val_batches
        if frozen is not None:
            frozen = cast_tree(
                tree_map(lambda x: x.to(self.device)
                         if isinstance(x, torch.Tensor) else x, frozen),
                cfg.compute_dtype)
        self.frozen = frozen
        self.optimizer = bert_adam(
            lr=tcfg.lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay,
            max_grad_norm=tcfg.max_grad_norm, t_total=tcfg.t_total,
            warmup=tcfg.warmup)
        self.ckpt = CheckpointManager(
            os.path.join(tcfg.serialization_dir, "checkpoints"),
            keep=tcfg.keep_checkpoints)
        self._step_fn = make_train_step(cfg, self.optimizer)
        self._best_pending: tuple | None = None
        self._stop_requested = False
        self.state: dict = {}
        self.metrics_history: list[dict] = []

    def request_stop(self) -> None:
        """Stop at the next batch boundary and write a resumable checkpoint.
        Thread- and signal-safe: it only sets a flag."""
        self._stop_requested = True

    # -- state -----------------------------------------------------------
    def initialize(self) -> None:
        g = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_captioner(g, self.cfg)
        self.state = {"params": params,
                      "opt": self.optimizer.init(params),
                      "step": 0, "epoch": 0,
                      "best_metric": float("inf"), "bad_epochs": 0}

    def _train_state(self) -> dict:
        return {"params": self.state["params"],
                "opt": self.state["opt"]._asdict()}

    def recover(self) -> bool:
        """Resume from the latest checkpoint; False when there is none."""
        if self.state == {}:
            self.initialize()
        restored = self.ckpt.restore(device=self.device)
        if restored is None:
            return False
        state, meta = restored
        self.state["params"] = state["params"]
        self.state["opt"] = BertAdamState(**state["opt"])
        self.state.update({k: meta[k] for k in
                           ("step", "epoch", "best_metric", "bad_epochs",
                            "batch_cursor") if k in meta})
        log.info("recovered at epoch %d batch %d step %d",
                 self.state["epoch"], self.state.get("batch_cursor", 0),
                 self.state["step"])
        return True

    def _save_best(self) -> None:
        ep, metric = self._best_pending
        self.ckpt.save_best({"params": self.state["params"]},
                            {"epoch": ep, "metric": metric})
        self._best_pending = None

    # -- loops -----------------------------------------------------------
    def train(self) -> dict:
        if self.state == {}:
            self.initialize()
        t = self.tcfg
        self._install_sigterm()
        stop = False
        while self.state["epoch"] < t.num_epochs and not stop:
            epoch = self.state["epoch"]
            em = self._train_epoch(epoch)
            cursor = em.pop("cursor")
            stopped_mid = em.pop("stopped_mid")
            if self._stop_requested:
                # a mid-epoch stop records the batch cursor: the resumed
                # run continues at the NEXT batch of the same order
                if self._best_pending is not None:
                    self._save_best()
                self.ckpt.save(
                    epoch, self._train_state(),
                    {"step": self.state["step"],
                     "epoch": epoch if stopped_mid else epoch + 1,
                     "batch_cursor": cursor if stopped_mid else 0,
                     "best_metric": self.state["best_metric"],
                     "bad_epochs": self.state["bad_epochs"]})
                log.info("stop requested: checkpointed at epoch %d batch %d "
                         "step %d", epoch, cursor, self.state["step"])
                return {"best_metric": self.state["best_metric"],
                        "epochs": epoch, "preempted": True}
            em.update(self._validate())
            em["epoch"] = epoch
            self.metrics_history.append(em)
            self._write_metrics(em)

            metric = em.get("val_loss", em["loss"])
            if metric < self.state["best_metric"]:
                self.state["best_metric"] = metric
                self.state["bad_epochs"] = 0
                self._best_pending = (epoch, metric)
            else:
                self.state["bad_epochs"] += 1
                if self.state["bad_epochs"] >= t.patience:
                    log.info("early stop: no improvement in %d epochs",
                             t.patience)
                    stop = True

            self.state["epoch"] = epoch + 1
            gated = ((epoch + 1) % max(t.checkpoint_every, 1) == 0
                     or self.state["epoch"] >= t.num_epochs or stop)
            if gated:
                if self._best_pending is not None:
                    self._save_best()
                self.ckpt.save(
                    epoch, self._train_state(),
                    {"step": self.state["step"],
                     "epoch": self.state["epoch"],
                     "best_metric": self.state["best_metric"],
                     "bad_epochs": self.state["bad_epochs"]})
        return {"best_metric": self.state["best_metric"],
                "epochs": self.state["epoch"]}

    def _install_sigterm(self) -> None:
        """Route SIGTERM (a preemption notice) to request_stop; main thread
        only, elsewhere callers use request_stop directly."""
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM,
                          lambda signum, frame: self.request_stop())

    def _prefetched(self, batches) -> DevicePrefetcher:
        def host_batches():
            for b in batches:
                b.pop("real", None)
                yield b
        return DevicePrefetcher(host_batches(), self.device)

    def _train_epoch(self, epoch: int) -> dict:
        t0 = time.time()
        losses, skips, tails, sizes = [], [], [], []   # device scalars
        n_batches = n_examples = 0
        stopped_mid = False
        # mid-epoch resume: skip the trained prefix of this epoch's
        # (epoch_index-seeded) order before anything reaches the device
        resume_at = int(self.state.pop("batch_cursor", 0) or 0)
        batches = self.train_batches(epoch)
        if resume_at:
            batches = itertools.islice(batches, resume_at, None)
            log.info("resuming epoch %d at batch %d", epoch, resume_at)
        with self._prefetched(batches) as pf:
            for batch in pf:
                if self._stop_requested:
                    stopped_mid = True
                    break
                gen = step_generator(self.tcfg.seed, self.state["step"],
                                     self.device)
                self.state["params"], self.state["opt"], m = self._step_fn(
                    self.state["params"], self.state["opt"], batch, gen,
                    self.frozen)
                self.state["step"] += 1
                n_batches += 1
                n_examples += int(batch["caption_ids"].shape[0])
                losses.append(m["loss"])
                skips.append(m["skipped"])
                tails.append(m["tail_dropped"])
                sizes.append(m["sample_size"])
                if n_batches % self.tcfg.log_every == 0:
                    log.info("epoch %d step %d loss %.4f", epoch,
                             self.state["step"], float(m["loss"]))
        # one host sync per epoch, not per step
        losses = np.asarray([float(x) for x in losses])
        ok = np.isfinite(losses)
        mean = float(losses[ok].mean()) if ok.any() else float("nan")
        tail_dropped = int(sum(int(x) for x in tails))
        n_tokens = int(sum(int(x) for x in sizes))
        tail_frac = tail_dropped / n_tokens if n_tokens else 0.0
        if tail_frac > 1e-3:
            log.warning(
                "epoch %d: adaptive-softmax tail capacity dropped %d/%d "
                "tokens (%.3f%%) to head-only loss; raise "
                "tail_capacity_frac", epoch, tail_dropped, n_tokens,
                100.0 * tail_frac)
        dt = time.time() - t0
        return {"loss": mean, "batches": n_batches,
                "skipped": int(sum(int(x) for x in skips)),
                "tail_dropped": tail_dropped, "tail_dropped_frac": tail_frac,
                "examples": n_examples,
                "examples_per_sec": n_examples / dt if dt > 0 else 0.0,
                "epoch_seconds": dt,
                "cursor": resume_at + n_batches, "stopped_mid": stopped_mid}

    @torch.no_grad()
    def _validate(self) -> dict:
        """Mean deterministic loss over val_batches. The frozen encode runs
        in the compute dtype and the loss on the fp32 params, as tell_tpu's
        eval does (its bf16 hiddens promote to fp32 at the first
        projection); no weight dropout, so kernel C runs."""
        if self.val_batches is None:
            return {}
        losses = []
        with self._prefetched(self.val_batches()) as pf:
            for batch in pf:
                if self.frozen is not None:
                    batch = encode_contexts(self.frozen, self.cfg, batch)
                batch = tree_map(lambda x: x.float()
                                 if isinstance(x, torch.Tensor)
                                 and x.is_floating_point() else x, batch)
                loss, _ = captioner_loss(self.state["params"], self.cfg,
                                         batch)
                losses.append(loss)
        return ({"val_loss": float(torch.stack(losses).mean())}
                if losses else {})

    def _write_metrics(self, em: dict) -> None:
        os.makedirs(self.tcfg.serialization_dir, exist_ok=True)
        path = os.path.join(self.tcfg.serialization_dir, "metrics.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(em) + "\n")


def make_trainer(cfg: CaptionerConfig, tcfg: TrainerConfig,
                 bcfg: BucketingConfig, shards_dir: str,
                 frozen: dict | None, *, device) -> Trainer:
    """A Trainer over shards_dir/train-*.npz (shuffled, in an order that is
    a pure function of the dataset seed and the epoch) and
    shards_dir/valid-*.npz (in shard order)."""
    train_ds = RecordDataset(os.path.join(shards_dir, "train-*.npz"))
    val_ds = RecordDataset(os.path.join(shards_dir, "valid-*.npz"))

    def train_batches(epoch):
        return bucket_batches(train_ds.epoch(epoch_index=epoch, lazy=True),
                              bcfg)

    def val_batches():
        return bucket_batches(val_ds.epoch(lazy=True), bcfg)

    return Trainer(cfg, tcfg, train_batches, val_batches, frozen,
                   device=device)


def train_from_shards(cfg: CaptionerConfig, tcfg: TrainerConfig,
                      bcfg: BucketingConfig, shards_dir: str,
                      frozen: dict | None, recover: bool = False, *,
                      device) -> dict:
    """`tnt train`'s sequence without YAML: build the Trainer over the
    shards, recover first when asked (raising when there is nothing to
    recover, as `tnt train --recover` fails), then train."""
    trainer = make_trainer(cfg, tcfg, bcfg, shards_dir, frozen,
                           device=device)
    if recover and not trainer.recover():
        raise FileNotFoundError(f"no checkpoint to recover in "
                                f"{tcfg.serialization_dir}")
    return trainer.train()
