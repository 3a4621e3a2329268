"""The training loop on one device (counterpart of
tell_tpu/training/trainer.py) and its entry point, train_from_shards
(the sequence `tnt train` runs: RecordDataset over train-*.npz and
valid-*.npz, bucket_batches with an epoch_index-seeded order, then
Trainer.train, or Trainer.recover first).

Kept from tell_tpu: the epoch loop, validation and patience, best and
keep-N checkpoints every `checkpoint_every` epochs (saved asynchronously,
flushed before train() returns), request_stop / SIGTERM with a mid-epoch
batch_cursor so a resumed run is step-exact, the tail-capacity overflow
warning, metrics.jsonl, TensorBoard scalars under <serialization_dir>/tb
(train/loss every `summary_interval` steps, the epoch's metrics as
epoch/<name>), warm start from a checkpoint's params and the profiler
window. Dropout draws from a generator seeded from (seed, step), as
tell_tpu folds the step into its key, so a resumed step draws the same
masks. Not ported yet (ROADMAP queue 1 item 10): the mesh and multi-host
parts.

The profiler window is PyTorch's idiom for tell_tpu's jax.profiler trace:
steps [profile_at, profile_at + profile_steps) run under torch.profiler
(CPU, and CUDA activities on the card), each step marked
"train_step:<step>", and the chrome trace goes to
<serialization_dir>/profile/trace-<profile_at>.json. As tell_tpu's, the
window closes at the end of its epoch's steps at the latest (a window
that would cross it is cut there, and holds no validation), in a finally
that also closes it when the epoch fails inside it.
"""
from __future__ import annotations

import contextlib
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
from ..config import CaptionerConfig, NotPortedError, orbax_refusal
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
    # a mesh (tell_tpu's fields; config_io refuses one of more than one
    # device: ROADMAP queue 1 item 10)
    n_data: int | None = None
    n_model: int = 1
    # a checkpoint directory (the one holding state.pt) whose params the
    # fresh init takes, e.g. a trained captioner for the pointer models
    warm_start: str = ""
    # TensorBoard scalars under <serialization_dir>/tb at this step
    # interval (0 = none)
    summary_interval: int = 512
    # torch.profiler over steps [profile_at, profile_at + profile_steps)
    # into <serialization_dir>/profile
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
        self._tb = None
        self._profiler = None
        self._best_pending: tuple | None = None
        self._stop_requested = False
        self.state: dict = {}
        self.metrics_history: list[dict] = []

    def request_stop(self) -> None:
        """Stop at the next batch boundary and write a resumable checkpoint.
        Thread- and signal-safe: it only sets a flag."""
        self._stop_requested = True

    @property
    def tb(self):
        """The TensorBoard writer, made at its first use (one events file
        per trainer); None when summary_interval is 0."""
        if self._tb is None and self.tcfg.summary_interval:
            from .tensorboard import TensorBoardWriter
            self._tb = TensorBoardWriter(
                os.path.join(self.tcfg.serialization_dir, "tb"))
        return self._tb

    # -- state -----------------------------------------------------------
    def initialize(self) -> None:
        g = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_captioner(g, self.cfg)
        if self.tcfg.warm_start:
            params = self._warm_start(params)
        self.state = {"params": params,
                      "opt": self.optimizer.init(params),
                      "step": 0, "epoch": 0,
                      "best_metric": float("inf"), "bad_epochs": 0}

    def _warm_start(self, params: dict) -> dict:
        """The params of the checkpoint at tcfg.warm_start, on the device,
        in place of the fresh init's; they must have its tree and
        shapes."""
        path = os.path.abspath(self.tcfg.warm_start)
        state_pt = os.path.join(path, "state.pt")
        if not os.path.exists(state_pt):
            err = orbax_refusal(path, "run", os.path.dirname(
                os.path.dirname(path)))
            raise NotPortedError(f"warm_start: {err}")
        # on the host first: a numbered checkpoint also holds the
        # optimizer's moments, which stay off the card
        saved = torch.load(state_pt, map_location="cpu",
                           weights_only=True)["params"]
        want = tree_map(lambda x: (x.shape, x.dtype), params)
        got = tree_map(lambda x: (x.shape, x.dtype), saved)
        if got != want:
            raise ValueError(f"warm_start: the params in {state_pt} do not "
                             "have this model's tree, shapes and dtypes")
        log.info("warm-started from %s", path)
        return tree_map(lambda x: x.to(self.device), saved)

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
        self._install_sigterm()
        result = self._train()
        self.ckpt.flush()            # the async save barrier
        return result

    def _train(self) -> dict:
        t = self.tcfg
        stop = False
        while self.state["epoch"] < t.num_epochs and not stop:
            epoch = self.state["epoch"]
            try:
                em = self._train_epoch(epoch)
            finally:
                # the profiler window closes with its epoch's steps, as
                # tell_tpu's does, also when the epoch fails inside it
                self._stop_profile()
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
            if self.tb is not None:
                self.tb.add_scalars({f"epoch/{k}": v for k, v in em.items()
                                     if k != "epoch"}, self.state["step"])

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

    def _start_profile(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()

    def _stop_profile(self) -> None:
        """Close the window and write its chrome trace (no-op when none is
        open)."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = os.path.join(self.tcfg.serialization_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(out, f"trace-{self.tcfg.profile_at}.json"))

    def _step(self, batch) -> dict:
        """One train step, inside the profiler window where it falls in
        [profile_at, profile_at + profile_steps)."""
        t, step = self.tcfg, self.state["step"]
        if t.profile_steps and step == t.profile_at:
            self._start_profile()
        gen = step_generator(t.seed, step, self.device)
        with (torch.profiler.record_function(f"train_step:{step}")
              if self._profiler is not None else contextlib.nullcontext()):
            self.state["params"], self.state["opt"], m = self._step_fn(
                self.state["params"], self.state["opt"], batch, gen,
                self.frozen)
        self.state["step"] = step + 1
        if (self._profiler is not None
                and step + 1 >= t.profile_at + t.profile_steps):
            self._stop_profile()
        return m

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
                m = self._step(batch)
                n_batches += 1
                n_examples += int(batch["caption_ids"].shape[0])
                losses.append(m["loss"])
                skips.append(m["skipped"])
                tails.append(m["tail_dropped"])
                sizes.append(m["sample_size"])
                if n_batches % self.tcfg.log_every == 0:
                    log.info("epoch %d step %d loss %.6f", epoch,
                             self.state["step"], float(m["loss"]))
                si = self.tcfg.summary_interval
                if si and self.state["step"] % si == 0:
                    # float() syncs once per interval, as the log line does
                    self.tb.add_scalar("train/loss", float(m["loss"]),
                                       self.state["step"])
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
