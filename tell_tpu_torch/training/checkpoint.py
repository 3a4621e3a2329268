"""Checkpoints in a torch format (counterpart of
tell_tpu/training/checkpoint.py, which writes orbax).

A checkpoint is a directory `ckpt-<tag>/` (or `best/`) holding state.pt,
the train-state tree of tensors written with torch.save, and meta.json
(step, epoch, batch_cursor, best_metric, bad_epochs). A save writes both
into a temporary directory and renames it into place, so a reader never
sees a half-written checkpoint; the last `keep` numbered checkpoints are
kept. restore(device=...) loads with weights_only=True onto the given
device; a checkpoint directory without state.pt (tell_tpu's orbax form)
is refused, naming migrate/orbax_to_torch.py.

Saves are asynchronous by default, as tell_tpu's: save() returns once the
state is staged to host memory (a copy: the optimizer updates the
parameters in place, so the next step would race a writer still reading
them), and torch.save, meta.json, the rename and the keep-N GC run on one
worker thread behind the next epoch. At most one save is in flight (a new
save waits out the previous one), restore() and list() flush first, and
flush() is the barrier: it waits for the in-flight save and re-raises its
error, so no failed save goes unseen. A synchronous save is save()
followed by flush().
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from ..bridge import tree_map
from ..config import orbax_refusal


def _stage(state: dict) -> dict:
    """A host copy of the tree's tensors (a device-to-host copy from the
    card, a clone on the CPU), detached from what training goes on to
    update in place."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x, state)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 10):
        self.dir = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)
        self._worker = ThreadPoolExecutor(1, "checkpoint")
        self._pending: Future | None = None

    def _path(self, tag) -> str:
        return os.path.join(self.dir, "best" if tag == "best"
                            else f"ckpt-{tag}")

    def flush(self) -> None:
        """Wait for the in-flight save; raise what it raised. Idempotent."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def _write(self, path: str, host: dict, metadata: dict | None,
               gc: bool) -> None:
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(host, os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(metadata or {}, f)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        old = f"{path}.old-{os.getpid()}"
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
        if gc:
            tags = self._tags()
            for tag in tags[:max(0, len(tags) - self.keep)]:
                shutil.rmtree(self._path(tag), ignore_errors=True)

    def _save(self, path: str, state: dict, metadata: dict | None,
              gc: bool) -> None:
        self.flush()                       # one save in flight at a time
        self._pending = self._worker.submit(self._write, path,
                                            _stage(state), metadata, gc)

    def save(self, tag, state: dict, metadata: dict | None = None) -> None:
        self._save(self._path(tag), state, metadata, gc=True)

    def save_best(self, state: dict, metadata: dict | None = None) -> None:
        self._save(self._path("best"), state, metadata, gc=False)

    def restore(self, tag=None, device="cpu") -> tuple[dict, dict] | None:
        """Restore `tag` (or the latest numbered checkpoint) onto `device`.
        Returns (state, metadata) or None."""
        if tag is None:
            tags = self.list()
            if not tags:
                return None
            tag = tags[-1]
        self.flush()
        path = self._path(tag)
        if not os.path.exists(path):
            return None
        if not os.path.exists(os.path.join(path, "state.pt")):
            raise orbax_refusal(path, "run", os.path.dirname(self.dir))
        state = torch.load(os.path.join(path, "state.pt"),
                           map_location=device, weights_only=True)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return state, meta

    def list(self) -> list[int]:
        self.flush()
        return self._tags()

    def _tags(self) -> list[int]:
        return sorted(int(name[5:]) for name in os.listdir(self.dir)
                      if name.startswith("ckpt-") and name[5:].isdigit())
