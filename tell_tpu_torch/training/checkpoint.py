"""Checkpoints in a torch format (counterpart of
tell_tpu/training/checkpoint.py, which writes orbax).

A checkpoint is a directory `ckpt-<tag>/` (or `best/`) holding state.pt,
the train-state tree of tensors written with torch.save, and meta.json
(step, epoch, batch_cursor, best_metric, bad_epochs). A save writes both
into a temporary directory and renames it into place, so a reader never
sees a half-written checkpoint; the last `keep` numbered checkpoints are
kept. Saves are synchronous (tell_tpu overlaps them with the next epoch;
that is not ported yet). restore(device=...) loads with
weights_only=True onto the given device.
"""
from __future__ import annotations

import json
import os
import shutil

import torch

from ..bridge import tree_map


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 10):
        self.dir = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, tag) -> str:
        return os.path.join(self.dir, "best" if tag == "best"
                            else f"ckpt-{tag}")

    def _save(self, path: str, state: dict, metadata: dict | None) -> None:
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        host = tree_map(lambda x: x.detach().cpu()
                        if isinstance(x, torch.Tensor) else x, state)
        torch.save(host, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(metadata or {}, f)
        old = f"{path}.old-{os.getpid()}"
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)

    def save(self, tag, state: dict, metadata: dict | None = None) -> None:
        self._save(self._path(tag), state, metadata)
        self._gc()

    def save_best(self, state: dict, metadata: dict | None = None) -> None:
        self._save(self._path("best"), state, metadata)

    def restore(self, tag=None, device="cpu") -> tuple[dict, dict] | None:
        """Restore `tag` (or the latest numbered checkpoint) onto `device`.
        Returns (state, metadata) or None."""
        if tag is None:
            tags = self.list()
            if not tags:
                return None
            tag = tags[-1]
        path = self._path(tag)
        if not os.path.exists(path):
            return None
        state = torch.load(os.path.join(path, "state.pt"),
                           map_location=device, weights_only=True)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return state, meta

    def list(self) -> list[int]:
        tags = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt-") and name[5:].isdigit():
                tags.append(int(name[5:]))
        return sorted(tags)

    def _gc(self) -> None:
        tags = self.list()
        for tag in tags[:max(0, len(tags) - self.keep)]:
            shutil.rmtree(self._path(tag), ignore_errors=True)
