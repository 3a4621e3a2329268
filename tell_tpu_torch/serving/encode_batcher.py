"""Batched article encode in front of the decode engine (tell_tpu/serving/
encode_batcher.py, carried over: importing it from tell_tpu would run
tell_tpu/serving/__init__.py, which imports the JAX server).

Concurrent requests' packed feature payloads coalesce into one encode of
up to `max_batch` rows (a MicroBatcher drains the queue with a short
linger), padded up to a power-of-two row ladder (1, 2, 4, ..., max_batch)
so the encode sees a handful of shapes; each request's slice of the
encoded features is handed to the engine through `submit_fn` on the
batcher thread, and the caller gets back the engine's future (plus its
encoded features).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .batcher import MicroBatcher


def _ladder(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    p = 1
    while p < n and p < max_batch:
        p *= 2
    return min(p, max_batch)


class EncodeBatcher:
    """encode_many(batch[B, ...]) -> encoded feature dict with leading B;
    submit_fn(enc1) -> downstream Future (e.g. DecodeEngine.submit).

    `__call__(payload)` blocks until the payload's encode ran and returns
    (downstream_future, enc1): the encode is batched across concurrent
    callers, the downstream future resolves when the decode does."""

    def __init__(self, encode_many: Callable[[dict], dict],
                 submit_fn: Callable[[dict], object],
                 max_batch: int = 8, max_wait_ms: float = 2.0):
        self.encode_many = encode_many
        self.submit_fn = submit_fn
        self.max_batch = max(1, max_batch)
        self._mb = MicroBatcher(self._run, max_batch=self.max_batch,
                                max_wait_ms=max_wait_ms)

    def _run(self, payloads: list[dict]) -> list:
        n = len(payloads)
        padded = _ladder(n, self.max_batch)
        stacked = {}
        for k in payloads[0]:
            rows = [np.asarray(p[k]) for p in payloads]
            if padded > n:   # shape-pad rows: discarded after the split
                rows.append(np.zeros((padded - n,) + rows[0].shape[1:],
                                     rows[0].dtype))
            stacked[k] = np.concatenate(rows, axis=0)
        enc = self.encode_many(stacked)
        out = []
        for i in range(n):
            enc1 = {k: v[i:i + 1] for k, v in enc.items()}
            out.append((self.submit_fn(enc1), enc1))
        return out

    def __call__(self, payload: dict):
        return self._mb(payload)

    def warmup_sizes(self) -> list[int]:
        """The padded row counts live traffic can hit."""
        sizes, p = [], 1
        while p < self.max_batch:
            sizes.append(p)
            p *= 2
        sizes.append(self.max_batch)
        return sizes

    def shutdown(self):
        self._mb.shutdown()
