"""Host-to-device prefetch (counterpart of tell_tpu/data/prefetch.py).

A background thread packs the next batches on the host while the card
runs the current step, and hands them out DEPTH steps ahead. On a CUDA
device each numpy array goes through pinned memory and a non_blocking
copy on the current stream, which the step's kernels are ordered after.
Used as a context manager, it releases the queued batches when the
consumer stops early (a stop request, an error).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

_END = object()
DEPTH = 2   # batches queued ahead of the step: double buffering


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays -> tensors on `device` (pinned + non_blocking on CUDA);
    other values pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        else:
            out[k] = v
    return out


class DevicePrefetcher:
    """Iterate `batches` (dicts of numpy arrays), move each to `device` in a
    background thread, and keep at most DEPTH of them queued."""

    def __init__(self, batches: Iterator[dict], device):
        self._q: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._err: BaseException | None = None
        self._done = False
        self._stop = threading.Event()
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # the worker thread's current device is not the caller's
            device = torch.device("cuda", torch.cuda.current_device())

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                for batch in batches:
                    if self._stop.is_set() or not put(to_device(batch,
                                                                device)):
                        return
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                put(_END)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self) -> None:
        """Stop the worker and release the queued device batches."""
        self._stop.set()
        self._done = True
        self._drain()
        self._thread.join(timeout=5)
        # a worker blocked in put() can slip one more batch into the slot
        # the drain freed: drain again after the join
        self._drain()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _END:
            self._done = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
