"""Sharded record storage for preprocessed examples (counterpart of
tell_tpu/data/records.py).

One shard is one uncompressed .npz whose members are "<idx>/<field>";
variable-length fields stay ragged, and the bucketing layer pads them to
fixed shapes at batch time. The format is tell_tpu's, so either package
reads the other's shards. RecordDataset reads them through the C++ reader
of native/npz.cpp (data/native.py) unless the caller asks for the Python
ShardReader (use_native=False).
"""
from __future__ import annotations

import glob as globlib
import os
from typing import Iterator

import numpy as np

from .native import native_shard_reader


def _npy_header(zf, member: str) -> tuple[tuple, np.dtype]:
    """(shape, dtype) of one .npy member of an open zip, from its header
    alone."""
    fmt = np.lib.format
    with zf.open(member) as f:
        major, _ = fmt.read_magic(f)
        read = (fmt.read_array_header_1_0 if major == 1
                else fmt.read_array_header_2_0)
        shape, _, dtype = read(f)
    return tuple(shape), dtype


def write_shard(path: str, examples: list[dict]) -> None:
    """Write examples (dicts of arrays; None values skipped) to one shard,
    atomically by rename."""
    arrays: dict[str, np.ndarray] = {"__len__": np.asarray(len(examples))}
    for i, ex in enumerate(examples):
        for k, v in ex.items():
            if v is not None:
                arrays[f"{i}/{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


class ShardReader:
    """Lazy npz shard access: the index (length, field names, and each
    member's shape and dtype from its .npy header) is read once with the
    file closed again; the handle reopens on first access, and
    RecordDataset bounds how many stay open."""

    native = False       # no shard mapping for native.gather_pad

    def __init__(self, path: str):
        self.path = path
        self._z = None
        # (example, field) -> (shape, dtype)
        self._headers: dict[tuple[int, str], tuple[tuple, np.dtype]] = {}
        self._fields: dict[int, list[str]] = {}
        with np.load(path, allow_pickle=False) as z:
            self._len = int(z["__len__"])
            for key in z.files:
                if key != "__len__":
                    idx, field = key.split("/", 1)
                    self._fields.setdefault(int(idx), []).append(field)
                    self._headers[(int(idx), field)] = _npy_header(
                        z.zip, key + ".npy")

    def open(self) -> None:
        if self._z is None:
            self._z = np.load(self.path, allow_pickle=False)

    def close(self) -> None:
        if self._z is not None:
            self._z.close()
            self._z = None

    def __len__(self) -> int:
        return self._len

    def fields_of(self, i: int) -> list[str]:
        return self._fields.get(i, [])

    def field_shape(self, i: int, field: str) -> tuple | None:
        h = self._headers.get((i, field))
        return h[0] if h is not None else None

    def field_dtype(self, i: int, field: str):
        h = self._headers.get((i, field))
        return h[1] if h is not None else None

    def read_field(self, i: int, field: str):
        self.open()
        v = self._z[f"{i}/{field}"]
        return str(v) if v.dtype.kind == "U" and v.ndim == 0 else v

    def __getitem__(self, i: int) -> dict:
        return {f: self.read_field(i, f) for f in self.fields_of(i)}


class LazyExample:
    """Dict-like view of one example that reads a field when it is
    accessed. Lengths, dtypes and shapes come from the .npy headers that
    the reader parsed at open, without reading data; over a
    NativeShardReader (reader.native) the batch packer gathers fields
    straight from the shard mapping (native.gather_pad)."""

    __slots__ = ("reader", "i")

    def __init__(self, reader, i: int):
        self.reader = reader
        self.i = i

    def keys(self) -> list[str]:
        return self.reader.fields_of(self.i)

    def __contains__(self, field: str) -> bool:
        return field in self.keys()

    def __getitem__(self, field: str):
        return self.reader.read_field(self.i, field)

    def get(self, field: str, default=None):
        return self[field] if field in self else default

    def field_len(self, field: str) -> int:
        """Leading dimension, from the header."""
        shp = self.field_shape(field)
        if shp is None:
            raise KeyError(field)
        return shp[0] if shp else 0

    def field_shape(self, field: str) -> tuple | None:
        return self.reader.field_shape(self.i, field)

    def field_dtype(self, field: str):
        return self.reader.field_dtype(self.i, field)

    def field_member(self, field: str):
        """(open mmap handle, member index) over a native reader."""
        return self.reader.field_member(self.i, field)

    @property
    def native(self) -> bool:
        return self.reader.native

    def materialize(self) -> dict:
        return self.reader[self.i]


class RecordDataset:
    """A set of shards with seeded epoch shuffling at example granularity,
    strided over data-parallel ranks. (tell_tpu's persistent-RandomState
    shuffle has no caller in the port.) use_native=False reads through
    the Python ShardReader instead of the C++ one."""

    def __init__(self, pattern: str | list[str], seed: int = 1234,
                 use_native: bool = True):
        paths = (sorted(globlib.glob(pattern))
                 if isinstance(pattern, str) else list(pattern))
        if not paths:
            raise FileNotFoundError(f"no shards match {pattern}")
        self.readers = [native_shard_reader(p, use_native) for p in paths]
        self.index = [(s, i) for s, r in enumerate(self.readers)
                      for i in range(len(r))]
        self.seed = seed
        self._open_lru: list[int] = []   # bounded set of open shard handles
        self._max_open = 64

    def __len__(self) -> int:
        return len(self.index)

    def epoch(self, epoch_index: int | None = None,
              lazy: bool = False, limit: int | None = None,
              process_index: int = 0, process_count: int = 1) -> Iterator:
        """Examples in shard order (epoch_index None, as for validation) or
        shuffled in an order that is a pure function of (seed,
        epoch_index), the same as tell_tpu's epoch(epoch_index=...): a
        resumed run reproduces an epoch's order without replaying earlier
        epochs. lazy yields LazyExample views; limit keeps the first
        `limit` examples of the order. process_index / process_count
        stride the order over data-parallel ranks, cut first to a
        multiple of process_count so every rank yields as many examples
        (tell_tpu's epoch, records.py:174-203)."""
        order = np.arange(len(self.index))
        if epoch_index is not None:
            np.random.RandomState(
                [self.seed & 0xFFFFFFFF, epoch_index]).shuffle(order)
        if limit is not None:
            order = order[:limit]
        if process_count > 1:
            usable = len(order) - len(order) % process_count
            order = order[process_index:usable:process_count]
        for o in order:
            s, i = self.index[o]
            if s not in self._open_lru:
                self._open_lru.append(s)
                if len(self._open_lru) > self._max_open:
                    self.readers[self._open_lru.pop(0)].close()
            yield (LazyExample(self.readers[s], i) if lazy
                   else self.readers[s][i])
