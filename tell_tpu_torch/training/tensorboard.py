"""Minimal TensorBoard event-file writer, no tensorboard dependency (a copy
of tell_tpu/training/tensorboard.py, plus read_events, its reader).

The trainer logs scalars here (train/loss every summary_interval steps and
the epoch's metrics as epoch/<name>), as the reference's
log_to_tensorboard callback did (summary_interval 512). The module writes
`events.out.tfevents.*` files that a stock TensorBoard loads, by emitting
the TFRecord framing and the Event/Summary protobuf wire format directly
(scalars only). Standard library only.

File format (TFRecord): for each record
    uint64 length (LE) | uint32 masked_crc32c(length bytes) |
    data bytes         | uint32 masked_crc32c(data)
where crc32c is the Castagnoli CRC and masking is TensorFlow's
rot-right-15 + 0xa282ead8.

Proto wire layout used (field numbers from tensorflow/core/util/event.proto
and framework/summary.proto):
    Event   { 1: double wall_time; 2: int64 step;
              3: bytes file_version; 5: Summary summary }
    Summary { 1: repeated Value }
    Value   { 1: string tag; 2: float simple_value }
"""
from __future__ import annotations

import os
import socket
import struct
import time

# -- crc32c (Castagnoli, reflected poly 0x82F63B78) -------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire encoding --------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        # proto wire rule: negatives are 10-byte two's-complement varints;
        # nothing we encode (steps, lengths, field keys) is ever negative,
        # and Python's arithmetic >> would loop forever on -1
        raise ValueError(f"negative varint: {n}")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _encode_event(wall_time: float, step: int | None = None,
                  file_version: str | None = None,
                  scalars: dict[str, float] | None = None) -> bytes:
    ev = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step is not None:
        ev += _varint(2 << 3 | 0) + _varint(step)
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(1, _field_bytes(1, tag.encode())
                         + _varint(2 << 3 | 5) + struct.pack("<f", val))
            for tag, val in scalars.items())
        ev += _field_bytes(5, summary)
    return ev


class TensorBoardWriter:
    """Append-only scalar writer; one events file per instance.

    Usage mirrors the slice of SummaryWriter the reference callback used:
        w = TensorBoardWriter(logdir); w.add_scalar("loss", 0.5, step=10)
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write_record(_encode_event(time.time(),
                                         file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float | None = None) -> None:
        self.add_scalars({tag: value}, step, wall_time)

    def add_scalars(self, scalars: dict[str, float], step: int,
                    wall_time: float | None = None) -> None:
        """One Event carrying every tag (one record per logging call)."""
        import numbers
        clean = {t: float(v) for t, v in scalars.items()
                 if isinstance(v, numbers.Real) and v == v}  # drop NaN/str
        # numbers.Real admits numpy float32/bfloat16 scalars, which a plain
        # (int, float) isinstance silently dropped
        if not clean:
            return
        self._write_record(_encode_event(
            wall_time if wall_time is not None else time.time(),
            step=step, scalars=clean))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# -- reading back (checks, tools) ---------------------------------------------

def _read_varint(buf: bytes, off: int) -> tuple[int, int]:
    val = shift = 0
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return val, off


def _fields(buf: bytes):
    """(field number, value) pairs of one protobuf message: varints as
    int, fixed64 as double, fixed32 as float, length-delimited as bytes."""
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        wire = key & 7
        if wire == 0:
            val, off = _read_varint(buf, off)
        elif wire == 1:
            (val,) = struct.unpack_from("<d", buf, off)
            off += 8
        elif wire == 2:
            n, off = _read_varint(buf, off)
            val = buf[off:off + n]
            off += n
        elif wire == 5:
            (val,) = struct.unpack_from("<f", buf, off)
            off += 4
        else:
            raise ValueError(f"unexpected wire type {wire}")
        yield key >> 3, val


def read_events(path: str) -> list[dict]:
    """The events of a file written by TensorBoardWriter, each {"wall_time",
    "scalars": {tag: value}} with "step" where it has one and
    "file_version" on the first; raises on a CRC that does not match."""
    with open(path, "rb") as f:
        data = f.read()
    events, off = [], 0
    while off < len(data):
        header = data[off:off + 8]
        (n,) = struct.unpack("<Q", header)
        rec = data[off + 12:off + 12 + n]
        crcs = struct.unpack_from("<II", data[off + 8:off + 12]
                                  + data[off + 12 + n:off + 16 + n])
        if crcs != (_masked_crc(header), _masked_crc(rec)):
            raise ValueError(f"{path}: CRC mismatch at byte {off}")
        off += 16 + n
        ev = {"scalars": {}}
        for num, val in _fields(rec):
            if num == 1:
                ev["wall_time"] = val
            elif num == 2:
                ev["step"] = val
            elif num == 3:
                ev["file_version"] = val.decode()
            elif num == 5:
                for _, value in _fields(val):
                    v = dict(_fields(value))
                    ev["scalars"][v[1].decode()] = v.get(2, 0.0)
        events.append(ev)
    return events
