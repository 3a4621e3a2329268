"""The port's TensorBoard writer (tell_tpu_torch/training/tensorboard.py)
against tell_tpu's: the crc32c known answer, events files equal byte for
byte for the same scalars at a fixed wall time, and read_events equal to
the independent decoder of tests/test_tensorboard.py.
"""
import glob
import time

import numpy as np
import pytest

from tell_tpu.training import tensorboard as jtb
from tell_tpu_torch.training import tensorboard as ttb
from tests.test_tensorboard import read_events as reference_read_events


def test_crc32c_known_answer():
    assert ttb._crc32c(b"123456789") == 0xE3069283     # RFC 3720
    assert ttb._crc32c(b"") == 0
    data = bytes(range(256)) * 3
    assert ttb._masked_crc(data) == jtb._masked_crc(data)


def _write(module, logdir):
    w = module.TensorBoardWriter(str(logdir))
    w.add_scalar("train/loss", 2.5, step=512)
    w.add_scalars({"epoch/loss": 1.25, "epoch/val_loss": np.float32(1.5),
                   "epoch/skipped": 0, "epoch/examples_per_sec": 1e9 / 7},
                  step=1024)
    w.add_scalars({"bad": float("nan"), "note": "str"}, step=3)  # dropped
    w.add_scalar("train/loss", 0.1, step=2 ** 40, wall_time=12345.678)
    w.close()
    (path,) = glob.glob(str(logdir / "events.out.tfevents.*"))
    return path


def test_events_equal_jax_byte_for_byte(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    ours = _write(ttb, tmp_path / "torch")
    theirs = _write(jtb, tmp_path / "jax")
    assert ours.rsplit("/", 1)[1] == theirs.rsplit("/", 1)[1]
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    events = ttb.read_events(ours)
    assert events == reference_read_events(ours)
    assert [e.get("step") for e in events] == [None, 512, 1024, 2 ** 40]
    assert events[0]["file_version"] == "brain.Event:2"
    assert events[2]["scalars"]["epoch/val_loss"] == 1.5
    assert events[3]["wall_time"] == 12345.678


def test_read_events_refuses_a_bad_crc(tmp_path):
    path = _write(ttb, tmp_path)
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        ttb.read_events(path)
