"""The port's JPEG decoder (csrc/host/jpeg.cpp) through ctypes.

tell_tpu decodes images through Pillow; the port has no Pillow, so it
decodes news photos itself, to the bytes Pillow gives on its
libjpeg-turbo build: ``decode_jpeg(data)`` equals
``np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))``. The C++ is
compiled with g++ into tell_tpu_torch/build/ at the first call (never at
import), under a name keyed on a hash of the source and flags, as
data/native.py builds native/*.cpp; a failed build raises with the
compiler's output, and there is no other decoder.

Decoded: baseline, extended-sequential and progressive Huffman JPEG,
8-bit, grey, YCbCr or RGB-coded three-component files, and CMYK or YCCK
four-component ones (as Pillow opens them: mode CMYK, read with Adobe
polarity, then its own CMYK -> RGB), each plane at 4:4:4, 4:2:2, 4:2:0,
4:1:1 or 4:4:0, with or without restart intervals. Refused with a
NotPortedError (a ValueError) that names the form: arithmetic, lossless
and hierarchical JPEG, 12-bit samples, other samplings, 2-component
files, a progressive file whose scans leave any of its first ten
coefficients unrefined (libjpeg smooths those blocks), and PNG or any
other format (data/images.py's decode_image routes PNG to data/png.py)
(ROADMAP queue 1 item 8). Status codes of the C ABI: 0 decoded, 1 a
refused form, 2 data that ends early or does not decode, 3 an output
buffer too small, 4 a frame above Pillow's decompression-bomb limit
(178956970 pixels, where tell_tpu's Image.open raises); 2 and 4 raise a
ValueError.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..config import NotPortedError
from .native import BUILD_DIR, compile_shared

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "jpeg.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
ITEM = "ROADMAP queue 1 item 8"

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


def load_library(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (first call only) and load the decoder; raises on failure."""
    build_dir = Path(build_dir)
    with _lock:
        lib = _libs.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(str(compile_shared(
                [SOURCE], [], CXX_FLAGS, build_dir, "libtnt_jpeg")))
            buf, i64 = ctypes.c_char_p, ctypes.c_int64
            lib.tnt_jpeg_info.restype = ctypes.c_int
            lib.tnt_jpeg_info.argtypes = [
                buf, i64, ctypes.POINTER(ctypes.c_int32), buf, ctypes.c_int]
            lib.tnt_jpeg_decode.restype = ctypes.c_int
            lib.tnt_jpeg_decode.argtypes = [buf, i64, ctypes.c_void_p, i64,
                                            buf, ctypes.c_int]
            _libs[build_dir] = lib
    return lib


def _raise(code: int, err) -> None:
    msg = err.value.decode(errors="replace")
    if code == 1:
        raise NotPortedError(f"{msg}: a JPEG form the port does not decode "
                             f"({ITEM})")
    if code == 4:
        raise ValueError(f"refused: {msg}")
    raise ValueError(f"corrupt or truncated JPEG ({msg}); the port's "
                     f"decoder takes no other data ({ITEM})")


def jpeg_info(data: bytes) -> dict:
    """The frame header: {"height", "width", "components", "progressive"};
    raises as decode_jpeg does for a refused or corrupt header."""
    lib = load_library()
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    info = (ctypes.c_int32 * 4)()
    code = lib.tnt_jpeg_info(data, len(data), info, err, len(err))
    if code:
        _raise(code, err)
    return {"height": info[0], "width": info[1], "components": info[2],
            "progressive": bool(info[3])}


def decode_jpeg(data: bytes) -> np.ndarray:
    """Encoded JPEG bytes -> uint8 [H, W, 3] RGB."""
    lib = load_library()
    data = bytes(data)
    info = jpeg_info(data)
    err = ctypes.create_string_buffer(256)
    out = np.empty((info["height"], info["width"], 3), np.uint8)
    code = lib.tnt_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes,
                               err, len(err))
    if code:
        _raise(code, err)
    return out
