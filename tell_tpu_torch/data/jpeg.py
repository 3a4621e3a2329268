"""The port's JPEG decoder (csrc/host/jpeg.cpp) and encoder
(csrc/host/jpeg_encode.cpp) through ctypes.

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

The encoder writes what the dataset build saves: ``encode_jpeg(rgb)``
equals the bytes of ``Image.fromarray(rgb).save(f, "JPEG")`` (Pillow's
defaults: quality 75, 4:2:0, JFIF 1.01, the standard Huffman tables), and
``encode_jpeg(rgb, comment)`` those of an image whose ``info["comment"]``
Pillow writes as a COM marker. It has no other options.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..config import NotPortedError
from .native import BUILD_DIR, compile_shared

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "jpeg.cpp"
ENCODER_SOURCE = SOURCE.with_name("jpeg_encode.cpp")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
ITEM = "ROADMAP queue 1 item 8"

_lock = threading.Lock()
_libs: dict[tuple[Path, str], ctypes.CDLL] = {}


def _load(source: Path, stem: str, bind, build_dir: Path) -> ctypes.CDLL:
    """Build (first call only) and load `source` as `stem`, its functions'
    types set by bind(lib); raises on failure."""
    key = (Path(build_dir), stem)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(compile_shared(
                [source], [], CXX_FLAGS, key[0], stem)))
            bind(lib)
            _libs[key] = lib
    return lib


def _bind_decoder(lib: ctypes.CDLL) -> None:
    buf, i64 = ctypes.c_char_p, ctypes.c_int64
    lib.tnt_jpeg_info.restype = ctypes.c_int
    lib.tnt_jpeg_info.argtypes = [
        buf, i64, ctypes.POINTER(ctypes.c_int32), buf, ctypes.c_int]
    lib.tnt_jpeg_decode.restype = ctypes.c_int
    lib.tnt_jpeg_decode.argtypes = [buf, i64, ctypes.c_void_p, i64, buf,
                                    ctypes.c_int]


def _bind_encoder(lib: ctypes.CDLL) -> None:
    i32, i64, ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    lib.tnt_jpeg_encode.restype = ctypes.c_int
    lib.tnt_jpeg_encode.argtypes = [ptr, i32, i32, ctypes.c_char_p, i32, ptr,
                                    i64, ctypes.POINTER(i64)]


def load_library(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (first call only) and load the decoder; raises on failure."""
    return _load(SOURCE, "libtnt_jpeg", _bind_decoder, build_dir)


def load_encoder(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (first call only) and load the encoder; raises on failure."""
    return _load(ENCODER_SOURCE, "libtnt_jpeg_encode", _bind_encoder,
                 build_dir)


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


def encode_jpeg(rgb: np.ndarray, comment: bytes | None = None) -> bytes:
    """uint8 [H, W, 3] RGB -> the JPEG Pillow writes for it at its
    defaults, with `comment` (at most 65533 bytes) as a COM marker."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {rgb.dtype} "
                         f"{list(rgb.shape)}")
    h, w = rgb.shape[:2]
    if not (1 <= h <= 65500 and 1 <= w <= 65500):
        raise ValueError(f"a {w} x {h} image: JPEG holds 1 to 65500 pixels "
                         "a side")
    comment = bytes(comment or b"")
    if len(comment) > 65533:
        raise ValueError(f"a comment of {len(comment)} bytes: a COM marker "
                         "holds at most 65533")
    lib = load_encoder()
    rgb = np.ascontiguousarray(rgb)
    n = ctypes.c_int64(0)
    cap = h * w * 3 + 4096 + len(comment)
    while True:
        out = np.empty(cap, np.uint8)
        code = lib.tnt_jpeg_encode(rgb.ctypes.data, h, w, comment,
                                   len(comment), out.ctypes.data, cap,
                                   ctypes.byref(n))
        if code != 3:
            break
        cap = n.value
    if code:
        raise ValueError(f"the encoder refused a {w} x {h} image")
    return out[:n.value].tobytes()
