"""The port's PNG decoder: chunks, CRCs and zlib here, the scanlines in
csrc/host/png.cpp through ctypes.

tell_tpu opens `.png` photos (dataset images and request bodies) through
Pillow; ``decode_png(data)`` equals
``np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))``, with
Pillow's own reading of the file:

* the chunks before the first IDAT have their CRCs checked (a mismatch is
  "broken PNG file"); IDAT and later chunks are not, as Pillow does not;
* the image data is the run of consecutive IDAT chunks, inflated with the
  standard library's zlib to at most the bytes IHDR implies (more is
  ignored, less is a truncated file);
* a frame above Pillow's decompression-bomb limit (178956970 pixels) is
  refused from IHDR before anything is inflated;
* Pillow's quirks, which tell_tpu inherits: 16-bit grey opens as "I;16"
  and its RGB CLIPS at 255 (1000 -> 255) rather than scaling; 16-bit RGB,
  RGBA and grey+alpha keep each sample's high byte; a palette's tRNS,
  every alpha channel, gamma and ICC profiles are ignored; a palette index
  past the PLTE entries is black.

The C++ (unfiltering, Adam7, bit depths 1/2/4/8/16 for colour types
0/2/3/4/6) is compiled with g++ into tell_tpu_torch/build/ at the first
call, as data/jpeg.py builds its decoder. Malformed files raise a
ValueError; nothing here needs Pillow.

``encode_png(rgb)`` writes an 8-bit RGB PNG (IHDR, one IDAT of the
standard library's zlib over unfiltered scanlines, IEND): the dataset
build's `.png` outputs. PNG is lossless, so it decodes to the input's
pixels, as the file Pillow would write does; its bytes are not Pillow's.
"""
from __future__ import annotations

import ctypes
import re
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

from .jpeg import CXX_FLAGS, ITEM
from .native import BUILD_DIR, compile_shared

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "png.cpp"
SIGNATURE = b"\x89PNG\r\n\x1a\n"
MAX_PIXELS = 178956970          # Pillow's decompression-bomb limit
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_CID = re.compile(rb"\w\w\w\w")   # Pillow's is_cid

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


def load_library(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (first call only) and load the scanline decoder."""
    build_dir = Path(build_dir)
    with _lock:
        lib = _libs.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(str(compile_shared(
                [SOURCE], [], CXX_FLAGS, build_dir, "libtnt_png")))
            i32, i64, buf = ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p
            lib.tnt_png_decode.restype = ctypes.c_int
            lib.tnt_png_decode.argtypes = [
                buf, i64, i32, i32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                buf, ctypes.c_int, ctypes.c_void_p, i64, buf, ctypes.c_int]
            _libs[build_dir] = lib
    return lib


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt or truncated PNG ({msg}); the port's "
                      f"decoder takes no other data ({ITEM})")


def _chunks(data: bytes):
    """(type, body, crc ok) of each chunk, in file order, until IEND or
    the data's end."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, cid = struct.unpack(">I4s", data[pos:pos + 8])
        if not _CID.match(cid):
            raise _corrupt(f"broken PNG file (chunk {cid!r})")
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        ok = (len(crc) == 4 and struct.unpack(">I", crc)[0]
              == zlib.crc32(body, zlib.crc32(cid)) & 0xFFFFFFFF)
        yield cid, body, ok
        if cid == b"IEND":
            return
        pos += 12 + length


def _raw_size(width: int, height: int, bits: int, interlace: int) -> int:
    """The inflated bytes IHDR implies: a filter byte and the packed
    samples of every scanline of every (non-empty) pass."""
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)] if interlace
              else [(0, 0, 1, 1)])
    total = 0
    for x0, y0, dx, dy in passes:
        pw = max(0, (width - x0 + dx - 1) // dx)
        ph = max(0, (height - y0 + dy - 1) // dy)
        if pw and ph:
            total += ph * (1 + (pw * bits + 7) // 8)
    return total


def parse_png(data: bytes) -> dict:
    """IHDR's fields, the palette and the inflated image data."""
    if not data.startswith(SIGNATURE):
        raise _corrupt("not a PNG file")
    header, palette, idat, in_idat = None, b"", [], False
    for cid, body, crc_ok in _chunks(data):
        if cid == b"IDAT":
            idat.append(body)
            in_idat = True
            continue
        if in_idat:          # the image data ends at the first other chunk
            break
        if not crc_ok:
            raise _corrupt(f"broken PNG file (bad header checksum in "
                           f"{cid!r})")
        if cid == b"IHDR":
            if len(body) < 13:
                raise _corrupt("truncated IHDR chunk")
            w, h, depth, ctype, _, filt, interlace = struct.unpack(
                ">IIBBBBB", body[:13])
            if filt:
                raise _corrupt("unknown filter category")
            if w * h > MAX_PIXELS:
                raise ValueError(
                    f"refused: a frame of {w} x {h} pixels, above the limit "
                    f"of {MAX_PIXELS} (Pillow's decompression-bomb limit)")
            header = dict(width=w, height=h, depth=depth, color_type=ctype,
                          interlace=1 if interlace else 0)
        elif cid == b"PLTE":
            palette = body[:len(body) // 3 * 3]
    if header is None:
        raise _corrupt("no IHDR chunk before the image data")
    if not idat:
        raise _corrupt("no image data")
    if header["color_type"] == 3 and not palette:
        raise _corrupt("a palette image without a PLTE chunk")
    if header["color_type"] not in CHANNELS:
        raise _corrupt(f"unknown colour type {header['color_type']}")
    want = _raw_size(header["width"], header["height"],
                     CHANNELS[header["color_type"]] * header["depth"],
                     header["interlace"])
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), want)
    except zlib.error as e:
        raise _corrupt(f"the image data does not inflate: {e}") from None
    if len(raw) < want:
        raise _corrupt(f"image file is truncated ({len(raw)} of {want} "
                       "bytes of image data)")
    return {**header, "palette": palette, "raw": raw}


def decode_png(data: bytes) -> np.ndarray:
    """Encoded PNG bytes -> uint8 [H, W, 3] RGB."""
    png = parse_png(bytes(data))
    lib = load_library()
    out = np.empty((png["height"], png["width"], 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    code = lib.tnt_png_decode(
        png["raw"], len(png["raw"]), png["width"], png["height"],
        png["depth"], png["color_type"], png["interlace"], png["palette"],
        len(png["palette"]) // 3, out.ctypes.data, out.nbytes, err, len(err))
    if code:
        raise _corrupt(err.value.decode(errors="replace"))
    return out


def _chunk(cid: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + cid + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(cid))
                          & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> an 8-bit RGB PNG of those pixels."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {rgb.dtype} "
                         f"{list(rgb.shape)}")
    h, w = rgb.shape[:2]
    if not (1 <= h < 2 ** 31 and 1 <= w < 2 ** 31):
        raise ValueError(f"a {w} x {h} image: PNG holds 1 to 2**31 - 1 "
                         "pixels a side")
    rows = np.zeros((h, 1 + w * 3), np.uint8)    # filter type 0 (None)
    rows[:, 1:] = rgb.reshape(h, w * 3)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
