"""The dataset's image preprocessing, shared by preprocess (data/pipeline.py)
and the service (serving/vision.py); counterpart of tell_tpu/data/images.py.

tell_tpu resizes through Pillow: the shortest side to 256 with LANCZOS, the
long side FLOORED (``int(size * h / w)``), no resize when the shortest side
is already 256, then a centre crop of 224 at offsets ``int(round((n - crop)
/ 2))`` (Python's round-half-even). Serve-time grids must equal train-time
grids, so the port's resize is Pillow's own arithmetic in numpy, byte for
byte: per output pixel the filter's taps over the window Pillow picks, in
double precision, normalised to sum 1, turned into 22-bit fixed point
(rounded half away from zero), accumulated from ``1 << 21`` in integers,
shifted and clipped to uint8; the horizontal pass first, uint8 in between,
then the vertical one. The filters are Pillow's LANCZOS (``sinc(x) *
sinc(x / 3)``, support 3), BILINEAR (the triangle, support 1) and BOX
(support 0.5); the service's letterbox (serving/vision.py) takes BOX to
shrink and BILINEAR to enlarge.
"""
from __future__ import annotations

import functools
import math

import numpy as np

from ..config import NotPortedError
from .jpeg import decode_jpeg
from .png import decode_png

PRECISION_BITS = 32 - 8 - 2     # Pillow's Resample.c, 8 bits per channel


def _lanczos(x: float) -> float:
    """sinc(x) * sinc(x / 3) on [-3, 3), 0 elsewhere (Resample.c, with the
    C library's sin, as Pillow calls it)."""
    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v
    if -3.0 <= x < 3.0:
        return sinc(x) * sinc(x / 3.0)
    return 0.0


def _triangle(x: float) -> float:
    """Resample.c's bilinear_filter."""
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _box(x: float) -> float:
    """Resample.c's box_filter: 1 on (-0.5, 0.5]."""
    return 1.0 if -0.5 < x <= 0.5 else 0.0


# Pillow's resampling filters: (filter, support)
FILTERS = {"lanczos": (_lanczos, 3.0), "bilinear": (_triangle, 1.0),
           "box": (_box, 0.5)}


@functools.lru_cache(maxsize=256)
def _taps(in_size: int, out_size: int, lo: int, hi: int,
          resample: str = "lanczos") -> tuple[np.ndarray, np.ndarray]:
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc for output
    pixels [lo, hi) of out_size: each one's first input index [hi - lo]
    and its fixed-point taps [hi - lo, ksize] (0 past its window; float64
    holding integers): the window's weights summed in order, divided by
    the sum, scaled by 2**22 and rounded half away from zero. Cached
    (read-only): photos come in a few sizes."""
    fn, support = FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts = np.zeros(hi - lo, np.int64)
    taps = np.zeros((hi - lo, ksize), np.float64)
    for xx in range(lo, hi):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            v = (v / total if total != 0.0 else v) * (1 << PRECISION_BITS)
            taps[xx - lo, x] = int(v - 0.5 if v < 0 else v + 0.5)
        starts[xx - lo] = xmin
    starts.flags.writeable = taps.flags.writeable = False
    return starts, taps


def _resample_rows(img: np.ndarray, out_size: int, lo: int,
                   hi: int, resample: str) -> np.ndarray:
    """One pass along axis 1 of uint8 [R, n, C]: output pixels [lo, hi) of
    out_size, as one matrix product over the input columns their windows
    cover. Every product and partial sum is an integer below 2**53, so
    float64 holds the sums exactly, in any order."""
    starts, taps = _taps(img.shape[1], out_size, lo, hi, resample)
    R, n, C = img.shape
    first = int(starts.min())
    last = min(int(starts.max()) + taps.shape[1], n)
    band = np.zeros((last - first, hi - lo), np.float64)
    for j in range(taps.shape[1]):     # past a window the tap is 0
        keep = starts + j < last
        band[starts[keep] + j - first, np.flatnonzero(keep)] = taps[keep, j]
    src = img[:, first:last].transpose(0, 2, 1).reshape(R * C, -1)
    acc = (src.astype(np.float64) @ band).astype(np.int64)
    acc += 1 << (PRECISION_BITS - 1)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return out.reshape(R, C, -1).transpose(0, 2, 1)


def resize_pillow(img: np.ndarray, width: int, height: int,
                  resample: str = "lanczos",
                  box: tuple[int, int, int, int] | None = None
                  ) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [height, width, 3], equal to Pillow's
    Image.resize((width, height), resample) on the same pixels (`resample`
    a key of FILTERS: LANCZOS, BILINEAR or BOX); with `box` (left, top,
    right, bottom), only that part of the output."""
    left, top, right, bottom = box or (0, 0, width, height)
    out = img
    if width != img.shape[1]:
        out = _resample_rows(out, width, left, right, resample)
    else:
        out = out[:, left:right]
    if height != img.shape[0]:
        out = _resample_rows(out.transpose(1, 0, 2), height, top,
                             bottom, resample).transpose(1, 0, 2)
    else:
        out = out[top:bottom]
    return np.ascontiguousarray(out)


def resize_shortest_crop(img: np.ndarray, resize: int = 256,
                         crop: int = 224) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [crop, crop, 3]: shortest side to `resize`,
    centre `crop` (tell_tpu's resize_shortest_crop on a Pillow image)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {img.dtype} "
                         f"{list(img.shape)}")
    h, w = img.shape[:2]
    if not ((w <= h and w == resize) or (h <= w and h == resize)):
        if w < h:
            nw, nh = resize, int(resize * h / w)
        else:
            nw, nh = int(resize * w / h), resize
    else:
        nw, nh = w, h
    top = int(round((nh - crop) / 2.0))
    left = int(round((nw - crop) / 2.0))
    if (nw, nh) == (w, h):
        return np.ascontiguousarray(img[top:top + crop, left:left + crop])
    # each output pixel is its own sum: resample only the crop
    return resize_pillow(img, nw, nh, "lanczos",
                         (left, top, left + crop, top + crop))


# the formats Pillow would open that the port does not decode, by their
# signature bytes
_OTHER_FORMATS = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                  (b"RIFF", "WebP"))


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> uint8 [H, W, 3] RGB, as tell_tpu's
    Image.open(...).convert("RGB") gives it: JPEG (FF D8) through
    data/jpeg.py, PNG (89 'PNG') through data/png.py. Any other format is
    refused with a NotPortedError naming it (ROADMAP queue 1 item 8)."""
    data = bytes(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data)
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic) and (name != "WebP"
                                       or data[8:12] == b"WEBP"):
            raise NotPortedError(f"a {name} image: the port decodes JPEG "
                                 "and PNG only (ROADMAP queue 1 item 8)")
    raise NotPortedError("an image in no format the port decodes (neither "
                         "JPEG nor PNG; ROADMAP queue 1 item 8)")
