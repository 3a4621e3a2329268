"""The port's letterbox canvas (tell_tpu_torch/serving/vision.py) and its
Pillow-equal BOX and BILINEAR resampling (tell_tpu_torch/data/images.py)
against tell_tpu's letterbox and Pillow itself: byte for byte, shrinking
and enlarging."""
import os

import numpy as np
import pytest
from PIL import Image

from tell_tpu.serving.vision import letterbox as j_letterbox
from tell_tpu_torch.data.images import resize_pillow
from tell_tpu_torch.data.jpeg import decode_jpeg
from tell_tpu_torch.serving.vision import DET_CANVAS, letterbox

IMAGES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "images")
FIXTURES = sorted(n for n in os.listdir(IMAGES)
                  if n.endswith(".jpg") and not n.startswith("refused"))
# (height, width): a pixel, odd sizes below the canvas (enlarged, BILINEAR)
# and above it (shrunk, BOX), a long strip, the canvas itself
ODD_SIZES = [(1, 1), (9, 7), (67, 101), (800, 533), (300, 2000),
             (2000, 300), (415, 417), (416, 416), (3, 417)]


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("name", FIXTURES)
def test_letterbox_of_each_fixture_equals_tell_tpu(name):
    with open(os.path.join(IMAGES, name), "rb") as f:
        img = decode_jpeg(f.read()).astype(np.float32)
    want, wscale = j_letterbox(img, DET_CANVAS)
    got, scale = letterbox(img, DET_CANVAS)
    assert got.dtype == np.float32 and got.shape == (416, 416, 3)
    assert scale == wscale and scale > 1.0      # every fixture is enlarged
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", ODD_SIZES)
def test_letterbox_of_odd_sizes_equals_tell_tpu(h, w):
    img = _img(h, w, h * 31 + w).astype(np.float32)
    for size in (DET_CANVAS, 96):
        want, wscale = j_letterbox(img, size)
        got, scale = letterbox(img, size)
        assert scale == wscale
        np.testing.assert_array_equal(got, want)
    # the grey bands are 128 wherever the photo is not
    got, _ = letterbox(img, DET_CANVAS)
    if h != w:
        assert (got[0] == 128).all() or (got[:, 0] == 128).all()


def test_letterbox_casts_like_tell_tpu():
    """Floats outside 0..255 and with fractions are cast to uint8 first,
    as Image.fromarray(img.astype(np.uint8)) does."""
    img = np.random.default_rng(5).uniform(-3, 300, (40, 70, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(letterbox(img, 96)[0],
                                  j_letterbox(img, 96)[0])


@pytest.mark.parametrize("resample", ["box", "bilinear"])
def test_box_and_bilinear_resize_equal_pillow(resample):
    pil = {"box": Image.Resampling.BOX,
           "bilinear": Image.Resampling.BILINEAR}[resample]
    for (h, w), (th, tw) in [((67, 101), (41, 62)), ((67, 101), (133, 202)),
                             ((9, 7), (416, 323)), ((800, 533), (416, 277)),
                             ((300, 2000), (62, 416)), ((5, 5), (3, 11)),
                             ((1, 1), (4, 4)), ((50, 60), (50, 17))]:
        arr = _img(h, w, th * 7 + tw)
        want = np.asarray(Image.fromarray(arr).resize((tw, th), pil))
        np.testing.assert_array_equal(resize_pillow(arr, tw, th, resample),
                                      want)
