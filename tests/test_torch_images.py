"""The port's resize and centre crop (tell_tpu_torch/data/images.py) and the
request image forms (serving/vision.py) against tell_tpu's, which go
through Pillow: byte for byte."""
import base64
import io

import numpy as np
import pytest
from PIL import Image

from tell_tpu.data.images import resize_shortest_crop as j_crop
from tell_tpu.serving import vision as jv
from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.data.images import resize_pillow, resize_shortest_crop
from tell_tpu_torch.serving import vision as tv


def _img(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


# (width, height): landscape and portrait, shrink and enlarge, the floored
# long side (513/512 -> 256.5), odd crop offsets (round half to even), the
# no-op when the short side is already 256, a square 224
SIZES = [(640, 480), (480, 640), (512, 513), (513, 512), (333, 500),
         (500, 333), (256, 401), (401, 256), (257, 449), (120, 300),
         (300, 120), (224, 224), (37, 53), (1, 1), (7, 9), (1999, 225)]


@pytest.mark.parametrize("w,h", SIZES)
def test_resize_shortest_crop_equals_tell_tpu(w, h):
    arr = _img(h, w, seed=w * 7 + h)
    want = np.asarray(j_crop(Image.fromarray(arr)))
    got = resize_shortest_crop(arr)
    assert got.shape == (224, 224, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_no_op_at_256_is_a_plain_crop():
    arr = _img(256, 300)
    np.testing.assert_array_equal(resize_shortest_crop(arr),
                                  arr[16:240, 38:262])


@pytest.mark.parametrize("src,dst", [((53, 37), (106, 75)),
                                     ((640, 480), (97, 211)),
                                     ((11, 300), (300, 11))])
def test_resize_lanczos_equals_pillow(src, dst):
    arr = _img(src[1], src[0], seed=3)
    want = np.asarray(Image.fromarray(arr).resize(
        dst, Image.Resampling.LANCZOS))
    np.testing.assert_array_equal(resize_pillow(arr, *dst), want)


def test_resize_rejects_what_is_not_uint8_rgb():
    with pytest.raises(ValueError, match="uint8"):
        resize_shortest_crop(np.zeros((10, 10, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        resize_shortest_crop(np.zeros((10, 10), np.uint8))


def test_center_crop_224_equals_tell_tpu():
    arr = _img(449, 257, seed=5).astype(np.float32)
    got = tv.center_crop_224(arr)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jv.center_crop_224(arr))
    # values past 255 wrap in the uint8 cast, as in tell_tpu's
    # Image.fromarray(img.astype(np.uint8))
    hot = arr.copy()
    hot[:40] += 300.0
    np.testing.assert_array_equal(tv.center_crop_224(hot),
                                  jv.center_crop_224(hot))


def _jpeg_b64(arr, **kw):
    f = io.BytesIO()
    Image.fromarray(arr).save(f, "JPEG", **kw)
    return base64.b64encode(f.getvalue()).decode()


@pytest.mark.parametrize("req_of", [
    lambda a: {"image_b64": _jpeg_b64(a, quality=90)},
    lambda a: {"image_b64": _jpeg_b64(a, quality=60, subsampling=1)},
    lambda a: {"image": a.tolist()},
    lambda a: {"image": a.astype(np.float32)},
    lambda a: {"context": "no image"},
    lambda a: {"image": [[1, 2], [3, 4]]},        # not [H, W, 3]: no image
])
def test_decode_request_image_forms_equal_tell_tpu(req_of):
    req = req_of(_img(31, 45, seed=9))
    want = jv.decode_request_image(req)
    got = tv.decode_request_image(req)
    if want is None:
        assert got is None
        return
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode_request_image_refusals():
    f = io.BytesIO()
    Image.fromarray(_img(8, 8)).save(f, "PNG")
    with pytest.raises(NotPortedError, match="PNG.*queue 1 item 8"):
        tv.decode_request_image(
            {"image_b64": base64.b64encode(f.getvalue()).decode()})
    with pytest.raises(ValueError):
        tv.decode_request_image({"image_b64": "not base64!"})
