"""Write the JPEG fixtures of tests/fixtures/images and their manifest.

    python tests/fixtures/images/make_fixtures.py

Every image is drawn from a seeded numpy array and encoded by Pillow; the
manifest holds, for each file Pillow decodes, the sha256 of
np.asarray(Image.open(f).convert("RGB")) and of its 224 crop (tell_tpu's
resize_shortest_crop), and for each refused one the form the port must
name. Needs Pillow (a test dependency; the port itself has none).
"""
import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def photo(h, w, seed):
    """A smooth scene with edges and grain, like a downscaled photo."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([
        128 + 90 * np.sin(xx / (w / 5.0) + yy / (h / 3.0)),
        128 + 80 * np.cos(xx / (w / 7.0)) * np.sin(yy / (h / 4.0)),
        128 + 70 * np.sin((xx + yy) / (w / 3.0))], -1)
    for _ in range(6):   # a few flat boxes: hard edges for the IDCT
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + h // 4, x0:x0 + w // 5] = rng.integers(0, 256, 3)
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def noise(h, w, seed, channels=3):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    return a[..., 0] if channels == 1 else a


def encode(arr, **kw):
    f = io.BytesIO()
    Image.fromarray(arr).save(f, "JPEG", **kw)
    return f.getvalue()


def patch_sampling(data, luma):
    """The same file with the luma sampling byte of its SOF0 set to
    `luma` (0x41: 4:1:1, 0x12: 4:4:0) -- a header the decoder must refuse
    before it reads any scan."""
    b = bytearray(data)
    i = b.index(b"\xff\xc0")
    b[i + 11] = luma
    return bytes(b)


def patch_precision(data, bits):
    b = bytearray(data)
    b[b.index(b"\xff\xc0") + 4] = bits
    return bytes(b)


def main():
    sys.path.insert(0, ROOT)
    from tell_tpu.data.images import resize_shortest_crop

    files = {
        "news_a_320x240_420.jpg": encode(photo(240, 320, 1), quality=85),
        "news_b_200x300_420.jpg": encode(photo(300, 200, 2), quality=85),
        "rgb_1x1_420.jpg": encode(noise(1, 1, 3), quality=75),
        "rgb_9x7_422.jpg": encode(noise(7, 9, 4), quality=75, subsampling=1),
        "rgb_101x67_444.jpg": encode(photo(67, 101, 5), quality=95,
                                     subsampling=0),
        "rgb_67x101_422.jpg": encode(photo(101, 67, 6), quality=50,
                                     subsampling=1),
        "rgb_101x67_420.jpg": encode(photo(67, 101, 7), quality=75,
                                     subsampling=2),
        "grey_9x7.jpg": encode(noise(7, 9, 8, channels=1), quality=75),
        "grey_67x101.jpg": encode(photo(101, 67, 9)[..., 1], quality=90),
        "restart_101x67_420.jpg": encode(photo(67, 101, 10), quality=75,
                                         restart_marker_blocks=2),
        "restart_rows_67x101_444.jpg": encode(photo(101, 67, 11),
                                              quality=90, subsampling=0,
                                              restart_marker_rows=1),
    }
    base = encode(photo(40, 48, 12), quality=75, subsampling=0)
    refused = {
        "refused_progressive.jpg": (encode(photo(40, 48, 13), quality=75,
                                           progressive=True), "progressive"),
        "refused_411.jpg": (patch_sampling(base, 0x41), "chroma sampling"),
        "refused_440.jpg": (patch_sampling(base, 0x12), "chroma sampling"),
        "refused_12bit.jpg": (patch_precision(base, 12), "12-bit"),
    }
    f = io.BytesIO()
    Image.fromarray(photo(40, 48, 14)).convert("CMYK").save(f, "JPEG")
    refused["refused_cmyk.jpg"] = (f.getvalue(), "4-component")

    manifest = {}
    for name, data in files.items():
        with open(os.path.join(HERE, name), "wb") as out:
            out.write(data)
        im = Image.open(io.BytesIO(data)).convert("RGB")
        rgb = np.asarray(im)
        crop = np.asarray(resize_shortest_crop(im))
        manifest[name] = {
            "shape": list(rgb.shape),
            "rgb_sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "crop_sha256": hashlib.sha256(crop.tobytes()).hexdigest()}
    for name, (data, form) in refused.items():
        with open(os.path.join(HERE, name), "wb") as out:
            out.write(data)
        manifest[name] = {"refused": form}
    with open(os.path.join(HERE, "manifest.json"), "w") as out:
        json.dump(manifest, out, indent=1, sort_keys=True)
        out.write("\n")


if __name__ == "__main__":
    main()
