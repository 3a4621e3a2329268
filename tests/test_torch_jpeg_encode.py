"""The port's JPEG encoder (data/jpeg.py's encode_jpeg, csrc/host/
jpeg_encode.cpp) byte for byte against Pillow 12.1.0's
Image.fromarray(rgb).save(f, "JPEG") at odd and block-aligned sizes with
random, flat, gradient and saturated content and a hypothesis sweep; the
comment Pillow carries from a source image (data/images.py's
image_comment) and writes as COM; the encoder's refusals; and data/png.py's
encode_png decoding to its input's pixels through the port's decoder and
Pillow. Tolerance: none, bytes and pixels equal."""
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, PngImagePlugin

from tell_tpu_torch.data.images import decode_image, image_comment
from tell_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
from tell_tpu_torch.data.png import encode_png

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "images")
# (height, width): a pixel, sizes below, at and above a block and an MCU,
# the processed photos' 224 and a photo-sized odd pair both ways
SHAPES = ((224, 224), (1, 1), (7, 9), (9, 7), (15, 17), (16, 16), (17, 33),
          (333, 250), (250, 333), (2, 3), (8, 31), (31, 8), (100, 37))
CONTENTS = ("random", "flat", "gradient", "saturated")


def _image(h, w, content, seed=0):
    rng = np.random.default_rng(seed)
    if content == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if content == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8),
                               (h, w, 3)).copy()
    if content == "gradient":
        y, x = np.mgrid[0:h, 0:w]
        return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                         (3 * x + 5 * y) % 256], -1).astype(np.uint8)
    return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)


def _pillow_jpeg(rgb, **kw):
    f = io.BytesIO()
    Image.fromarray(rgb).save(f, "JPEG", **kw)
    return f.getvalue()


@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_equals_pillow(shape, content):
    rgb = _image(*shape, content)
    got = encode_jpeg(rgb)
    assert got == _pillow_jpeg(rgb)
    assert decode_jpeg(got).shape == rgb.shape


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       seed=st.integers(0, 2 ** 31), levels=st.sampled_from([2, 7, 256]))
def test_encode_equals_pillow_hypothesis(h, w, seed, levels):
    rng = np.random.default_rng(seed)
    rgb = (rng.integers(0, levels, (h, w, 3)) * (255 // (levels - 1))
           ).astype(np.uint8)
    assert encode_jpeg(rgb) == _pillow_jpeg(rgb)


def test_processed_fixtures_match_their_digests():
    """The committed processed photos (tell_tpu's process_images output)
    hold their manifest digests and decode in the port as in Pillow."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    processed = {k: v["processed"] for k, v in manifest.items()
                 if "processed" in v}
    assert len(processed) == 7
    for entry in processed.values():
        with open(os.path.join(FIXTURES, entry["file"]), "rb") as f:
            data = f.read()
        assert hashlib.sha256(data).hexdigest() == entry["sha256"]
        pixels = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert decode_jpeg(data).tobytes() == pixels.tobytes()


def _png_with_text(rgb, chunk):
    f = io.BytesIO()
    Image.fromarray(rgb).save(f, "PNG")
    data = f.getvalue()
    cid, body = chunk
    crc = zlib.crc32(body, zlib.crc32(cid)) & 0xFFFFFFFF
    at = data.rindex(b"IEND") - 4          # after the image data
    return (data[:at] + struct.pack(">I", len(body)) + cid + body
            + struct.pack(">I", crc) + data[at:])


def _comment_sources():
    rgb = _image(10, 12, "random", 3)
    out = {"none": _pillow_jpeg(rgb)}
    for name, c in (("ascii", b"hello"), ("empty", b""),
                    ("binary", b"\xff\xfe\x00x")):
        out[f"jpeg_{name}"] = _pillow_jpeg(rgb, comment=c)
    plain = out["none"]
    out["jpeg_two"] = (plain[:2] + b"\xff\xfe\x00\x05one"
                       + b"\xff\xfe\x00\x05two" + plain[2:])
    for name, add in (("text", lambda i: i.add_text("comment", "caf\xe9")),
                      ("ztxt", lambda i: i.add_text("comment", "z\xe9",
                                                    zip=True)),
                      ("itxt", lambda i: i.add_itxt("comment", "\xe9中")),
                      ("other_key", lambda i: i.add_text("Comment", "no"))):
        info = PngImagePlugin.PngInfo()
        add(info)
        f = io.BytesIO()
        Image.fromarray(rgb).save(f, "PNG", pnginfo=info)
        out[f"png_{name}"] = f.getvalue()
    out["png_text_after_idat"] = _png_with_text(
        rgb, (b"tEXt", b"comment\x00late"))
    return out


COMMENT_SOURCES = _comment_sources()


@pytest.mark.parametrize("name", sorted(COMMENT_SOURCES))
def test_comment_carried_as_pillow_carries_it(name):
    """Pillow keeps a source's comment in info["comment"] through
    convert, resize and crop, and writes it as COM: the processed file
    equals encode_jpeg(pixels, image_comment(source))."""
    data = COMMENT_SOURCES[name]
    im = Image.open(io.BytesIO(data)).convert("RGB")
    im = im.resize((7, 5), Image.Resampling.LANCZOS).crop((1, 1, 6, 4))
    want = io.BytesIO()
    im.save(want, "JPEG")
    rgb = decode_image(data)
    assert np.array_equal(rgb, np.asarray(Image.open(io.BytesIO(data))
                                          .convert("RGB")))
    got = encode_jpeg(np.asarray(im), image_comment(data))
    assert got == want.getvalue()


@pytest.mark.parametrize("bad", ["float", "grey", "rgba", "empty", "wide",
                                 "comment"])
def test_encode_refuses_what_jpeg_cannot_hold(bad):
    rgb = _image(4, 4, "random")
    arg = {"float": rgb.astype(np.float32), "grey": rgb[..., 0],
           "rgba": np.dstack([rgb, rgb[..., :1]]),
           "empty": np.zeros((0, 4, 3), np.uint8),
           "wide": np.zeros((1, 65501, 3), np.uint8),
           "comment": rgb}[bad]
    with pytest.raises(ValueError):
        encode_jpeg(arg, b"x" * 65534 if bad == "comment" else None)


@pytest.mark.parametrize("shape", ((1, 1), (7, 9), (224, 224), (33, 17)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_png_decodes_to_its_pixels(shape):
    rgb = _image(*shape, "random", 5)
    data = encode_png(rgb)
    assert np.array_equal(decode_image(data), rgb)
    assert np.array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), rgb)
    with pytest.raises(ValueError):
        encode_png(rgb[..., :2])
