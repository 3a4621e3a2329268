"""The port's PNG decoder (tell_tpu_torch/data/png.py + csrc/host/png.cpp)
against Pillow 12.1.0's convert("RGB") on the CPU: every PNG fixture
(each colour type and bit depth Pillow writes, hand-written 2/4-bit grey,
16-bit colour, Adam7, every filter type, a palette with tRNS) equal to
its manifest digest and 224 crop, seeded images Pillow writes at odd
sizes, Pillow's quirks (16-bit grey clipped, high bytes kept, tRNS and
alpha dropped, a palette index past PLTE black), a bad CRC and a cut
IDAT refused as corrupt where Pillow raises too, the decompression-bomb
limit from IHDR, decode_image's dispatch (GIF, BMP, TIFF and WebP named
as not ported), and the scanline code clean under AddressSanitizer and
UBSan over seeded edits."""
import hashlib
import io
import json
import os
import struct
import subprocess
import zlib

import numpy as np
import pytest
from PIL import Image

from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.data import png
from tell_tpu_torch.data.images import decode_image, resize_shortest_crop

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "images")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
PNGS = sorted(k for k, v in MANIFEST.items() if k.endswith(".png")
              and "corrupt" not in v)
CORRUPT = sorted(k for k, v in MANIFEST.items() if "corrupt" in v)


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _pillow(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _chunk(cid, body):
    return (struct.pack(">I", len(body)) + cid + body
            + struct.pack(">I", zlib.crc32(cid + body) & 0xFFFFFFFF))


def _png(w, h, depth, ctype, rows, plte=None, trns=None):
    raw = b"".join(b"\x00" + r for r in rows)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def test_inventory():
    names = " ".join(PNGS)
    for form in ("1bit", "_L_", "_LA_", "_RGB_", "_RGBA_", "I16", "P2",
                 "P4", "P16", "P256", "grey2", "grey4", "rgb16", "la16",
                 "rgba16", "filters", "adam7", "pal_trns"):
        assert form in names, form
    assert CORRUPT == ["corrupt_png_crc.png", "corrupt_png_cut_idat.png"]


@pytest.mark.parametrize("name", PNGS)
def test_fixture_equals_pillow_and_manifest(name):
    data = _read(name)
    got = decode_image(data)
    assert got.dtype == np.uint8 and list(got.shape) == MANIFEST[name]["shape"]
    np.testing.assert_array_equal(got, _pillow(data))
    assert (hashlib.sha256(got.tobytes()).hexdigest()
            == MANIFEST[name]["rgb_sha256"])
    assert (hashlib.sha256(resize_shortest_crop(got).tobytes()).hexdigest()
            == MANIFEST[name]["crop_sha256"])


@pytest.mark.parametrize("name", CORRUPT)
def test_corrupt_fixture_is_refused_as_pillow_refuses_it(name):
    data = _read(name)
    with pytest.raises(OSError):
        _pillow(data)
    with pytest.raises(ValueError, match="corrupt or truncated PNG") as e:
        png.decode_png(data)
    assert MANIFEST[name]["corrupt"] in str(e.value)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "RGB", "RGBA", "I;16",
                                  "P", "PA"])
def test_seeded_pillow_pngs_equal_pillow(mode):
    rng = np.random.default_rng(len(mode))
    for h, w in [(1, 1), (3, 7), (17, 5), (33, 40)]:
        rgb = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
        if mode == "I;16":
            im = Image.fromarray(rng.integers(0, 4000, (h, w))
                                 .astype(np.uint16))
        elif mode in ("P", "PA"):
            im = rgb.quantize(int(rng.integers(2, 200)))
            if mode == "PA":
                im.info["transparency"] = 0
        else:
            im = rgb.convert(mode)
        for kw in ({}, {"optimize": True}):
            f = io.BytesIO()
            im.save(f, "PNG", **kw)
            data = f.getvalue()
            np.testing.assert_array_equal(decode_image(data), _pillow(data),
                                          err_msg=f"{mode} {h}x{w} {kw}")


def test_pillows_quirks():
    """16-bit grey clips (1000 -> 255), 16-bit RGB keeps the high byte, a
    palette index past PLTE is black, tRNS is ignored."""
    data = _png(3, 1, 16, 0, [struct.pack(">3H", 1000, 200, 65535)])
    assert Image.open(io.BytesIO(data)).mode == "I;16"
    assert png.decode_png(data)[0, :, 0].tolist() == [255, 200, 255]
    data = _png(1, 1, 16, 2, [struct.pack(">3H", 0x1234, 0xFF00, 0x00FF)])
    assert png.decode_png(data)[0, 0].tolist() == [0x12, 0xFF, 0x00]
    data = _png(3, 1, 8, 3, [bytes([0, 1, 5])], plte=bytes(range(10, 16)),
                trns=b"\x00")
    np.testing.assert_array_equal(png.decode_png(data), _pillow(data))
    assert png.decode_png(data)[0, 2].tolist() == [0, 0, 0]
    for name in ("png_I16_23x19.png", "png_pal_trns_23x19.png"):
        np.testing.assert_array_equal(decode_image(_read(name)),
                                      _pillow(_read(name)))


def test_malformed_files_raise():
    good = _png(2, 2, 8, 2, [bytes(6), bytes(6)])
    bad_filter = _png(2, 1, 8, 0, [bytes(2)]).replace(
        zlib.compress(b"\x00" + bytes(2)), zlib.compress(b"\x07" + bytes(2)))
    cases = {
        "not a PNG file": b"\x89PNX" + good[5:],
        "filter type of 7": bad_filter,
        "no IHDR": good[:8] + good[33:],
        "does not inflate": good[:41] + b"\xff" * 8 + good[49:],
        "colour type": _png(2, 1, 8, 5, [bytes(2)]),
        "without a PLTE": _png(2, 1, 8, 3, [bytes(2)]),
    }
    for words, data in cases.items():
        with pytest.raises(ValueError, match=words):
            png.decode_png(data)


def test_frame_above_the_pixel_limit_is_refused_from_ihdr():
    data = _png(13378, 13378, 8, 0, [])
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    with pytest.raises(ValueError, match="decompression-bomb limit"):
        png.decode_png(data)


@pytest.mark.parametrize("fmt,name", [("GIF", "GIF"), ("BMP", "BMP"),
                                      ("TIFF", "TIFF"), ("WEBP", "WebP")])
def test_decode_image_names_other_formats(fmt, name):
    f = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(f, fmt)
    with pytest.raises(NotPortedError, match=f"{name}.*queue 1 item 8"):
        decode_image(f.getvalue())
    with pytest.raises(NotPortedError, match="neither JPEG nor PNG"):
        decode_image(b"\x00\x01junk")


def _fuzz_case(path, data):
    """The test's case file for fuzz_png.cpp: IHDR's fields, the palette
    and the inflated image data, as png.py hands them to the C++."""
    p = png.parse_png(data)
    head = struct.pack("<6i", p["width"], p["height"], p["depth"],
                       p["color_type"], p["interlace"],
                       len(p["palette"]) // 3)
    path.write_bytes(head + p["palette"] + p["raw"])
    return str(path)


def test_scanlines_are_clean_under_address_sanitizer(tmp_path):
    names = ["png_adam7_rgb_37x29.png", "png_adam7_grey1_13x11.png",
             "png_adam7_pal4_5x3.png", "png_filters_rgb_37x29.png",
             "png_rgba16_23x19.png", "png_grey2_23x19.png",
             "png_pal_trns_23x19.png", "png_la16_23x19.png"]
    inputs = [_fuzz_case(tmp_path / (n + ".case"), _read(n)) for n in names]
    exe = tmp_path / "fuzz_png"
    build = subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", f'-DPNG_SRC="{png.SOURCE}"',
         os.path.join(FIXTURES, "fuzz_png.cpp"), "-o", str(exe)],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-2000:]
    run = subprocess.run(
        [str(exe), "4000", "0", *inputs], capture_output=True, text=True,
        timeout=120, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert run.returncode == 0, run.stderr[-3000:]
    assert "Sanitizer" not in run.stderr and "runtime error" not in run.stderr
    assert "mutations 4000 decoded" in run.stdout
    for n in names:
        assert f"{n}.case: status 0" in run.stdout


def test_library_builds_into_an_empty_directory(tmp_path):
    lib = png.load_library(tmp_path / "build")
    names = [p.name for p in (tmp_path / "build").iterdir()]
    assert len(names) == 1 and names[0].startswith("libtnt_png_")
    assert lib.tnt_png_decode is not None
