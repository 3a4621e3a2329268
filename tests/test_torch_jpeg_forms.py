"""The JPEG forms beyond baseline 4:4:4/4:2:2/4:2:0 YCbCr, decoded by the
port (tell_tpu_torch/data/jpeg.py) to Pillow 12.1.0's convert("RGB")
bytes on the CPU: progressive files (DC and AC, first and refinement
scans, EOB runs, restart intervals) at every sampling, quality and odd
size; 4:1:1 and 4:4:0; CMYK and YCCK (Pillow's own CMYK -> RGB); RGB-coded
three-component files; the fixtures' manifest digests and 224 crops, and
the news photos' progressive twins equal to their baseline files. Forms
still refused name themselves and ROADMAP queue 1 item 8, and the decoder
stays clean under AddressSanitizer and UBSan over the progressive files
with seeded edits (scan headers' Ss/Se/Ah/Al included)."""
import hashlib
import io
import json
import os
import subprocess

import numpy as np
import pytest
from PIL import Image

from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.data import jpeg
from tell_tpu_torch.data.images import decode_image, resize_shortest_crop
from tests.test_torch_jpeg import BASELINE, REFUSED, _scene

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "images")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
# the forms beyond test_torch_jpeg.py's baseline files (whose refused_*.jpg
# list now holds the two forms still refused); the earlier refused 4:1:1,
# 4:4:0, CMYK and progressive files decode now
NEW_JPEGS = sorted(k for k, v in MANIFEST.items() if k.endswith(".jpg")
                   and "refused" not in v and not k.startswith(BASELINE))


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _pillow(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _save(img, **kw):
    f = io.BytesIO()
    Image.fromarray(img).save(f, "JPEG", **kw)
    return f.getvalue()


def test_inventory():
    forms = {n.split("_")[0] for n in NEW_JPEGS}
    assert {"prog", "cmyk", "sampling", "ycck", "rgbcoded",
            "rgbids"} <= forms
    assert {"refused_progressive.jpg", "refused_411.jpg", "refused_440.jpg",
            "refused_cmyk.jpg"} <= set(NEW_JPEGS)
    assert REFUSED == ["refused_12bit.jpg",
                       "refused_progressive_unrefined.jpg"]


@pytest.mark.parametrize("name", NEW_JPEGS)
def test_fixture_equals_pillow_and_manifest(name):
    data = _read(name)
    got = decode_image(data)
    assert list(got.shape) == MANIFEST[name]["shape"]
    np.testing.assert_array_equal(got, _pillow(data))
    assert (hashlib.sha256(got.tobytes()).hexdigest()
            == MANIFEST[name]["rgb_sha256"])
    assert (hashlib.sha256(resize_shortest_crop(got).tobytes()).hexdigest()
            == MANIFEST[name]["crop_sha256"])
    if "twin_of" in MANIFEST[name]:
        np.testing.assert_array_equal(got, jpeg.decode_jpeg(
            _read(MANIFEST[name]["twin_of"])))


def test_info_reports_the_form():
    info = jpeg.jpeg_info(_read("news_a_320x240_420_progressive.jpg"))
    assert info == {"height": 240, "width": 320, "components": 3,
                    "progressive": True}
    assert jpeg.jpeg_info(_read("cmyk_48x40.jpg"))["components"] == 4
    assert not jpeg.jpeg_info(_read("news_a_320x240_420.jpg"))["progressive"]


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_seeded_progressive_images_equal_pillow(subsampling, quality):
    """Sizes around the MCU and the upsampling edges, with and without
    restart intervals (each restart also ends an EOB run)."""
    sizes = [(1, 1), (2, 3), (5, 4), (9, 17), (16, 33), (31, 6), (67, 101)]
    for i, (h, w) in enumerate(sizes):
        img = _scene(h, w, seed=1000 + 100 * quality + 10 * subsampling + i)
        for extra in ({}, {"restart_marker_blocks": 3},
                      {"restart_marker_rows": 1}):
            data = _save(img, quality=quality, subsampling=subsampling,
                         progressive=True, **extra)
            np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                          _pillow(data),
                                          err_msg=f"{h}x{w} {extra}")


def test_grey_cmyk_and_rgb_coded_seeded_images_equal_pillow():
    for i, (h, w) in enumerate([(1, 1), (7, 9), (40, 23)]):
        img = _scene(h, w, seed=50 + i)
        cases = [_save(img[..., 0], quality=80, progressive=True),
                 _save(img, quality=90, keep_rgb=True),
                 _save(img, quality=90, keep_rgb=True, progressive=True)]
        for prog in (False, True):
            f = io.BytesIO()
            Image.fromarray(img).convert("CMYK").save(
                f, "JPEG", quality=85, progressive=prog)
            cases.append(f.getvalue())
        for data in cases:
            np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                          _pillow(data))


def test_cmyk_follows_pillows_conversion():
    """Pillow's CMYK -> RGB of (10, 20, 30, 40) is (207, 198, 190); a flat
    CMYK JPEG decodes to Pillow's bytes, with the Adobe transform byte 0
    (CMYK) or, patched to 2, read as YCCK."""
    a = np.zeros((16, 16, 4), np.uint8)
    a[...] = (10, 20, 30, 40)
    assert np.asarray(Image.fromarray(a, "CMYK").convert("RGB"))[0, 0] \
        .tolist() == [207, 198, 190]
    f = io.BytesIO()
    Image.fromarray(a, "CMYK").save(f, "JPEG", quality=95)
    data = f.getvalue()
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pillow(data))
    b = bytearray(data)
    b[b.index(b"Adobe") + 11] = 2
    assert Image.open(io.BytesIO(bytes(b))).info["adobe_transform"] == 2
    np.testing.assert_array_equal(jpeg.decode_jpeg(bytes(b)),
                                  _pillow(bytes(b)))


def _sampling_patched(data, factors):
    """A file with its SOF's sampling bytes replaced (refused before any
    scan)."""
    b = bytearray(data)
    i = b.index(b"\xff\xc0")
    for k, f in enumerate(factors):
        b[i + 11 + 3 * k] = f
    return bytes(b)


@pytest.mark.parametrize("factors,form", [
    ((0x31, 0x11, 0x11), "chroma sampling 3x1"),
    ((0x42, 0x11, 0x11), "chroma sampling 4x2"),
    ((0x24, 0x11, 0x11), "chroma sampling 2x4,1x1,1x1"),
])
def test_other_samplings_are_refused_by_name(factors, form):
    data = _sampling_patched(_save(_scene(16, 16, 0), subsampling=0),
                             factors)
    with pytest.raises(NotPortedError, match="queue 1 item 8") as e:
        jpeg.decode_jpeg(data)
    assert form in str(e.value)


def test_progressive_scan_errors_are_corrupt_data():
    """An AC scan before any DC scan, and a refinement whose Al is not
    Ah - 1, are corrupt (libjpeg: JERR_BAD_PROGRESSION)."""
    data = _save(_scene(24, 24, 1), progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    # drop the first (DC) scan: its header and its data, up to the next
    # marker that is neither a stuffed zero nor a restart
    end = sos[0] + 2
    while not (data[end] == 0xFF and data[end + 1] not in (
            0x00, *range(0xD0, 0xD8))):
        end += 1
    no_dc = data[:sos[0]] + data[end:]
    with pytest.raises(ValueError, match="corrupt or truncated.*DC scan"):
        jpeg.decode_jpeg(no_dc)
    b = bytearray(data)
    length = int.from_bytes(b[sos[-1] + 2:sos[-1] + 4], "big")
    b[sos[-1] + 2 + length - 1] = 0x13     # Ah 1, Al 3
    with pytest.raises(ValueError, match="successive approximation"):
        jpeg.decode_jpeg(bytes(b))


def test_decoder_is_clean_under_address_sanitizer(tmp_path):
    """fuzz_jpeg.cpp over the progressive, 4:1:1, CMYK and YCCK fixtures
    and 3000 seeded edits of them: no sanitizer report, no crash."""
    inputs = [os.path.join(FIXTURES, n) for n in (
        "prog_restart_101x67_422.jpg", "prog_9x7_420.jpg",
        "prog_grey_67x101.jpg", "cmyk_prog_33x21.jpg",
        "sampling_411_9x7.jpg", "ycck_420_45x37.jpg",
        "refused_progressive_unrefined.jpg")]
    exe = tmp_path / "fuzz_jpeg"
    build = subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", f'-DJPEG_SRC="{jpeg.SOURCE}"',
         os.path.join(FIXTURES, "fuzz_jpeg.cpp"), "-o", str(exe)],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-2000:]
    run = subprocess.run(
        [str(exe), "3000", "1", *inputs], capture_output=True, text=True,
        timeout=120, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert run.returncode == 0, run.stderr[-3000:]
    assert "Sanitizer" not in run.stderr and "runtime error" not in run.stderr
    assert "mutations 3000 decoded" in run.stdout
    assert "prog_restart_101x67_422.jpg: status 0" in run.stdout
    assert "refused_progressive_unrefined.jpg: status 1" in run.stdout
