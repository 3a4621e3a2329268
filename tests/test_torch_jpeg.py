"""The port's baseline-JPEG decoder (tell_tpu_torch/data/jpeg.py) against
Pillow, which tell_tpu decodes through: byte for byte on every committed
fixture and on seeded images encoded here at qualities 50/75/95 in each
sampling, the fixtures' manifest digests, each refused form raising
with ROADMAP queue 1 item 8 named, and malformed input (Huffman tables,
frame sizes, truncated scans) refused as Pillow refuses it."""
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
from tell_tpu_torch.data.images import resize_shortest_crop

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "images")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
# the baseline fixtures (the other forms: test_torch_jpeg_forms.py; PNGs:
# test_torch_png.py) and every refused JPEG
BASELINE = ("news_a_320x240_420.jpg", "news_b_200x300_420.jpg", "rgb_",
            "grey_", "restart_")
DECODED = sorted(k for k in MANIFEST if k.startswith(BASELINE))
REFUSED = sorted(k for k, v in MANIFEST.items() if k.endswith(".jpg")
                 and "refused" in v)


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _pillow(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(xx / 9.0 + yy / 13.0),
                    128 + 90 * np.cos(xx / 5.0),
                    128 + 80 * np.sin(yy / 7.0)], -1)
    img += rng.normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_fixture_inventory():
    assert len(DECODED) == 11 and len(REFUSED) == 2
    total = sum(os.path.getsize(os.path.join(FIXTURES, n))
                for n in DECODED + REFUSED)
    assert total < 100_000


@pytest.mark.parametrize("name", DECODED)
def test_fixture_equals_pillow_and_manifest(name):
    data = _read(name)
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and list(got.shape) == MANIFEST[name]["shape"]
    np.testing.assert_array_equal(got, _pillow(data))
    assert (hashlib.sha256(got.tobytes()).hexdigest()
            == MANIFEST[name]["rgb_sha256"])
    crop = resize_shortest_crop(got)
    assert (hashlib.sha256(crop.tobytes()).hexdigest()
            == MANIFEST[name]["crop_sha256"])


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_seeded_images_equal_pillow(subsampling, quality):
    """Odd and even sizes around the MCU and fancy-upsampling edges (chroma
    planes 1-3 samples wide replicate, wider ones interpolate), with and
    without restart intervals."""
    sizes = [(1, 1), (2, 3), (3, 2), (5, 4), (8, 8), (9, 17), (16, 33),
             (31, 6), (67, 101)]
    for i, (h, w) in enumerate(sizes):
        img = _scene(h, w, seed=100 * quality + 10 * subsampling + i)
        for extra in ({}, {"restart_marker_blocks": 3},
                      {"restart_marker_rows": 1}):
            f = io.BytesIO()
            Image.fromarray(img).save(f, "JPEG", quality=quality,
                                      subsampling=subsampling, **extra)
            data = f.getvalue()
            np.testing.assert_array_equal(
                jpeg.decode_jpeg(data), _pillow(data),
                err_msg=f"{h}x{w} {extra}")


def test_grey_equals_pillow():
    for i, (h, w) in enumerate([(1, 1), (7, 9), (40, 23)]):
        img = _scene(h, w, seed=i)[..., 0]
        f = io.BytesIO()
        Image.fromarray(img).save(f, "JPEG", quality=80)
        data = f.getvalue()
        got = jpeg.decode_jpeg(data)
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, _pillow(data))


@pytest.mark.parametrize("name", REFUSED)
def test_refused_fixture_names_its_form_and_item(name):
    with pytest.raises(NotPortedError, match="queue 1 item 8") as e:
        jpeg.decode_jpeg(_read(name))
    assert MANIFEST[name]["refused"] in str(e.value)


def _header_patched(marker):
    """A 4:4:4 file whose SOF0 marker byte is replaced."""
    f = io.BytesIO()
    Image.fromarray(_scene(16, 16, 0)).save(f, "JPEG", subsampling=0)
    b = bytearray(f.getvalue())
    b[b.index(b"\xff\xc0") + 1] = marker
    return bytes(b)


@pytest.mark.parametrize("data,form", [
    (_header_patched(0xC9), "arithmetic"),
    (_header_patched(0xC3), "lossless"),
    (_header_patched(0xC5), "hierarchical"),
    (b"\x89PNG\r\n\x1a\n" + bytes(32), "PNG"),
    (b"GIF89a" + bytes(32), "not a JPEG"),
])
def test_other_refused_forms(data, form):
    with pytest.raises(NotPortedError, match="queue 1 item 8") as e:
        jpeg.decode_jpeg(data)
    assert form in str(e.value)


def test_truncated_and_garbage_data_raise():
    data = _read("news_a_320x240_420.jpg")
    cuts = (len(data) // 2, len(data) - 2, 100, 2)
    for cut in cuts:
        with pytest.raises(ValueError, match="queue 1 item 8"):
            jpeg.decode_jpeg(data[:cut])
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="corrupt or truncated"):
        jpeg.decode_jpeg(b"\xff\xd8" + rng.bytes(4000))
    # a scan whose entropy-coded bytes were overwritten
    bad = bytearray(data)
    sos = bad.index(b"\xff\xda")
    bad[sos + 20:sos + 2000] = rng.integers(0, 255, 1980, np.uint8).tobytes()
    with pytest.raises(ValueError, match="corrupt or truncated"):
        jpeg.decode_jpeg(bytes(bad))


def _segments(data):
    """(offset, marker) of each header segment, up to and including SOS."""
    i, out = 2, []
    while True:
        marker, length = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        out.append((i, marker))
        if marker == 0xDA:
            return out
        i += 2 + length


def _with_dc_table(data, counts):
    """data with a DC table 0 of these code counts (lengths 1, 2, ...)
    defined just before its scan, so the scan decodes with it."""
    sos = [i for i, m in _segments(data) if m == 0xDA][0]
    nv = sum(counts)
    seg = (b"\xff\xc4" + (19 + nv).to_bytes(2, "big") + b"\x00"
           + bytes(counts) + bytes(16 - len(counts)) + bytes(range(nv)))
    return data[:sos] + seg + data[sos:]


@pytest.mark.parametrize("counts", [[2], [3], [255], [1, 3], [0, 4]])
def test_malformed_huffman_table_is_refused_as_pillow_refuses_it(counts):
    """A table with more codes of a length than that length holds, or with
    an all-ones code (libjpeg's rule), is corrupt: checked before it fills
    the decoder's lookup table (255 codes of length 1 would write ~130 KB
    past it)."""
    f = io.BytesIO()
    Image.fromarray(_scene(16, 16, 0)).save(f, "JPEG", subsampling=0)
    data = _with_dc_table(f.getvalue(), counts)
    with pytest.raises(OSError):
        _pillow(data)
    with pytest.raises(ValueError, match="corrupt or truncated.*Huffman"):
        jpeg.decode_jpeg(data)


def _frame_size_patched(h, w):
    data = bytearray(_read("news_a_320x240_420.jpg"))
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = h.to_bytes(2, "big") + w.to_bytes(2, "big")
    return bytes(data)


@pytest.mark.parametrize("hw", [(65535, 65535), (13378, 13378)])
def test_frame_above_the_pixel_limit_is_refused_as_pillow_refuses_it(hw):
    """Pillow's Image.open raises DecompressionBombError above 178956970
    pixels; the port refuses the header before allocating anything."""
    data = _frame_size_patched(*hw)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    with pytest.raises(ValueError, match="decompression-bomb limit"):
        jpeg.decode_jpeg(data)


def test_frame_whose_scan_cannot_hold_its_blocks_fails_before_decoding():
    """A frame just under the pixel limit (13377 x 13377) over a 320 x 240
    photo's bytes: its scan needs at least 2 bits a block, and fails on
    that before any plane is allocated or block decoded."""
    with pytest.raises(ValueError, match="too short for its scan"):
        jpeg.decode_jpeg(_frame_size_patched(13377, 13377))


@pytest.mark.parametrize("keep", [0.3, 0.6])
def test_truncated_scan_fails_in_the_row_it_runs_out_in(keep):
    """Data that runs out is caught at the end of that MCU row, not after
    the scan's last row."""
    data = _read("news_a_320x240_420.jpg")
    sos = [i for i, m in _segments(data) if m == 0xDA][0]
    cut = sos + int((len(data) - sos) * keep)
    with pytest.raises(ValueError, match="MCU row") as e:
        jpeg.decode_jpeg(data[:cut])
    row, rows = map(int, str(e.value).split("MCU row ")[1].split(")")[0]
                    .split(" of "))
    assert rows == 15 and row < rows


def test_decoder_is_clean_under_address_sanitizer(tmp_path):
    """The decoder's source built with AddressSanitizer and UBSan
    (fixtures/images/fuzz_jpeg.cpp) over four fixtures, the crafted
    tables and frames above, and 4000 seeded random edits of them: no
    sanitizer report and no crash (status codes are the fuzzer's to
    count)."""
    inputs = [os.path.join(FIXTURES, n) for n in (
        "news_a_320x240_420.jpg", "rgb_101x67_444.jpg", "rgb_9x7_422.jpg",
        "restart_rows_67x101_444.jpg")]
    f = io.BytesIO()
    Image.fromarray(_scene(16, 16, 0)).save(f, "JPEG", subsampling=0)
    crafted = {"dht255.jpg": _with_dc_table(f.getvalue(), [255]),
               "dht_len2.jpg": _with_dc_table(f.getvalue(), [0, 4]),
               "bomb.jpg": _frame_size_patched(65535, 65535),
               "short_scan.jpg": _frame_size_patched(13377, 13377)}
    for name, data in crafted.items():
        (tmp_path / name).write_bytes(data)
        inputs.append(str(tmp_path / name))
    exe = tmp_path / "fuzz_jpeg"
    build = subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", f'-DJPEG_SRC="{jpeg.SOURCE}"',
         os.path.join(FIXTURES, "fuzz_jpeg.cpp"), "-o", str(exe)],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-2000:]
    run = subprocess.run(
        [str(exe), "4000", "0", *inputs], capture_output=True, text=True,
        timeout=120, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert run.returncode == 0, run.stderr[-3000:]
    assert "Sanitizer" not in run.stderr and "runtime error" not in run.stderr
    assert "mutations 4000 decoded" in run.stdout
    assert "news_a_320x240_420.jpg: status 0" in run.stdout
    assert "dht255.jpg: status 2" in run.stdout
    assert "bomb.jpg: status 4" in run.stdout


def test_library_builds_into_an_empty_directory(tmp_path):
    lib = jpeg.load_library(tmp_path / "build")
    names = [p.name for p in (tmp_path / "build").iterdir()]
    assert len(names) == 1 and names[0].startswith("libtnt_jpeg_")
    assert lib.tnt_jpeg_decode is not None


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch):
    src = tmp_path / "jpeg.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(jpeg, "SOURCE", src)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        jpeg.load_library(tmp_path / "build")
