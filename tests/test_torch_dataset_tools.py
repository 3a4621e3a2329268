"""The port's host-side dataset tools against tell_tpu's, run in-process
through both tools' main(): the NYTimes scraper (tell_tpu_torch/tools/
get_articles_nytimes.py against tools/get_articles_nytimes.py) with
urllib.request.urlopen patched to the Archive API answers, article pages
and images this test writes; process_images (tell_tpu_torch/tools/
process_images.py against tools/process_images.py) over the image
fixtures and a few more sources. Tolerance: none; the articles JSONL and
images byte-equal, JPEG outputs byte-equal, PNG outputs pixel-equal, the
same failures but the JPEG form the port refuses by name."""
import base64
import hashlib
import io
import json
import os
import shutil
import sys
from urllib.parse import urlparse

import numpy as np
import pytest
from PIL import Image, PngImagePlugin

from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.data.images import decode_image
from tell_tpu_torch.tools import get_articles_nytimes as port_scraper
from tell_tpu_torch.tools import process_images as port_process
from tools import get_articles_nytimes as ref_scraper
from tools import process_images as ref_process

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "images")
with open(os.path.join(FIXTURES, "news_a_320x240_420.jpg"), "rb") as _f:
    PHOTO = _f.read()

PAGES = {
    "https://www.nytimes.com/2019/01/02/two-photos.html": """
<html><body><h1>Two Photos</h1><article>
  <div class="StoryBodyCompanionColumn"><div><p>First paragraph.</p>
  <p>Second &amp; last paragraph.</p></div></div>
  <figure><img src="http://img.example/a.jpg"><figcaption>A photo.
  </figcaption></figure>
  <figure><figcaption>A caption with no image.</figcaption></figure>
  <div class="StoryBodyCompanionColumn"><p>After.</p>
  <figure><img src="https://img.example/b.png"><figcaption>B, a PNG.
  </figcaption></figure></div>
</article></body></html>""",
    "https://www.nytimes.com/2019/01/03/old-layout.html": """
<html><body><h1>Old News</h1>
  <p class="story-body-text">Para one.</p>
  <figure class="media"><img src="http://img.example/a.jpg">
    <figcaption>The same photo again.</figcaption></figure>
  <p class="story-body-text">Para two.</p>
</body></html>""",
    "https://www.nytimes.com/2019/02/01/no-image.html": """
<html><body><h1>Text only</h1>
  <p class="story-body-text">Nothing to see.</p></body></html>""",
    "https://www.nytimes.com/2019/02/02/no-text.html": """
<html><body><h1>Empty</h1><div><p>plain</p></div></body></html>""",
}
IMAGES = {"http://img.example/a.jpg": PHOTO,
          "https://img.example/b.png": b"\x89PNG\r\n\x1a\n not really"}
DOCS = {
    (2019, 1): [
        {"_id": "nyt://article/1",
         "web_url": "https://www.nytimes.com/2019/01/02/two-photos.html",
         "pub_date": "2019-01-02T05:00:00+0000"},
        {"web_url": "https://www.nytimes.com/2019/01/03/old-layout.html"},
        {"_id": "nyt://article/no-url"},
        {"_id": "nyt://article/offsite",
         "web_url": "https://example.com/2019/01/04/x.html"},
        {"_id": "nyt://article/down",
         "web_url": "https://www.nytimes.com/2019/01/05/down.html"}],
    (2019, 2): [
        {"_id": "nyt://article/3",
         "web_url": "https://www.nytimes.com/2019/02/01/no-image.html"},
        {"_id": "nyt://article/4",
         "web_url": "https://www.nytimes.com/2019/02/02/no-text.html"}],
}


class _Answer:
    def __init__(self, data: bytes):
        self._data = data

    def read(self):
        return self._data


def _urlopen(req, timeout=None):
    """The network as this test writes it: the Archive API, the article
    pages and their images; anything else fails to fetch."""
    url = req.full_url if hasattr(req, "full_url") else req
    p = urlparse(url)
    if p.hostname == "api.nytimes.com":
        year, month = p.path.split("/")[-2:]
        docs = DOCS.get((int(year), int(month.split(".")[0])), [])
        return _Answer(json.dumps({"response": {"docs": docs}}).encode())
    if url in PAGES:
        return _Answer(PAGES[url].encode())
    if url in IMAGES:
        return _Answer(IMAGES[url])
    raise OSError(f"no route to {url}")


def _run(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    assert main() == 0
    return capsys.readouterr().out


def _files(directory):
    return {n: open(os.path.join(directory, n), "rb").read()
            for n in sorted(os.listdir(directory))}


@pytest.mark.parametrize("images", [True, False], ids=["images", "inline"])
def test_scraper_equals_tell_tpu(tmp_path, monkeypatch, capsys, images):
    monkeypatch.setattr("urllib.request.urlopen", _urlopen)
    out = {}
    for name, tool in (("ref", ref_scraper), ("port", port_scraper)):
        argv = ["--key", "K", "--start", "2018-12", "--end", "2019-02",
                "--out", str(tmp_path / f"{name}.jsonl"), "--sleep", "0"]
        if images:
            argv += ["--images-out", str(tmp_path / f"{name}_images")]
        out[name] = _run(tool.main, argv, monkeypatch, capsys)
    assert out["port"] == out["ref"]
    assert out["port"].splitlines()[-1] == "wrote 2 articles"
    ref = (tmp_path / "ref.jsonl").read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == ref
    arts = [json.loads(line) for line in ref.decode().splitlines()]
    assert [a["image_positions"] for a in arts] == [[2, 4], [1]]
    hashes = {arts[0]["parsed_section"][2]["hash"],
              arts[1]["parsed_section"][1]["hash"]}
    assert hashes == {port_scraper.image_hash("http://img.example/a.jpg")}
    if images:
        got = _files(tmp_path / "port_images")
        assert got == _files(tmp_path / "ref_images")
        assert got[f"{hashes.pop()}.jpg"] == PHOTO
        assert all("image_data" not in s for a in arts
                   for s in a["parsed_section"])
    else:
        assert base64.b64decode(
            arts[0]["parsed_section"][2]["image_data"]) == PHOTO


def test_scraper_appends_as_tell_tpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("urllib.request.urlopen", _urlopen)
    for name, tool in (("ref", ref_scraper), ("port", port_scraper)):
        path = tmp_path / f"{name}.jsonl"
        path.write_text('{"kept": true}\n')
        for _ in range(2):
            _run(tool.main, ["--key", "K", "--start", "2019-01", "--end",
                             "2019-01", "--out", str(path), "--sleep", "0",
                             "--append"], monkeypatch, capsys)
    ref = (tmp_path / "ref.jsonl").read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == ref
    assert len(ref.splitlines()) == 5


def test_months_equal_tell_tpu():
    for span in (("2018-11", "2019-02"), ("2019-03", "2019-03"),
                 ("2019-04", "2019-01")):
        assert (list(port_scraper.months(*span))
                == list(ref_scraper.months(*span)))


def _jpeg(rgb, **kw):
    f = io.BytesIO()
    Image.fromarray(rgb).save(f, **kw)
    return f.getvalue()


def _extra_sources():
    """Sources beyond the fixtures: names in other cases and extensions,
    comments Pillow carries into the output, a PNG and a GIF under .jpg
    names, and files that are no image."""
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (300, 280, 3), dtype=np.uint8)
    info = PngImagePlugin.PngInfo()
    info.add_text("comment", "from a PNG, caf\xe9")
    return {
        "upper.JPG": _jpeg(rgb, format="JPEG", quality=90),
        "commented.jpeg": _jpeg(rgb, format="JPEG", comment=b"a COM marker"),
        "png_named.jpg": _jpeg(rgb[:100], format="PNG", pnginfo=info),
        "grey.jpe": _jpeg(rgb[..., 0], format="JPEG"),
        "tiny.jfif": _jpeg(rgb[:3, :2], format="JPEG"),
        "gif_named.jpg": _jpeg(rgb[:50, :60], format="GIF"),
        "notes.txt": b"not an image",
        "empty.png": b"",
    }


def _raw_dir(tmp_path):
    raw = tmp_path / "raw"
    shutil.copytree(FIXTURES, raw)
    for name, data in _extra_sources().items():
        (raw / name).write_bytes(data)
    return raw


def test_process_images_equals_tell_tpu(tmp_path, monkeypatch, capsys):
    raw = _raw_dir(tmp_path)
    lines = {}
    for name, tool in (("ref", ref_process), ("port", port_process)):
        lines[name] = _run(tool.main, ["--images", str(raw), "--out",
                                       str(tmp_path / name)],
                           monkeypatch, capsys)
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    # tell_tpu opens these with Pillow; the port refuses their forms by
    # name and counts them failed
    refused = {"refused_progressive_unrefined.jpg", "gif_named.jpg"}
    assert set(port) == set(ref) - refused
    n_ok, n_bad = len(ref), len(os.listdir(raw)) - len(ref)
    assert lines["ref"] == f"processed {n_ok} images ({n_bad} failed)\n"
    assert lines["port"] == (f"processed {n_ok - 2} images "
                             f"({n_bad + 2} failed)\n")
    for name, data in port.items():
        if name.endswith(".png"):
            assert np.array_equal(decode_image(data), decode_image(ref[name]))
        else:
            assert data == ref[name], name
    for name in refused:
        with pytest.raises(NotPortedError):
            decode_image((raw / name).read_bytes())
    assert b"a COM marker" in port["commented.jpeg"]
    assert "from a PNG, caf\xe9".encode() in port["png_named.jpg"]


def test_process_images_writes_the_committed_digests(tmp_path, monkeypatch,
                                                     capsys):
    """The port's process_images over the sources of processed/ writes
    the files tell_tpu's did (the manifest's digests)."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    raw = tmp_path / "raw"
    raw.mkdir()
    want = {}
    for name, entry in manifest.items():
        if "processed" in entry:
            dst = name.replace(".", "_") + ".jpg"   # every output a JPEG
            shutil.copy(os.path.join(FIXTURES, name), raw / dst)
            want[dst] = entry["processed"]
    out = _run(port_process.main, ["--images", str(raw), "--out",
                                   str(tmp_path / "out")],
               monkeypatch, capsys)
    assert out == f"processed {len(want)} images (0 failed)\n"
    for dst, entry in want.items():
        data = (tmp_path / "out" / dst).read_bytes()
        assert hashlib.sha256(data).hexdigest() == entry["sha256"]
        with open(os.path.join(FIXTURES, entry["file"]), "rb") as f:
            assert f.read() == data


@pytest.mark.parametrize("ext", [".txt", ".gif", ".webp", ""])
def test_output_extension_the_port_does_not_write_raises(tmp_path, ext):
    """The port writes JPEG and PNG only and raises for any other output
    extension, naming it; tell_tpu's save raises for an extension Pillow
    does not know and writes the formats it knows."""
    src = tmp_path / "photo.jpg"
    src.write_bytes(PHOTO)
    with pytest.raises(NotPortedError, match="JPEG and PNG only"):
        port_process.process_image(str(src), str(tmp_path / f"out{ext}"))
    if ext in (".gif", ".webp"):
        assert ref_process.process_image(str(src), str(tmp_path / f"r{ext}"))
    else:
        with pytest.raises(ValueError, match="unknown file extension"):
            ref_process.process_image(str(src), str(tmp_path / f"r{ext}"))
