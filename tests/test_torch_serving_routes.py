"""The port server's /metrics, demo page and /scrape routes, its extractor
and its client, against tell_tpu on the CPU.

/metrics: the lines equal tell_tpu's _send_metrics for the same counters in
micro-batch and engine mode, and on a live server its counters equal
/status's after N requests. GET / and /index.html: the bytes of
demo/index.html (404 when it is missing). POST /scrape: 422, 502 and 200
with get_urls replaced by a stub, 422 from the real SSRF guard for a
file:// URL. extract_text: the sections and title of tell_tpu's bs4
parser on the two NYT layouts of tests/test_serving.py and eight more
pages; the SSRF guard's decisions equal tell_tpu's. The client round-trips
against the port's server, its parse() equal to direct POSTs.
"""
import dataclasses
import http.client
import io
import json
import types

import numpy as np
import pytest
import torch

from tell_tpu.serving import extractor as jx
from tell_tpu.serving.server import _Handler as JHandler
from tell_tpu_torch.bridge import init_captioner, init_roberta
from tell_tpu_torch.config import ContextSpec, small_test_config
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder)
from tell_tpu_torch.serving import (CaptioningClient, CaptionService,
                                    ClientError, serve)
from tell_tpu_torch.serving import extractor as tx
from tell_tpu_torch.serving import server as tserver

torch.set_num_threads(2)
_base = small_test_config(gen_len=4)
CFG = dataclasses.replace(_base, decoder=dataclasses.replace(
    _base.decoder, contexts=(ContextSpec("image", 32, 9),
                             ContextSpec("article", 32, 16),
                             ContextSpec("faces", 16, 4),
                             ContextSpec("obj", 32, 8))))
RCFG = RobertaConfig(vocab_size=500, dim=32, num_layers=2, num_heads=2,
                     ffn_dim=64, max_positions=20)


def _jax_metrics(service) -> str:
    """tell_tpu's /metrics body for `service`, from its handler method."""
    out = io.BytesIO()
    fake = types.SimpleNamespace(
        service=service, wfile=out, send_response=lambda code: None,
        send_header=lambda k, v: None, end_headers=lambda: None)
    JHandler._send_metrics(fake)
    return out.getvalue().decode()


@pytest.mark.parametrize("engine", [False, True], ids=["micro", "engine"])
def test_metrics_lines_equal_jax(engine):
    svc = types.SimpleNamespace(
        batcher=types.SimpleNamespace(stats={"requests": 17, "batches": 5,
                                             "errors": 2}),
        engine=types.SimpleNamespace(stats={"requests": 9, "chunks": 40},
                                     free=[0, 3, 5]) if engine else None)
    ours = tserver.metrics_text(svc)
    assert ours == _jax_metrics(svc)
    assert ("tnt_engine_free_slots 3" in ours) == engine
    assert ours.splitlines()[2] == "tnt_requests_total 17"


@pytest.fixture(scope="module")
def server():
    g = torch.Generator().manual_seed(0)
    svc = CaptionService(init_captioner(g, CFG),
                         RobertaEncoder(init_roberta(g, RCFG), RCFG), CFG,
                         "cpu", max_batch=4, article_len=16)
    httpd = serve(svc, port=0, block=False)
    yield svc, httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    svc.close()


def _request(path, port, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        if payload is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, json.dumps(payload),
                         {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _articles(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"context_ids": [0] + rng.integers(3, 500, 14).tolist() + [2],
             "image_grid": rng.normal(size=(9, 32)).round(4).tolist(),
             "face_embeds": rng.normal(size=(2, 16)).round(4).tolist(),
             "obj_embeds": rng.normal(size=(5, 32)).round(4).tolist()}
            for _ in range(n)]


def test_metrics_counters_equal_status_after_requests(server):
    svc, port = server
    for req in _articles(3, seed=1):
        status, _, body = _request("/caption", port, req)
        assert status == 200 and "error" not in json.loads(body)
    status, ctype, body = _request("/metrics", port)
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    text = body.decode()
    assert text == tserver.metrics_text(svc) == _jax_metrics(svc)
    values = {line.split()[0]: int(line.split()[1])
              for line in text.splitlines() if not line.startswith("#")}
    st = json.loads(_request("/status", port)[2])["statistics"]
    assert values == {"tnt_requests_total": st["requests"],
                      "tnt_batches_total": st["batches"],
                      "tnt_errors_total": st["errors"]}
    assert st["requests"] >= 3


def test_demo_page_is_served(server, monkeypatch):
    _, port = server
    with open(tserver.DEMO_PAGE, "rb") as f:
        page = f.read()
    for path in ("/", "/index.html"):
        status, ctype, body = _request(path, port)
        assert (status, ctype, body) == (200, "text/html; charset=utf-8",
                                         page)
    monkeypatch.setattr(tserver, "DEMO_PAGE", tserver.DEMO_PAGE + ".gone")
    status, _, body = _request("/", port)
    assert (status, json.loads(body)) == (404,
                                          {"error": "demo page missing"})


def test_scrape_answers_422_502_and_200(server, monkeypatch):
    _, port = server
    status, _, body = _request("/scrape", port, {"url": "file:///etc/passwd"})
    assert status == 422 and "scheme" in json.loads(body)["error"]

    def stub(url):
        if "bad" in url:
            raise tx.ExtractError("No headline found.")
        if "down" in url:
            raise OSError("connection refused")
        return {"sections": [], "title": url, "image_urls": []}

    monkeypatch.setattr(tx, "get_urls", stub)
    got = {u: _request("/scrape", port, {"url": u})
           for u in ("https://www.nytimes.com/bad", "https://nytimes.com/down",
                     "https://www.nytimes.com/ok")}
    status, _, body = got["https://www.nytimes.com/bad"]
    assert (status, json.loads(body)) == (422,
                                          {"error": "No headline found."})
    status, _, body = got["https://nytimes.com/down"]
    assert status == 502 and json.loads(body) == {
        "error": "fetch failed: connection refused"}
    status, _, body = got["https://www.nytimes.com/ok"]
    assert status == 200 and json.loads(body)["title"].endswith("/ok")


def test_client_round_trips_against_the_server(server, monkeypatch):
    _, port = server
    client = CaptioningClient(port=port, timeout=120)
    st = client.status()
    assert st["config"]["max_batch"] == 4 and st["config"]["device"] == "cpu"
    arts = _articles(4, seed=2)
    direct = [json.loads(_request("/caption", port, a)[2]) for a in arts]
    parsed = client.parse(arts)
    assert [p["token_ids"] for p in parsed] == [d["token_ids"]
                                                for d in direct]
    assert client.caption(arts[0])["token_ids"] == direct[0]["token_ids"]
    monkeypatch.setattr(tx, "get_urls", lambda url: {"title": url})
    assert client.scrape("https://www.nytimes.com/x") == {
        "title": "https://www.nytimes.com/x"}
    monkeypatch.undo()
    with pytest.raises(ClientError, match="422"):
        client.scrape("file:///etc/passwd")


NEW_LAYOUT = """
<html><body><h1>Big News</h1><article>
  <div class="StoryBodyCompanionColumn"><div><p>First paragraph.</p>
  <p>Second paragraph.</p></div></div>
  <figure><img src="http://x/y.jpg"><figcaption>A photo.</figcaption>
  </figure>
</article></body></html>"""
OLD_LAYOUT = """
<html><body><h1>Old News</h1>
  <p class="story-body-text">Para one.</p>
  <figure class="media"><img src="http://x/z.jpg">
    <figcaption>Old photo.</figcaption></figure>
  <p class="story-body-text">Para two.</p>
</body></html>"""
PAGES = {
    "new_layout": NEW_LAYOUT,
    "old_layout": OLD_LAYOUT,
    "nested_tags": """<!DOCTYPE html><html><head><title>t</title>
      <script>var h1 = "<h1>no</h1>";</script></head><body>
      <header><h1>The <em>Nested</em> <a href="/x">Headline</a></h1></header>
      <article><div class="css-1 StoryBodyCompanionColumn">
      <section><div><p>A <b>bold <i>and italic</i></b> line<br>broken.</p>
      <p>Has <span>spans <span>within</span> spans</span>.
      <script>ignore("me")</script><!-- a comment --> After.</p></div>
      </section></div></article></body></html>""",
    "entities": """<h1>Caf&eacute; &amp; Bar &#8212; &quot;Q&quot;</h1>
      <p class="story-body-text">It&#39;s 5&nbsp;&lt;&nbsp;6 &copy; 2019,
      &#x2019;quoted&#x2019; &hellip;</p>""",
    "whitespace": """<h1>
          Spaced    Title
      </h1><p class="story-body-text">   </p>
      <p class="story-body-text">
         Lines
         and   tabs\t\there
      </p><p class="story-body-text">\n</p>""",
    "figure_without_caption": """<h1>Figures</h1><article>
      <div class="StoryBodyCompanionColumn"><p>Text.</p></div>
      <figure><img src="http://x/a.jpg"></figure>
      <figure><figcaption>No image here.</figcaption></figure>
      <figure><img><figcaption>Image without src.</figcaption></figure>
      </article>""",
    "several_figures": """<h1>Gallery</h1><article>
      <figure><img src="http://x/1.jpg"><figcaption>One</figcaption></figure>
      <div class="StoryBodyCompanionColumn"><p>Between.</p></div>
      <figure><img src="http://x/2.jpg"><figcaption>Two</figcaption></figure>
      <figure><img src="http://x/1.jpg"><figcaption>Again</figcaption>
      </figure>
      <div class="StoryBodyCompanionColumn"><p>After.</p>
      <figure><img src="http://x/3.jpg"/><figcaption>Three
      <span>credit</span></figcaption></figure></div></article>""",
    "old_several_figures": """<H1>Upper</H1>
      <figure><img src="http://x/a.jpg"><figcaption>A</figcaption></figure>
      <P CLASS="story-body-text">P1</P>
      <figure><img src="http://x/a.jpg"><figcaption>A again</figcaption>
      </figure><p class="other">skip</p>
      <p class="story-body-text story-body-text--x">P2 <p>nested</p></p>""",
    "unclosed_and_stray_tags": """<h1>Loose</h1></span><article>
      <div class="StoryBodyCompanionColumn"><p>One<p>Two</div>
      <p>Outside the column.</p></b></article>""",
    "no_article_text": """<h1>Only a title</h1><div><p>plain</p></div>""",
    "no_h1": """<html><body><h2>Not a headline</h2>
      <p class="story-body-text">x</p></body></html>""",
}


@pytest.mark.parametrize("name", sorted(PAGES))
def test_extract_text_equals_jax_bs4(name):
    html = PAGES[name]
    try:
        want = jx.extract_text(html)
    except jx.ExtractError as e:
        with pytest.raises(tx.ExtractError) as got:
            tx.extract_text(html)
        assert str(got.value) == str(e)
        return
    assert tx.extract_text(html) == want
    sections, _ = want
    for pos in range(sum(s["type"] == "caption" for s in sections)):
        assert tx.extract_article(sections, "t", pos) == jx.extract_article(
            sections, "t", pos)


URLS = ["https://www.nytimes.com/2019/a.html", "http://nytimes.com/x",
        "https://NYTimes.com/x", "https://evil-nytimes.com/x",
        "https://nytimes.com.evil.org/x", "file:///etc/passwd",
        "ftp://www.nytimes.com/x", "gopher://x", "//www.nytimes.com/x",
        "https://127.0.0.1/x", "http://static01.nyt.com/images/a.jpg",
        "https://user@www.nytimes.com:8443/x", "", "javascript:alert(1)"]


@pytest.mark.parametrize("require_nyt", [True, False])
def test_ssrf_guard_decides_as_jax(require_nyt):
    def decide(mod, url):
        try:
            mod._check_fetchable(url, require_nyt=require_nyt)
            return "ok"
        except mod.ExtractError as e:
            return str(e)

    ours = [decide(tx, u) for u in URLS]
    assert ours == [decide(jx, u) for u in URLS]
    assert ours[0] == "ok" and ours[5] != "ok"
