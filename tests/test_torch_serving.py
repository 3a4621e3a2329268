"""The port's CaptionService over a real local HTTP socket.

Micro-batch mode: three concurrent POST /caption requests with context_ids
and features (some faces/objects NaN) must come back with exactly the
token ids of the port's own generate on the same batch; bad requests are
reported per request without failing their micro-batch, including face or
object rows of the wrong rank or width in a micro-batch with good ones.

Engine mode (int8 K/V cache, fused top-k, article buckets 16/32/64):
concurrent requests of three widths must come back, best beam and
alternatives, with exactly the token ids of the port's one-shot
beam_search on the same encoded features and numerics, each routed to the
smallest bucket that holds it; GET /status and /healthz report, and
numerics_ab gives each lever's agreement.

Micro-batch article bucketing: a micro-batch is packed at the smallest of
128/256/512 that holds it, the width tell_tpu's _pack picks for the same
token counts, and its captions equal those packed at article_len.
"""
import dataclasses
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tell_tpu_torch.bridge import init_captioner, init_roberta
from tell_tpu_torch.config import ContextSpec, small_test_config
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder)
from tell_tpu_torch.models.beam import beam_search
from tell_tpu_torch.models.captioner import encode_contexts
from tell_tpu_torch.serving import CaptionService, MicroBatcher, serve
from tell_tpu_torch.config import with_article_len

torch.set_num_threads(2)
_base = small_test_config(gen_len=6)
CFG = dataclasses.replace(_base, decoder=dataclasses.replace(
    _base.decoder, contexts=(ContextSpec("image", 32, 9),
                             ContextSpec("article", 32, 16),
                             ContextSpec("faces", 16, 4),
                             ContextSpec("obj", 32, 8))))
RCFG = RobertaConfig(vocab_size=500, dim=32, num_layers=2, num_heads=2,
                     ffn_dim=64, max_positions=20)


class _WordTokenizer:
    """Stand-in tokenizer: one id per word, ids joined back as text."""

    def encode(self, text, max_len):
        return [0] + [3 + len(w) for w in text.split()][: max_len - 2] + [2]

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def service():
    g = torch.Generator().manual_seed(0)
    svc = CaptionService(init_captioner(g, CFG),
                         RobertaEncoder(init_roberta(g, RCFG), RCFG), CFG,
                         "cpu", max_batch=4, article_len=16)
    yield svc
    svc.close()


def _requests():
    rng = np.random.default_rng(0)
    reqs = []
    for n_ids, n_faces in ((16, 4), (9, 1), (3, 0)):
        obj = rng.normal(size=(8, 32))
        obj[5:] = np.nan
        reqs.append({
            "context_ids": [0] + rng.integers(3, 500, n_ids - 1).tolist(),
            "image_grid": rng.normal(size=(9, 32)).tolist(),
            "face_embeds": rng.normal(size=(n_faces, 16)).tolist(),
            # NaN rows mark absent objects; JSON carries them as NaN
            "obj_embeds": obj.tolist(),
        })
    return reqs


def _post(port, path, payload, method="POST"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        if method == "POST":
            conn.request("POST", path, json.dumps(payload),
                         {"Content-Type": "application/json"})
        else:
            conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _concurrent(port, reqs):
    answers = [None] * len(reqs)

    def post(i):
        answers[i] = _post(port, "/caption", reqs[i])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return answers


def test_microbatcher_coalesces():
    calls = []

    def run(batch):
        calls.append(len(batch))
        time.sleep(0.02)
        return [x * 2 for x in batch]

    mb = MicroBatcher(run, max_batch=8, max_wait_ms=50)
    futs = [mb.submit(i) for i in range(12)]
    assert [f.result(timeout=5) for f in futs] == [i * 2 for i in range(12)]
    assert len(calls) <= 4
    mb.shutdown()


def test_http_captions_match_generate(service):
    reqs = _requests()
    httpd = serve(service, port=0, block=False)
    port = httpd.server_address[1]
    answers = [None] * len(reqs)

    def post(i):
        answers[i] = _post(port, "/caption", reqs[i])

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        httpd.shutdown()
        httpd.server_close()
    # the same requests as one batch through the port's generate
    batch, errors = service._pack(reqs)
    assert errors == [None] * len(reqs)
    with torch.inference_mode():
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        ref = service.model.generate(
            encode_contexts(service.roberta.frozen(), CFG, tb))["token_ids"]
    for i, (status, body) in enumerate(answers):
        assert status == 200, body
        assert "error" not in body
        assert len(body["token_ids"]) == CFG.gen_len + 1
        assert body["token_ids"] == ref[i].tolist()


def test_bad_requests_are_reported_per_request(service):
    out = service.caption({"context_ids": [0, 7, 10 ** 6]})
    assert "outside" in out["error"]
    out = service.caption({"context": "no tokenizer here"})
    assert "tokenizer" in out["error"]
    out = service.caption({"context_ids": [0, 5], "face_embeds": [[1.0] * 3]})
    assert "face_embeds" in out["error"]
    assert len(out["token_ids"]) == CFG.gen_len + 1


@pytest.mark.parametrize("key,rows", [
    ("face_embeds", [0.5] * 16),             # 1-D, not [n, 16]
    ("face_embeds", [[0.5] * 17] * 2),       # wider than the faces' 16
    ("obj_embeds", [[0.5] * 31] * 3),        # narrower than the objects' 32
])
def test_bad_feature_rows_are_isolated_in_their_micro_batch(service, key,
                                                            rows):
    """One micro-batch (CaptionService._run, what MicroBatcher calls) with
    a request whose face/object rows have the wrong rank or width between
    two good ones: the bad request gets an error naming the field and no
    such rows; each good request's token ids equal its caption served
    alone."""
    good = _requests()[:2]
    bad = dict(good[0], **{key: rows})
    out = service._run([good[0], bad, good[1]])
    assert f"bad {key}" in out[1]["error"]
    assert len(out[1]["token_ids"]) == CFG.gen_len + 1
    for i, req in ((0, good[0]), (2, good[1])):
        assert "error" not in out[i]
        assert out[i]["token_ids"] == service._run([req])[0]["token_ids"]


def test_text_requests_with_a_tokenizer_and_shutdown(service):
    g = torch.Generator().manual_seed(1)
    svc = CaptionService(init_captioner(g, CFG),
                         RobertaEncoder(init_roberta(g, RCFG), RCFG), CFG,
                         "cpu", tokenizer=_WordTokenizer(), max_batch=2,
                         article_len=16)
    httpd = serve(svc, port=0, block=False)
    port = httpd.server_address[1]
    status, body = _post(port, "/caption", {"context": "the city news"})
    assert status == 200
    assert body["caption"] == _WordTokenizer().decode(body["token_ids"])
    assert _post(port, "/nope", {})[0] == 404
    assert _post(port, "/shutdown", {})[0] == 200
    deadline = time.time() + 10
    while svc.batcher._thread.is_alive() and time.time() < deadline:
        time.sleep(0.05)
    assert not svc.batcher._thread.is_alive()
    httpd.server_close()


@pytest.fixture(scope="module")
def engine_service():
    g = torch.Generator().manual_seed(2)
    svc = CaptionService(init_captioner(g, CFG),
                         RobertaEncoder(init_roberta(g, RCFG), RCFG), CFG,
                         "cpu", article_len=64, engine_slots=2,
                         engine_beam=2, engine_buckets=True, encode_batch=2,
                         kv_cache="int8", fused_topk=True)
    yield svc
    svc.close()


def test_engine_http_answers_match_one_shot_beam_search(engine_service):
    svc = engine_service
    reqs = _requests()
    rng = np.random.default_rng(1)
    # articles of 60, 16, 9 and 3 ids: buckets 64, 16, 16, 16
    reqs[0]["context_ids"] = [0] + rng.integers(3, 500, 59).tolist()
    reqs.append({"context_ids": [0, 5, 9]})
    reqs[1]["context_ids"] = reqs[1]["context_ids"] + [7] * 14  # 30: 32
    httpd = serve(svc, port=0, block=False)
    port = httpd.server_address[1]
    try:
        answers = _concurrent(port, reqs)
        status = _post(port, "/status", None, method="GET")
        health = _post(port, "/healthz", None, method="GET")
    finally:
        httpd.shutdown()
        httpd.server_close()
    for req, (code, body) in zip(reqs, answers):
        assert code == 200 and "error" not in body, body
        batch, errors = svc._pack([req], bucketed=True)
        assert errors == [None]
        width = batch["context_ids"].shape[1]
        with torch.inference_mode():
            ref = beam_search(svc.model.tree(), with_article_len(CFG, width),
                              svc._encode_many(batch), beam_size=2,
                              kv_cache="int8", fused_topk=True)
        beams = [body] + body["alternatives"]
        assert [b["token_ids"] for b in beams] == ref["token_ids"][0].tolist()
        np.testing.assert_allclose([b["score"] for b in beams],
                                   ref["scores"][0].numpy(), rtol=1e-5)
    assert health == (200, {"status": "ok"})
    code, st = status
    assert code == 200
    assert st["config"]["kv_cache_mode"] == "int8"
    assert st["config"]["topk_mode"] == "fused"
    assert st["engine"]["slots"] == 2 and st["engine"]["beam"] == 2
    routed = {w: b["requests"] for w, b in st["engine_buckets"].items()}
    assert routed == {"16": 2, "32": 1, "64": 1}


def test_engine_numerics_ab_reports_each_lever(engine_service):
    report = engine_service.numerics_ab(_requests()[:2])
    for key in ("kv8_token_agreement", "kv4_token_agreement",
                "fused_topk_token_agreement"):
        assert 0.0 <= report[key] <= 1.0
    assert report["fused_topk_token_agreement"] == 1.0   # exact route
    assert report["tokens"] > 0 and report["method"] == "forced_per_step"
    assert engine_service.status()["numerics_ab"] is report


def test_engine_bad_request_is_reported(engine_service):
    out = engine_service.caption({"context_ids": [0, 7, 10 ** 6]})
    assert "outside" in out["error"] and out["token_ids"] == []


# -- micro-batch article bucketing (tell_tpu/serving/server.py:345-355) ---

LONG_CFG = with_article_len(CFG, 512)
LONG_RCFG = dataclasses.replace(RCFG, max_positions=520)
WORDS = (1, 98, 126, 127, 254, 255, 400, 510, 700)   # + <s> and </s>


class _CountTokenizer:
    """n words -> <s> + n ids + </s> (truncated to max_len), both packages'
    tokenizer interface."""

    def encode(self, text, max_len):
        return ([0] + [3 + len(w) % 400 for w in text.split()][: max_len - 2]
                + [2])

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def bucket_service():
    g = torch.Generator().manual_seed(3)
    svc = CaptionService(init_captioner(g, LONG_CFG),
                         RobertaEncoder(init_roberta(g, LONG_RCFG),
                                        LONG_RCFG),
                         LONG_CFG, "cpu", tokenizer=_CountTokenizer(),
                         max_batch=4)
    yield svc
    svc.close()


def _text(n):
    return " ".join("w" * (1 + i % 7) for i in range(n))


def test_micro_batch_bucket_equals_jax(bucket_service):
    """The width a micro-batch is packed at equals tell_tpu's _pack for the
    same token counts, one request alone and mixed micro-batches."""
    import jax
    from tell_tpu.models.backbones.roberta import RobertaConfig as JRoberta
    from tell_tpu.models.backbones.roberta import init_roberta as j_roberta
    from tell_tpu.models.captioner import init_captioner as j_captioner
    from tell_tpu.serving.server import CaptionService as JService
    port_fields = dataclasses.asdict(LONG_RCFG)
    port_fields.pop("gelu")                       # tell_tpu: an env switch
    jrcfg = JRoberta(**port_fields)
    jsvc = JService(j_captioner(jax.random.PRNGKey(0), LONG_CFG),
                    {"roberta": j_roberta(jax.random.PRNGKey(1), jrcfg),
                     "roberta_cfg": jrcfg}, LONG_CFG, _CountTokenizer(),
                    max_batch=4)
    try:
        assert jsvc._article_buckets == bucket_service._article_buckets \
            == (128, 256, 512)
        batches = [[n] for n in WORDS] + [
            [1, 98], [1, 127, 40], [254, 1, 2, 3], [255, 1], [700, 1]]
        widths = []
        for counts in batches:
            reqs = [{"context": _text(n)} for n in counts]
            jb, _ = jsvc._pack(reqs + [{"context": ""}] * (4 - len(reqs)))
            tb, _ = bucket_service._pack(reqs + [{}] * (4 - len(reqs)),
                                         bucketed=True)
            assert tb["context_ids"].shape == jb["context_ids"].shape
            # the real rows (tell_tpu fills with empty text, the port with
            # empty requests)
            n = len(reqs)
            assert np.array_equal(tb["context_ids"][:n],
                                  jb["context_ids"][:n])
            widths.append(tb["context_ids"].shape[1])
        assert widths == [128, 128, 128, 256, 256, 512, 512, 512, 512,
                          128, 256, 256, 512, 512]
    finally:
        jsvc.close()


def test_micro_batch_at_its_bucket_equals_article_len(bucket_service,
                                                      monkeypatch):
    """_run packs a micro-batch at its bucket, and each request's tokens
    equal generate on the same requests packed at article_len (pad
    columns are masked); warmup drives every bucket."""
    from tell_tpu_torch.models.captioner import generate
    packed = []
    pack = bucket_service._pack

    def spy(requests, bucketed=False):
        batch, errors = pack(requests, bucketed)
        packed.append(batch["context_ids"].shape[1])
        return batch, errors

    monkeypatch.setattr(bucket_service, "_pack", spy)
    for counts, width in (((3, 100), 128), ((129, 40, 7), 256),
                          ((300,), 512)):
        reqs = [{"context": _text(n), "image_grid":
                 np.full((9, 32), 0.01 * n, np.float32).tolist()}
                for n in counts]
        served = bucket_service._run(reqs)
        assert packed[-1] == width
        batch, _ = bucket_service._pack(reqs + [{}] * (4 - len(reqs)))
        assert batch["context_ids"].shape[1] == 512
        batch["row_live"] = np.arange(4) < len(reqs)
        with torch.inference_mode():
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            enc = encode_contexts(bucket_service.roberta.frozen(), LONG_CFG,
                                  tb)
            want = generate(bucket_service.model.tree(), LONG_CFG, enc)[
                "token_ids"][:len(reqs)].numpy()
        assert [r["token_ids"] for r in served] == want.tolist()
    packed.clear()
    assert bucket_service.warmup()["widths"] == [128, 256, 512]
    assert packed == [128, 256, 512]


# -- scraped-article requests (tell_tpu/serving/server.py:264-283) -------

QUALITY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality")


@pytest.fixture(scope="module")
def quality_articles():
    with open(os.path.join(QUALITY, "articles.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()][:4]


def _sections_request(article, pos):
    return {"title": article["headline"]["main"],
            "sections": [{"type": s["type"], "text": s["text"]}
                         for s in article["parsed_section"]],
            "image_position": pos}


@pytest.mark.parametrize("article_len", [24, 64, 512])
def test_sections_request_ids_equal_jax(quality_articles, article_len):
    """A sections + title + image_position request packs the ids of
    tell_tpu's _context_text window followed by its tokenizer, for every
    image position and three budgets; its caption equals that of a context
    request holding the window's text; a malformed one is reported."""
    from types import SimpleNamespace

    from tell_tpu.data.tokenizer import RobertaTokenizer as JTokenizer
    from tell_tpu.serving.server import CaptionService as JService
    from tell_tpu_torch.data.tokenizer import RobertaTokenizer
    vocab, merges = (os.path.join(QUALITY, "vocab.json"),
                     os.path.join(QUALITY, "merges.txt"))
    jt = JTokenizer.from_files(vocab, merges, use_native=False)
    tt = RobertaTokenizer.from_files(vocab, merges)
    rcfg = dataclasses.replace(RCFG, vocab_size=708)
    g = torch.Generator().manual_seed(4)
    svc = CaptionService(init_captioner(g, CFG),
                         RobertaEncoder(init_roberta(g, rcfg), rcfg), CFG,
                         "cpu", tokenizer=tt, max_batch=2,
                         article_len=article_len)
    jself = SimpleNamespace(tokenizer=jt, article_len=article_len)
    try:
        for art in quality_articles:
            for pos in range(len(art["parsed_section"])):
                req = _sections_request(art, pos)
                text = JService._context_text(jself, req)
                want = jt.encode(text, max_len=article_len)
                assert svc._request_ids(req).tolist() == want
        req = _sections_request(quality_articles[0], 1)
        text = JService._context_text(jself, req)
        a, b = svc.caption(req), svc.caption({"context": text})
        assert "error" not in a and a["token_ids"] == b["token_ids"]
        bad = svc.caption({"sections": [{"text": 3}], "image_position": 2})
        assert "bad sections" in bad["error"]
    finally:
        svc.close()
