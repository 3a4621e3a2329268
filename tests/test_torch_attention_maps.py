"""Attention maps against tell_tpu on the CPU, and the services' payload.

* generate(need_weights=True): the tokens and every step's head-averaged
  maps, per layer and context, against tell_tpu's generate(need_weights=
  True) on its weights (atol = rtol = 1e-4, the same math in another
  order), with the full scan (no early exit) in both.
* the same over the int8 and int4 K/V caches (tell_tpu with
  TELL_TPU_KV8 / TELL_TPU_KV4 set for that trace only).
* replay_attention of the generated captions reproduces the port's own
  generate maps (rtol 1e-5, atol 1e-6, as tests/test_serving.py holds
  tell_tpu's replay).
* merge_word_attentions against tell_tpu's on the same ids and maps, with
  the quality corpus's tokenizer (equal words, maps within 1e-6).
* CaptionService(need_attention=True): a micro-batch answer carries the
  first layer's per-step maps of every context, each summing to 1 with 0
  on masked columns, and their word merge; the engine service's answer
  carries the replay of its own caption; and the engine service's replay
  of the micro-batch caption equals the micro-batch maps within 1e-5 (the
  two encode the article in batches of other sizes). /status reports
  need_attention; without a tokenizer the service refuses it.
"""
import dataclasses
import json
import os

import numpy as np
import jax
import pytest
import torch

from tell_tpu.models.captioner import (generate as j_generate,
                                       init_captioner as j_init)
from tell_tpu.serving import word_attention as j_wa
from tell_tpu_torch.bridge import init_captioner, init_roberta, to_numpy, \
    to_torch
from tell_tpu_torch.data.tokenizer import RobertaTokenizer
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder)
from tell_tpu_torch.models.captioner import generate, replay_attention
from tell_tpu_torch.serving import CaptionService
from tell_tpu_torch.serving import word_attention as t_wa
from tests.test_torch_serving import CFG as SERVE_CFG
from tests.test_torch_siblings import _batch, _cfg, _tb

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dataclasses.replace(_cfg("faces_objects"), gen_len=6)
QUALITY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality")
VOCAB, MERGES = (os.path.join(QUALITY, "vocab.json"),
                 os.path.join(QUALITY, "merges.txt"))
RCFG = RobertaConfig(vocab_size=708, dim=32, num_layers=2, num_heads=2,
                     ffn_dim=64, max_positions=20)


@pytest.fixture(scope="module")
def decoded():
    params = jax.jit(lambda r: j_init(r, CFG))(jax.random.PRNGKey(4))
    tparams = to_torch(jax.tree.map(np.asarray, params), "cpu")
    feats, _ = _batch(CFG, 2, 8, 6)
    ref = jax.jit(lambda p, b: j_generate(p, CFG, b, need_weights=True))(
        params, feats)
    with torch.inference_mode():
        out = generate(tparams, CFG, _tb(feats), need_weights=True)
    return tparams, feats, ref, out


def test_generate_maps_match_jax(decoded):
    _, _, ref, out = decoded
    np.testing.assert_array_equal(to_numpy(out["token_ids"]),
                                  np.asarray(ref["token_ids"]))
    assert len(out["attns"]) == len(ref["attns"]) == CFG.decoder.num_layers
    for layer, jlayer in zip(out["attns"], ref["attns"]):
        assert set(layer) == set(jlayer) == {"image", "article", "faces",
                                             "obj"}
        for name, a in jlayer.items():
            assert layer[name].shape == a.shape
            np.testing.assert_allclose(to_numpy(layer[name]), np.asarray(a),
                                       **TOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantised_cache_maps_match_jax(decoded, monkeypatch, mode):
    """Over the int8 / int4 K/V cache (tell_tpu's TELL_TPU_KV8 / KV4, set
    for this trace only) the maps come from the plain attention over the
    quantised cache, as tell_tpu's do."""
    tparams, feats = decoded[:2]
    monkeypatch.setenv("TELL_TPU_KV8", "1")
    monkeypatch.setenv("TELL_TPU_KV4", "1" if mode == "int4" else "0")
    params = jax.jit(lambda r: j_init(r, CFG))(jax.random.PRNGKey(4))
    ref = jax.jit(lambda p, b: j_generate(p, CFG, b, need_weights=True))(
        params, feats)
    with torch.inference_mode():
        out = generate(tparams, CFG, _tb(feats), kv_cache=mode,
                       need_weights=True)
    np.testing.assert_array_equal(to_numpy(out["token_ids"]),
                                  np.asarray(ref["token_ids"]))
    for layer, jlayer in zip(out["attns"], ref["attns"]):
        for name, a in jlayer.items():
            np.testing.assert_allclose(to_numpy(layer[name]), np.asarray(a),
                                       **TOL)


def test_replay_reproduces_generate_maps(decoded):
    tparams, feats, _, out = decoded
    with torch.inference_mode():
        rep = replay_attention(tparams, CFG, _tb(feats), out["token_ids"])
    assert len(rep) == len(out["attns"])
    for layer_rep, layer_gen in zip(rep, out["attns"]):
        assert set(layer_rep) == set(layer_gen)
        for name in layer_gen:
            np.testing.assert_allclose(to_numpy(layer_rep[name]),
                                       to_numpy(layer_gen[name]),
                                       rtol=1e-5, atol=1e-6)


def test_merge_word_attentions_matches_jax():
    from tell_tpu.data.tokenizer import RobertaTokenizer as JTokenizer
    jt = JTokenizer.from_files(VOCAB, MERGES, use_native=False)
    tt = RobertaTokenizer.from_files(VOCAB, MERGES)
    with open(os.path.join(QUALITY, "articles.jsonl"), encoding="utf-8") as f:
        art = json.loads(f.readline())
    text = "\n".join(s["text"] for s in art["parsed_section"][:3])
    context_ids = np.asarray(tt.encode(text, max_len=64))
    caption = tt.encode(art["parsed_section"][1]["text"], max_len=12)
    token_ids = np.asarray(caption[:-1] + [2, 1, 1])
    rng = np.random.default_rng(0)
    T = len(token_ids) - 1
    maps = {"article": rng.random((T, 66)), "faces": rng.random((T, 6))}
    lens = {"article": 64, "faces": 4}
    for kw in ({"context_ids": context_ids, "source_lens": lens},
               {"context_ids": context_ids}, {}):
        want = j_wa.merge_word_attentions(jt, token_ids, maps, **kw)
        got = t_wa.merge_word_attentions(tt, token_ids, maps, **kw)
        assert set(got) == set(want)
        assert got["caption_words"] == want["caption_words"]
        assert got.get("article_words") == want.get("article_words")
        for g, w in zip(got["word_attns"], want["word_attns"]):
            assert set(g) == set(w)
            for name in w:
                np.testing.assert_allclose(g[name], w[name], atol=1e-6)
    assert t_wa.group_pieces(tt, context_ids) == j_wa.group_pieces(
        jt, context_ids)


def _check_payload(body, context_len):
    assert "error" not in body
    assert set(body["attns"]) == {"image", "article", "faces", "obj"}
    S = {"image": 11, "article": context_len + 2, "faces": 6, "obj": 10}
    for name, maps in body["attns"].items():
        a = np.asarray(maps)
        assert a.shape == (SERVE_CFG.gen_len, S[name]), name
        np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-5)
    assert len(body["word_attns"]) == len(body["caption_words"])
    for row in body["word_attns"]:
        assert len(row["article"]) == len(body["article_words"])


def test_services_serve_attention_payloads():
    tt = RobertaTokenizer.from_files(VOCAB, MERGES)
    g = torch.Generator().manual_seed(5)
    params, rparams = init_captioner(g, SERVE_CFG), init_roberta(g, RCFG)
    with pytest.raises(ValueError, match="tokenizer"):
        CaptionService(params, RobertaEncoder(rparams, RCFG), SERVE_CFG,
                       "cpu", need_attention=True)
    micro = CaptionService(params, RobertaEncoder(rparams, RCFG), SERVE_CFG,
                           "cpu", tokenizer=tt, max_batch=2, article_len=64,
                           need_attention=True)
    eng = CaptionService(params, RobertaEncoder(rparams, RCFG), SERVE_CFG,
                         "cpu", tokenizer=tt, article_len=64,
                         engine_slots=2, engine_beam=2, engine_buckets=True,
                         need_attention=True)
    rng = np.random.default_rng(3)
    req = {"context": "Lisbon hosted a gathering of researchers this week.",
           "image_grid": rng.normal(size=(9, 32)).tolist(),
           "face_embeds": rng.normal(size=(2, 16)).tolist()}
    try:
        m = micro.caption(req)
        e = eng.caption(req)
        ids = np.asarray(tt.encode(req["context"], max_len=64))
        width = 16                          # the bucket that holds 12 ids
        _check_payload(m, width)
        _check_payload(e, width)
        # the masked faces rows (2 of 4 real) and pad columns get 0
        faces = np.asarray(m["attns"]["faces"])
        assert (faces[:, 2:4] == 0).all()
        art = np.asarray(m["attns"]["article"])
        assert (art[:, len(ids):width] == 0).all()
        batch, _ = eng._pack([req], bucketed=True)
        assert batch["context_ids"].shape[1] == width
        again = eng.replay_payload(eng._encode_many(batch), m["token_ids"],
                                   batch["context_ids"][0])
        for name, maps in m["attns"].items():
            np.testing.assert_allclose(again["attns"][name], maps,
                                       atol=1e-5)
        assert again["caption_words"] == m["caption_words"]
        for status in (micro.status(), eng.status()):
            assert status["config"]["need_attention"] is True
    finally:
        micro.close()
        eng.close()
