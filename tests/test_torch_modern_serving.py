"""The modern family served by the port (models/registry.py's adapter,
serving/engine.py's LLMDecodeEngine, serving/server.py's adapter path)
against tell_tpu on the CPU.

get_model maps tell_tpu's names as tell_tpu does (vit_modern over a
captioner config swaps in ViT-L's contexts; the modern adapter carries
llm_loss, the LSTM names tell_tpu's _lstm adapter and the pointer names
its _pointer adapters). LLMDecodeEngine, dense and MoE, fp
and int8 K/V: every schedule (staggered admissions, slot reuse, the
max_lag=1 drain) answers each request with the port's one-shot
llm_beam_search on it alone (ids and finished equal, scores within 1e-5),
and on the dense fp LM that search is tell_tpu's (ids equal, scores
within 1e-4). POST
/caption: the micro-batch mode answers tell_tpu's CaptionService with the
modern adapter token for token; the engine mode answers tell_tpu's
one-shot beam search on tell_tpu's encode of the request; a raw photo
sent to a modern model with the ResNet tower loaded gets tell_tpu's `bad
image_grid` error (its 49 x 2048 grid does not fit the 197 x 1024 slot;
here a small tower's 49 x 64 grid and a 9 x 32 slot) in both modes; the
engine refuses need_attention, and both modes fused_topk.
"""
import base64
import dataclasses
import functools
import http.client
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.config import CaptionerConfig as JCaptioner
from tell_tpu.config import ContextSpec as JSpec
from tell_tpu.models import llm_decoder as J
from tell_tpu.models.registry import get_model as j_get_model
from tell_tpu_torch.bridge import init_llm_decoder, to_torch
from tell_tpu_torch.config import (CaptionerConfig, ContextSpec, LLMConfig,
                                   VIT_CONTEXTS)
from tell_tpu_torch.models import llm_decoder as P
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder)
from tell_tpu_torch.models.registry import get_model
from tell_tpu_torch.serving import CaptionService, serve
from tell_tpu_torch.serving.engine import LLMDecodeEngine

torch.set_num_threads(2)
CONTEXTS = (("image", 32, 9), ("article", 32, 16), ("faces", 16, 4),
            ("obj", 32, 8))
FIELDS = dict(vocab_size=500, dim=32, num_layers=2, num_heads=4,
              num_kv_heads=2, ffn_dim=48, dropout=0.0, attention_dropout=0.0,
              max_target_positions=64, gen_len=6)
RFIELDS = dict(vocab_size=500, dim=32, num_layers=2, num_heads=2, ffn_dim=64,
               max_positions=20)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configs(**over):
    fields = {**FIELDS, **over}
    return (J.LLMConfig(**fields, contexts=tuple(JSpec(*c)
                                                 for c in CONTEXTS)),
            LLMConfig(**fields, contexts=tuple(ContextSpec(*c)
                                               for c in CONTEXTS)))


class _WordTokenizer:
    """Stand-in tokenizer: one id per word (3 + its length), ids joined
    back as text. tell_tpu's service takes an article as text only."""

    def encode(self, text, max_len):
        return [0] + [3 + len(w) for w in text.split()][: max_len - 2] + [2]

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


@functools.lru_cache(maxsize=None)
def _lm(moe: bool):
    """(tell_tpu's config, the port's, tell_tpu-initialised params, the
    port's copy) of the dense LM; its 4-expert MoE form from the port's
    initialiser (tests/test_torch_moe.py holds that form to tell_tpu's)."""
    jcfg, pcfg = configs(**({"moe_experts": 4} if moe else {}))
    if moe:
        return jcfg, pcfg, None, init_llm_decoder(
            torch.Generator().manual_seed(0), pcfg)
    jparams = J.init_llm_decoder(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jparams, to_torch(jax.tree.map(np.asarray, jparams),
                                         "cpu")


@pytest.fixture(scope="module")
def model():
    """tell_tpu-initialised LM (dense) and RoBERTa, in both packages."""
    from tell_tpu.models.backbones.roberta import RobertaConfig as JR
    from tell_tpu.models.backbones.roberta import init_roberta
    jcfg, pcfg, jparams, _ = _lm(False)
    jrob = init_roberta(jax.random.PRNGKey(1), JR(**RFIELDS))
    np_tree = jax.tree.map(np.asarray, {"lm": jparams, "rob": jrob})
    return {"jcfg": jcfg, "pcfg": pcfg, "jparams": jparams,
            "jfrozen": {"roberta": jrob, "roberta_cfg": JR(**RFIELDS)},
            "params": to_torch(np_tree["lm"], "cpu"),
            "roberta": to_torch(np_tree["rob"], "cpu")}


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        faces = rng.normal(size=(1 + i % 4, 16))
        obj = rng.normal(size=(8, 32))
        obj[3 + i % 5:] = np.nan
        words = ["w" * int(n) for n in rng.integers(1, 30, 3 + (5 * i) % 12)]
        reqs.append({
            "context": " ".join(words),
            "image_grid": rng.normal(size=(9, 32)).tolist(),
            "face_embeds": faces.tolist(), "obj_embeds": obj.tolist()})
    return reqs


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/caption", json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _concurrent(port, reqs):
    answers = [None] * len(reqs)

    def post(i):
        answers[i] = _post(port, reqs[i])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return answers


def _service(model, **kw):
    rcfg = RobertaConfig(**RFIELDS)
    return CaptionService(model["params"], RobertaEncoder(model["roberta"],
                                                          rcfg),
                          model["pcfg"], "cpu", tokenizer=_WordTokenizer(),
                          max_batch=4,
                          adapter=get_model("transformer_modern",
                                            model["pcfg"]), **kw)


def test_registry_maps_names_as_jax_does():
    cap = CaptionerConfig()
    assert get_model("transformer_faces", cap).name == "captioner"
    jcfg, pcfg = configs()
    for name in ("modern", "transformer_modern", "vit_modern"):
        ad = get_model(name, pcfg)
        assert ad.name == "modern" and ad.config is pcfg
        assert ad.loss is P.llm_loss and ad.loss_e2e is P.llm_loss_e2e
        assert ad.beam is P.llm_beam_search
    # a captioner YAML reused: vit swaps the ResNet grid's image spec
    for name, vit in (("transformer_modern", False), ("vit_modern", True)):
        got = get_model(name, cap).config
        want = j_get_model(name, JCaptioner()).config
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.contexts == VIT_CONTEXTS) is vit
    # the LSTM family: tell_tpu's _lstm adapter (no e2e loss of its own,
    # no beam); transformer_glove is the captioner
    from tell_tpu_torch.models import lstm_decoder as L
    for name in ("lstm", "baseline_glove", "lstm_decoder_flattened"):
        ad, jad = get_model(name, cap), j_get_model(name, JCaptioner())
        assert (ad.name, ad.loss_e2e, ad.beam) == (jad.name, None, None)
        assert ad.loss is L.lstm_captioner_loss
        assert ad.generate is L.lstm_generate and ad.encode is not None
    assert get_model("transformer_glove", cap).name == "captioner"
    # the pointer family: tell_tpu's _pointer adapters (a PointerConfig
    # over the captioner's, an e2e loss, no beam), no engine, no maps
    for name in ("pointer", "transformer_pointer", "pointer_2",
                 "transformer_pointer_2"):
        ad, jad = get_model(name, cap), j_get_model(name, JCaptioner())
        assert ad.name == jad.name == ("pointer_v2" if name.endswith("2")
                                       else "pointer_v1")
        assert (dataclasses.asdict(ad.config)
                == dataclasses.asdict(jad.config))
        assert (ad.beam, jad.beam) == (None, None)
        assert ad.loss_e2e is not None and ad.encode is not None
        assert (ad.engine, ad.attention_maps, ad.copy_masks) == (
            False, False, True)
    assert not get_model("transformer_faces", cap).copy_masks
    with pytest.raises(KeyError):
        get_model("bogus", cap)


def _one_shot(params, cfg, req, beam, **kw):
    with torch.inference_mode():
        out = P.llm_beam_search(params, cfg, {k: torch.from_numpy(v)
                                              for k, v in req.items()},
                                beam_size=beam, **kw)
    return {k: v[0].numpy() for k, v in out.items()}


def _features(cfg, seed):
    rng = np.random.default_rng(seed)
    art = cfg.context("article")
    mask = np.zeros((1, art.max_len), bool)
    mask[0, art.max_len - int(rng.integers(0, art.max_len // 2)):] = True
    out = {"article_mask": mask}
    for c, key in (("image", "image_grid"), ("article", "article"),
                   ("faces", "face_embeds"), ("obj", "obj_embeds")):
        spec = cfg.context(c)
        out[key] = rng.normal(size=(1, spec.max_len, spec.kv_dim)).astype(
            np.float32)
    out["face_embeds"][0, 2:] = np.nan
    return out


@pytest.mark.parametrize("moe,kv_cache", [(False, "fp"), (True, "fp"),
                                          (False, "int8")])
def test_llm_engine_equals_one_shot_and_jax(moe, kv_cache):
    jcfg, pcfg, jparams, params = _lm(moe)
    reqs = [_features(pcfg, s) for s in range(5)]
    refs = [_one_shot(params, pcfg, r, 3, kv_cache=kv_cache) for r in reqs]
    eng = LLMDecodeEngine(params, pcfg, "cpu", slots=3, beam=3,
                          chunk_steps=2, max_lag=1, kv_cache=kv_cache)
    futs = [eng.submit(reqs[0]), eng.submit(reqs[1])]
    eng.tick()                               # r0, r1 at step 2
    futs += [eng.submit(r) for r in reqs[2:]]  # r4 waits for a free slot
    eng.run_until_drained()
    for fut, ref in zip(futs, refs):
        got = fut.result(timeout=0)
        np.testing.assert_array_equal(got["token_ids"], ref["token_ids"])
        np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["finished"], ref["finished"])
    if moe or kv_cache != "fp":
        return       # tell_tpu's one-shot: the dense fp case
    want = jax.jit(lambda p, b: J.llm_beam_search(p, jcfg, b, beam_size=3))(
        jparams, {k: jnp.asarray(v) for k, v in reqs[0].items()})
    np.testing.assert_array_equal(refs[0]["token_ids"],
                                  np.asarray(want["token_ids"][0]))
    np.testing.assert_allclose(refs[0]["scores"],
                               np.asarray(want["scores"][0]), atol=1e-4,
                               rtol=1e-4)


def test_llm_engine_refuses_what_tell_tpu_refuses(model):
    with pytest.raises(ValueError, match="fused_topk"):
        _service(model, engine_slots=2, fused_topk=True)
    with pytest.raises(ValueError, match="fused_topk"):
        _service(model, fused_topk=True)
    with pytest.raises(ValueError, match="attention replay"):
        _service(model, engine_slots=2, need_attention=True)


@pytest.fixture(scope="module")
def jax_service(model):
    from tell_tpu.serving.server import CaptionService as JService
    svc = JService(model["jparams"], model["jfrozen"], model["jcfg"],
                   _WordTokenizer(), max_batch=4,
                   adapter=j_get_model("transformer_modern", model["jcfg"]))
    yield svc
    svc.close()


def test_micro_batch_http_equals_jax_service(model, jax_service):
    """Concurrent POST /caption: each answer's ids are tell_tpu's."""
    reqs = _requests(4)
    svc = _service(model)
    httpd = serve(svc, port=0, block=False)
    try:
        answers = _concurrent(httpd.server_address[1], reqs)
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    for (status, body), req in zip(answers, reqs):
        assert status == 200 and "error" not in body, body
        want = jax_service.caption(req)
        assert body["token_ids"] == list(want["token_ids"])
        assert body["caption"] == want["caption"]


def test_engine_http_equals_jax_one_shot(model):
    """Engine mode (2 slots, beam 3): the best beam and the alternatives
    are tell_tpu's one-shot beam search on tell_tpu's encode of the
    request."""
    reqs = _requests(3, seed=1)
    svc = _service(model, engine_slots=2, engine_beam=3)
    httpd = serve(svc, port=0, block=False)
    try:
        answers = _concurrent(httpd.server_address[1], reqs)
        packed = [svc._pack([r])[0] for r in reqs]
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    jcfg, jfrozen = model["jcfg"], model["jfrozen"]
    search = jax.jit(lambda p, r, b: J.llm_beam_search(
        p, jcfg, J.modern_encode_contexts(
            {**jfrozen, "roberta": r}, jcfg, b), beam_size=3))
    for (status, body), batch in zip(answers, packed):
        assert status == 200 and "error" not in body, body
        want = search(model["jparams"], jfrozen["roberta"],
                      {k: jnp.asarray(v) for k, v in batch.items()})
        paths = [body["token_ids"]] + [a["token_ids"]
                                       for a in body["alternatives"]]
        np.testing.assert_array_equal(np.asarray(paths),
                                      np.asarray(want["token_ids"][0]))
        np.testing.assert_allclose(body["score"],
                                   float(want["scores"][0, 0]), atol=1e-4)


def _tiny_resnet():
    from tell_tpu_torch.bridge import init_resnet
    from tell_tpu_torch.models.backbones.resnet import (ResNetConfig,
                                                        prepare_resnet)
    cfg = ResNetConfig(block_counts=(1, 1, 1, 1), width=2)
    tree = init_resnet(torch.Generator().manual_seed(5), cfg)
    return tree, {"resnet": prepare_resnet(tree), "resnet_cfg": cfg}


def test_a_photo_to_a_modern_model_gets_bad_image_grid(model):
    """tell_tpu's behaviour, mirrored: the ResNet grid of a raw photo goes
    into the modern model's image slot, which does not take it; the
    request is answered with the error beside the ids of its other
    contexts (micro-batch) or refused a slot (engine), as tell_tpu's
    _pack and _caption_continuous do."""
    from tell_tpu.models.backbones.resnet import ResNetConfig as JResNet
    from tell_tpu.serving.server import CaptionService as JService
    from tell_tpu_torch.bridge import to_numpy
    tree, towers = _tiny_resnet()
    with open(os.path.join(ROOT, "tests", "fixtures", "images",
                           "news_a_320x240_420.jpg"), "rb") as f:
        photo = base64.b64encode(f.read()).decode()
    plain = {k: v for k, v in _requests(1, seed=2)[0].items()
             if k != "image_grid"}
    req = {**plain, "image_b64": photo}
    jsvc = JService(model["jparams"], {
        **model["jfrozen"], "resnet": to_numpy(tree),
        "resnet_cfg": JResNet(block_counts=(1, 1, 1, 1), width=2)},
        model["jcfg"], _WordTokenizer(), max_batch=4,
        adapter=j_get_model("transformer_modern", model["jcfg"]))
    try:
        _, jerr = jsvc._pack([req], width=16)
    finally:
        jsvc.close()
    assert jerr[0].startswith("bad image_grid")
    for engine_slots in (0, 2):
        svc = _service(model, towers=towers, engine_slots=engine_slots,
                       engine_beam=2)
        try:
            _, err = svc._pack([req])
            assert err[0].startswith("bad image_grid")
            got = svc.caption(req)
            assert got["error"].startswith("bad image_grid")
            if engine_slots:
                assert got["token_ids"] == []
            else:
                assert got["token_ids"] == svc.caption(plain)["token_ids"]
        finally:
            svc.close()


def test_numerics_ab_compares_the_modern_levers_free_running(model):
    """tell_tpu's service compares an adapter's levers free-running (its
    decode loop has no teacher-forced form): the int8 and int4 K/V caches
    and the tanh-GELU encode, and no fused top-k."""
    svc = _service(model)
    try:
        report = svc.numerics_ab([{"context": "the mayor spoke today"}])
    finally:
        svc.close()
    assert report["method"] == "free_running"
    assert "fused_topk_token_agreement" not in report
    for key in ("kv8_token_agreement", "kv4_token_agreement",
                "fast_gelu_token_agreement"):
        assert 0.0 <= report[key] <= 1.0
    assert report["kv8_token_agreement"] > 0.5 and report["tokens"] > 0


def test_micro_batch_attention_payload_is_the_generate_maps(model):
    """need_attention in micro-batch mode (the quality corpus's tokenizer,
    which the word merge needs): the first layer's per-step maps of
    llm_generate(need_weights=True) on the packed request, and their
    per-word merge (the engine refuses need_attention)."""
    from tell_tpu_torch.bridge import init_roberta
    from tell_tpu_torch.data.tokenizer import RobertaTokenizer
    quality = os.path.join(ROOT, "tests", "fixtures", "quality")
    tok = RobertaTokenizer.from_files(os.path.join(quality, "vocab.json"),
                                      os.path.join(quality, "merges.txt"))
    rcfg = RobertaConfig(**{**RFIELDS, "vocab_size": 708})
    roberta = RobertaEncoder(init_roberta(torch.Generator().manual_seed(6),
                                          rcfg), rcfg)
    req = {**_requests(1, seed=3)[0],
           "context": "Lisbon hosted a gathering of researchers this week."}
    svc = CaptionService(model["params"], roberta, model["pcfg"], "cpu",
                         tokenizer=tok, max_batch=2, need_attention=True,
                         adapter=get_model("modern", model["pcfg"]))
    try:
        got = svc.caption(req)
        batch, _ = svc._pack([req], bucketed=True)
        with torch.inference_mode():
            enc = svc._encode({k: torch.from_numpy(v)
                               for k, v in batch.items()})
            want = P.llm_generate(model["params"], model["pcfg"], enc,
                                  need_weights=True)
    finally:
        svc.close()
    assert got["token_ids"] == want["token_ids"][0].tolist()
    assert set(got["attns"]) == {c[0] for c in CONTEXTS}
    for name, maps in got["attns"].items():
        np.testing.assert_allclose(np.asarray(maps),
                                   want["attns"][0][name][:, 0, 0].numpy(),
                                   atol=1e-6)
    assert len(got["word_attns"]) == len(got["caption_words"])
