"""The LSTM family served by the port (serving/server.py's micro-batch
mode through the LSTM adapter) against tell_tpu's CaptionService on the
CPU.

expt 3's form shrunk (tests/test_torch_lstm.py's decoder, weigh_bert off,
image 9 x 32, article 16 x 32 from a RoBERTa of dim 32), weights from
tell_tpu's init_lstm_captioner and init_roberta, the quality corpus's
tokenizer. With need_attention (tell_tpu's `serve --attention` answers an
LSTM model with its maps {image, article} [T, S], no bias or zero
column, and their word merge): two requests, each alone and together,
answer tell_tpu's token ids, maps within 1e-5 and the same word merge.
The engine is refused with tell_tpu's error; a GloVe model's request
fails in both services (neither has a GloVe encode).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tell_tpu import config as JC
from tell_tpu.data.tokenizer import RobertaTokenizer as JTokenizer
from tell_tpu.models.backbones.roberta import RobertaConfig as JR
from tell_tpu.models.backbones.roberta import init_roberta
from tell_tpu.models.registry import get_model as j_get_model
from tell_tpu.serving.server import CaptionService as JService
from tell_tpu_torch import config as PC
from tell_tpu_torch.bridge import to_torch
from tell_tpu_torch.data.tokenizer import RobertaTokenizer
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder)
from tell_tpu_torch.models.registry import get_model
from tell_tpu_torch.serving import CaptionService

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(ROOT, "tests", "fixtures", "quality")
RFIELDS = dict(vocab_size=708, dim=32, num_layers=2, num_heads=2,
               ffn_dim=64, max_positions=20)
ARTICLES = ("Lisbon hosted a gathering of researchers this week.",
            "The mayor spoke in the city on Monday about the budget.")


def configs(article_dim=32):
    out = []
    for C in (JC, PC):
        base = C.small_test_config()
        dec = dataclasses.replace(base.decoder, contexts=(
            C.ContextSpec("image", 32, 9),
            C.ContextSpec("article", article_dim, 16)))
        out.append(dataclasses.replace(base, decoder=dec, weigh_bert=False,
                                       gen_len=6))
    return out


@pytest.fixture(scope="module")
def model():
    jcfg, pcfg = configs()
    jparams = j_get_model("lstm", jcfg).init(jax.random.PRNGKey(0), jcfg)
    jrob = init_roberta(jax.random.PRNGKey(1), JR(**RFIELDS))
    np_tree = jax.tree.map(np.asarray, {"m": jparams, "r": jrob})
    return {"jcfg": jcfg, "pcfg": pcfg, "jparams": jparams,
            "jfrozen": {"roberta": jrob, "roberta_cfg": JR(**RFIELDS)},
            "params": to_torch(np_tree["m"], "cpu"),
            "roberta": to_torch(np_tree["r"], "cpu")}


def _files():
    return (os.path.join(QUALITY, "vocab.json"),
            os.path.join(QUALITY, "merges.txt"))


def _requests():
    rng = np.random.default_rng(4)
    return [{"context": text,
             "image_grid": rng.normal(size=(9, 32)).round(4).tolist()}
            for text in ARTICLES]


def _service(model, params=None, cfg=None, **kw):
    rcfg = RobertaConfig(**RFIELDS)
    cfg = cfg or model["pcfg"]
    return CaptionService(params or model["params"],
                          RobertaEncoder(model["roberta"], rcfg), cfg,
                          "cpu", tokenizer=RobertaTokenizer.from_files(
                              *_files(), max_len=16),
                          max_batch=2, adapter=get_model("lstm", cfg), **kw)


def _assert_close(got, want):
    """Nested lists and dicts of numbers within 1e-5, strings equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_close(got[k], want[k])
    elif isinstance(want, list) and want and isinstance(want[0],
                                                        (dict, list, str)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
    elif isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_attention_answers_equal_jax_service(model):
    jsvc = JService(model["jparams"], model["jfrozen"], model["jcfg"],
                    JTokenizer.from_files(*_files(), max_len=16,
                                          use_native=False),
                    max_batch=2, need_attention=True,
                    adapter=j_get_model("lstm", model["jcfg"]))
    svc = _service(model, need_attention=True)
    try:
        reqs = _requests()
        want = [jsvc.caption(r) for r in reqs]
        alone = [svc.caption(r) for r in reqs]
        together = svc._run(reqs)
    finally:
        jsvc.close()
        svc.close()
    for got in (alone, together):
        for g, w in zip(got, want):
            assert g["token_ids"] == w["token_ids"]
            assert g["caption_words"] == w["caption_words"]
            assert g["article_words"] == w["article_words"]
            assert set(g["attns"]) == set(w["attns"]) == {"image",
                                                           "article"}
            for name, maps in g["attns"].items():
                assert np.asarray(maps).shape == np.asarray(
                    w["attns"][name]).shape
                np.testing.assert_allclose(maps, w["attns"][name],
                                           atol=1e-5)
            _assert_close(g["word_attns"], w["word_attns"])


def test_engine_refused_and_glove_requests_fail_as_in_jax(model):
    with pytest.raises(ValueError, match="captioner and modern families "
                       "only"):
        _service(model, engine_slots=2)
    # a GloVe model (article 24-d here, the RoBERTa 32-d)
    jcfg, pcfg = configs(article_dim=24)
    jparams = j_get_model("lstm", jcfg).init(jax.random.PRNGKey(2), jcfg)
    jsvc = JService(jparams, model["jfrozen"], jcfg,
                    JTokenizer.from_files(*_files(), max_len=16,
                                          use_native=False),
                    max_batch=2, adapter=j_get_model("lstm", jcfg))
    svc = _service(model, to_torch(jax.tree.map(np.asarray, jparams),
                                   "cpu"), pcfg)
    try:
        with pytest.raises(ValueError):
            jsvc.caption(_requests()[0])
        with pytest.raises(ValueError, match="24-d features"):
            svc.caption(_requests()[0])
    finally:
        jsvc.close()
        svc.close()
