"""The long-article configuration (expt/nytimes/11_long_article.yaml: the
flagship with a 2048-token article encoded in 512-token RoBERTa windows)
against tell_tpu on the CPU, at a small size.

small_test_config with an article context of 54 tokens and a RoBERTa of
max_positions 20, so an article is encoded in three windows of 18 tokens
(roberta_encode_windowed) before greedy generate and beam search; weights
from tell_tpu's initialisers carried across with the bridge; inputs from
a numpy seed with a padded article and absent faces/objects. The service
built without article_len takes it from the article context, as
tell_tpu's does, and keeps a request longer than 512 tokens whole.
Tolerances: token ids equal; hidden states, log-probs and beam scores
1e-4 (a stack of layers summed in another order).
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from tell_tpu.config import ContextSpec, small_test_config
from tell_tpu.models.backbones.roberta import (
    RobertaConfig as JRobertaConfig, init_roberta as j_init_roberta)
from tell_tpu.models.beam import beam_search as j_beam
from tell_tpu.models.captioner import (encode_contexts as j_encode,
                                       generate as j_generate,
                                       init_captioner as j_init)
from tell_tpu_torch.bridge import to_numpy, to_torch
from tell_tpu_torch.config import with_article_len
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder)
from tell_tpu_torch.models.captioner import Captioner, encode_contexts
from tell_tpu_torch.serving import CaptionService

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
ART = 54                     # three windows of max_positions - 2 = 18
RK = dict(vocab_size=500, dim=32, num_layers=2, num_heads=2, ffn_dim=64,
          max_positions=20)
_base = small_test_config(gen_len=4)
CFG = dataclasses.replace(_base, decoder=dataclasses.replace(
    _base.decoder, contexts=(ContextSpec("image", 32, 9),
                             ContextSpec("article", 32, ART),
                             ContextSpec("faces", 16, 4),
                             ContextSpec("obj", 32, 8))))
JRCFG = JRobertaConfig(**RK)


@pytest.fixture(scope="module")
def models():
    params = jax.jit(lambda r: j_init(r, CFG))(jax.random.PRNGKey(0))
    rparams = jax.jit(lambda r: j_init_roberta(r, JRCFG))(
        jax.random.PRNGKey(1))
    frozen = {"roberta": rparams, "roberta_cfg": JRCFG}
    cap = Captioner(to_torch(jax.tree.map(np.asarray, params), "cpu"), CFG)
    enc = RobertaEncoder(to_torch(jax.tree.map(np.asarray, rparams), "cpu"),
                         RobertaConfig(**RK))
    return params, frozen, cap, enc


def _batch(B, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, RK["vocab_size"], size=(B, ART))
    ids[:, 0] = 0
    ids[0, 40:] = 1                     # padded: the third window half pad
    faces = rng.normal(size=(B, 4, 16)).astype(np.float32)
    faces[0, 1:] = np.nan
    objs = rng.normal(size=(B, 8, 32)).astype(np.float32)
    objs[-1, 5:] = np.nan
    return {"context_ids": ids,
            "image_grid": rng.normal(size=(B, 9, 32)).astype(np.float32),
            "face_embeds": faces, "obj_embeds": objs}


def _port_encode(enc, batch):
    return encode_contexts(enc.frozen(), CFG,
                           {k: torch.from_numpy(v) for k, v in batch.items()})


def test_windowed_encode_matches_jax(models):
    _, frozen, _, enc = models
    batch = _batch(2, 0)
    ref = j_encode(frozen, CFG, batch)
    with torch.inference_mode():
        out = _port_encode(enc, batch)
    assert out["article_hiddens"].shape == (2, ART, RK["num_layers"] + 1,
                                            RK["dim"])
    np.testing.assert_allclose(to_numpy(out["article_hiddens"]),
                               np.asarray(ref["article_hiddens"]), **TOL)
    np.testing.assert_array_equal(to_numpy(out["article_mask"]),
                                  np.asarray(ref["article_mask"]))


def test_greedy_and_beam_match_jax(models):
    params, frozen, cap, enc = models
    batch = _batch(2, 1)
    ref = jax.jit(lambda p, b: j_generate(p, CFG, j_encode(frozen, CFG, b)))(
        params, batch)
    ref_beam = jax.jit(lambda p, b: j_beam(p, CFG, j_encode(frozen, CFG, b),
                                           beam_size=3))(params, batch)
    with torch.inference_mode():
        e = _port_encode(enc, batch)
        out = cap.generate(e)
        beam = cap.beam_search(e, beam_size=3)
    np.testing.assert_array_equal(to_numpy(out["token_ids"]),
                                  np.asarray(ref["token_ids"]))
    np.testing.assert_allclose(to_numpy(out["log_probs"]),
                               np.asarray(ref["log_probs"]), **TOL)
    np.testing.assert_array_equal(to_numpy(beam["token_ids"]),
                                  np.asarray(ref_beam["token_ids"]))
    np.testing.assert_allclose(to_numpy(beam["scores"]),
                               np.asarray(ref_beam["scores"]), **TOL)


@pytest.mark.parametrize("article", [ART, 2048, None])
def test_service_derives_article_len_as_jax(models, article):
    """Built without article_len, the service takes the article context's
    max_len (512 without an article context) and its buckets, as
    tell_tpu/serving/server.py:69-75 does; a request is cut only there."""
    from tell_tpu.serving.server import CaptionService as JCaptionService
    params, frozen, cap, enc = models
    if article is None:
        dec = dataclasses.replace(CFG.decoder, contexts=tuple(
            c for c in CFG.decoder.contexts if c.name != "article"))
        cfg = dataclasses.replace(CFG, decoder=dec)
    else:
        cfg = with_article_len(CFG, article)
    jsvc = JCaptionService(params, frozen, cfg, tokenizer=None, max_batch=2)
    svc = CaptionService(cap.tree(), enc, cfg, "cpu", max_batch=2)
    try:
        assert svc.article_len == jsvc.article_len == (article or 512)
        assert svc._article_buckets == jsvc._article_buckets
        long_ids = [0] + [3 + i % 400 for i in range(1997)] + [2]   # 1999
        kept = svc._request_ids({"context_ids": long_ids}).size
        assert kept == min(len(long_ids), svc.article_len)
        if article == 2048:
            assert svc._article_buckets == (512, 1024, 2048)
            assert kept == len(long_ids) > 512
    finally:
        svc.close()
        jsvc.close()
