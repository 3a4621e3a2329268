"""The flagship's sibling configurations against tell_tpu on the CPU: the
paper's ablation rows (no image; flattened article + image; + faces) with
weigh_bert true here, false in tests/test_torch_siblings_unweighted.py,
and the decoder options (learned positions, the lightweight conv, the
pre-norm final LayerNorm) on the flagship's four contexts in
tests/test_torch_decoder_options.py (CASES and check_case live here). For
each: the training loss and every gradient, greedy generate (tokens and
log-probs), beam 5 (tokens and scores) and teacher-forced predict_forced
along tell_tpu's greedy tokens.

small_test_config (2 layers, E=64) with the sibling's contexts; weights
from tell_tpu's init_captioner carried across with the bridge; inputs from
a numpy seed with a padded article, absent (NaN) faces/objects and padded
captions. Tolerance: atol = rtol = 1e-4 on losses, gradients, log-probs
and scores (the same math summed in another order); ids equal.

Every captioner YAML of expts 4-9 and 13 (GoodNews and NYTimes) loads in
both packages to the same config, and its decoder options are one of the
cases here (the flagship's own, expt 9, is tests/test_torch_captioner.py's
and tests/test_torch_training.py's).
"""
import dataclasses
import glob
import os

import numpy as np
import jax
import pytest
import torch

from tell_tpu.config import small_test_config
from tell_tpu.config_io import load_experiment as j_load
from tell_tpu.models.beam import beam_search as j_beam
from tell_tpu.models.captioner import (captioner_loss as j_loss,
                                       generate as j_generate,
                                       init_captioner as j_init,
                                       predict_forced as j_forced)
from tell_tpu_torch.bridge import to_numpy, to_torch, tree_leaves, tree_map
from tell_tpu_torch.config_io import load_experiment
from tell_tpu_torch.models.beam import beam_search
from tell_tpu_torch.models.captioner import (captioner_loss, generate,
                                             predict_forced)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BASE = small_test_config(gen_len=6)
_CTX = {c.name: c for c in _BASE.decoder.contexts}
SETS = {"no_image": ("article",), "flattened": ("image", "article"),
        "faces": ("image", "article", "faces"),
        "faces_objects": ("image", "article", "faces", "obj")}


def _cfg(contexts, weigh_bert=True, **dec):
    return dataclasses.replace(
        _BASE, weigh_bert=weigh_bert, decoder=dataclasses.replace(
            _BASE.decoder, contexts=tuple(_CTX[n] for n in SETS[contexts]),
            **dec))


CASES = {
    "no_image-wb": _cfg("no_image"),
    "no_image": _cfg("no_image", weigh_bert=False),
    "flattened-wb": _cfg("flattened"),
    "flattened": _cfg("flattened", weigh_bert=False),
    "faces-wb": _cfg("faces"),
    "faces": _cfg("faces", weigh_bert=False),
    "learned": _cfg("faces_objects", positional="learned"),
    "lightweight": _cfg("faces_objects", conv_type="lightweight"),
    "final_norm": _cfg("faces_objects", normalize_before=True,
                       final_norm=True),
}


def _key(cfg):
    d = cfg.decoder
    return (tuple(c.name for c in d.contexts), cfg.weigh_bert, d.positional,
            d.conv_type, d.normalize_before and d.final_norm)


def _batch(cfg, B, T, seed):
    """Features for cfg's contexts (article hiddens with weigh_bert),
    absent faces/objects, a padded article, and padded captions."""
    rng = np.random.default_rng(seed)
    dcfg = cfg.decoder
    art = _CTX["article"]
    batch = {"article_mask": np.zeros((B, art.max_len), bool)}
    batch["article_mask"][0, art.max_len // 2:] = True
    if cfg.weigh_bert:
        batch["article_hiddens"] = rng.normal(size=(
            B, art.max_len, cfg.num_bert_layers, art.kv_dim)).astype(
                np.float32)
    else:
        batch["article"] = rng.normal(size=(B, art.max_len, art.kv_dim)
                                      ).astype(np.float32)
    names = {c.name for c in dcfg.contexts}
    if "image" in names:
        c = _CTX["image"]
        batch["image_grid"] = rng.normal(size=(B, c.max_len, c.kv_dim)
                                         ).astype(np.float32)
    for name, key in (("faces", "face_embeds"), ("obj", "obj_embeds")):
        if name in names:
            c = _CTX[name]
            em = rng.normal(size=(B, c.max_len, c.kv_dim)).astype(np.float32)
            em[0, 1:] = np.nan
            batch[key] = em
    cap = rng.integers(3, dcfg.vocab_size, size=(B, T)).astype(np.int32)
    cap[:, 0] = dcfg.bos_id
    cap[0, T - 3:] = dcfg.pad_id
    cap[-1, T - 1] = dcfg.eos_id
    return batch, cap


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def check_case(cfg):
    """cfg's loss, gradients, greedy, beam-5 and forced decode against
    tell_tpu's on tell_tpu's weights."""
    params = jax.jit(lambda r: j_init(r, cfg))(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    feats, cap = _batch(cfg, 2, 8, 1)

    # the loss and every gradient
    (j_l, _), j_g = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss(p, cfg, b), has_aux=True))(
            params, {**feats, "caption_ids": cap})
    tp = tree_map(lambda t: t.requires_grad_(True),
                  to_torch(np_params, "cpu"))
    loss, _ = captioner_loss(tp, cfg, {**_tb(feats), "caption_ids":
                                       torch.from_numpy(cap).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_l), **TOL)
    j_leaves = tree_leaves(jax.tree.map(np.asarray, j_g))
    t_leaves = tree_leaves(tp)
    assert len(j_leaves) == len(t_leaves)
    for g, t in zip(j_leaves, t_leaves):
        np.testing.assert_allclose(to_numpy(t.grad), g, **TOL)

    # greedy, beam 5 and teacher-forced on tell_tpu's greedy tokens
    tp = to_torch(np_params, "cpu")
    ref = jax.jit(lambda p, b: j_generate(p, cfg, b))(params, feats)
    ref_beam = jax.jit(lambda p, b: j_beam(p, cfg, b, beam_size=5))(
        params, feats)
    j_preds = jax.jit(lambda p, b, t: j_forced(p, cfg, b, t))(
        params, feats, ref["token_ids"])
    with torch.inference_mode():
        out = generate(tp, cfg, _tb(feats))
        beam = beam_search(tp, cfg, _tb(feats), beam_size=5)
        ref_ids = torch.from_numpy(np.array(ref["token_ids"])).long()
        preds = predict_forced(tp, cfg, _tb(feats), ref_ids)
    np.testing.assert_array_equal(to_numpy(out["token_ids"]),
                                  np.asarray(ref["token_ids"]))
    np.testing.assert_allclose(to_numpy(out["log_probs"]),
                               np.asarray(ref["log_probs"]), **TOL)
    np.testing.assert_array_equal(to_numpy(beam["token_ids"]),
                                  np.asarray(ref_beam["token_ids"]))
    np.testing.assert_allclose(to_numpy(beam["scores"]),
                               np.asarray(ref_beam["scores"]), **TOL)
    np.testing.assert_array_equal(to_numpy(preds), np.asarray(j_preds))


@pytest.mark.parametrize("name", ["no_image-wb", "flattened-wb", "faces-wb"])
def test_sibling_loss_grads_and_decode_match_jax(name):
    check_case(CASES[name])


SIBLING_YAMLS = sorted(
    os.path.relpath(p, ROOT) for expt in ("goodnews", "nytimes")
    for n in (4, 5, 6, 7, 8, 13)
    for p in glob.glob(os.path.join(ROOT, "expt", expt, f"{n}_*.yaml")))


@pytest.mark.parametrize("path", SIBLING_YAMLS)
def test_sibling_yamls_are_cases_here(path):
    full = os.path.join(ROOT, path)
    exp, jexp = load_experiment(full), j_load(full)
    assert dataclasses.asdict(exp.model) == dataclasses.asdict(jexp.model)
    assert _key(exp.model) in {_key(c) for c in CASES.values()}
