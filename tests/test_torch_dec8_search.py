"""Greedy and beam-5 search of tell_tpu_torch under each int8 and
merged-table decode lever (dec8, dec8_sm, merged_vocab, and dec8 +
dec8_sm) against tell_tpu's jitted generate and beam_search under its
environment flags, on the CPU at small_test_config (gen_len 10), weights
from tell_tpu's init_captioner carried across with the bridge and three
requests from a numpy seed.

Tolerance: ids equal, log-probs and scores 1e-5. dec8 quantises the
weight-normed weights, and XLA sums the weight norm in another order
than PyTorch, so their int8 tables differ from tell_tpu's in the last bit
of about half the scales (tests/test_torch_dec8.py); each step re-rounds
its activations to int8, and a one-ulp difference that crosses a .5 tie
moves a whole int8 step, which a search amplifies (tell_tpu's own eager
and jitted decodes differ by 0.019 in a log-prob at this config for the
same reason). So under dec8 the port's decode is handed tell_tpu's step
tables (decode_step_quant patched): the rest of the path, the int8
linears included, then gives tell_tpu's ids (on these inputs no
activation's int8 rounding flips between the packages; where one does,
tests/test_torch_dec8.py's step bound holds). dec8 and dec8 + dec8_sm:
tests/test_torch_dec8_search_int8.py.
"""
import jax
import numpy as np
import pytest
import torch

from tell_tpu.models.beam import beam_search as j_beam
from tell_tpu.models.captioner import generate as j_generate
from tell_tpu_torch.bridge import to_numpy
from tell_tpu_torch.models import decoder as td
from tell_tpu_torch.models.beam import beam_search
from tell_tpu_torch.models.captioner import generate
from tests.test_torch_dec8 import (LP_TOL, _as_port_tables,  # noqa: F401
                                   _jax_step_quant, model)

torch.set_num_threads(2)
ENV = {"dec8": "TELL_TPU_DEC8", "dec8_sm": "TELL_TPU_DEC8_SM",
       "merged_vocab": "TELL_TPU_MERGED_VOCAB"}
LEVERS = {"dec8": ("dec8",), "dec8_sm": ("dec8_sm",),
          "merged_vocab": ("merged_vocab",),
          "dec8+dec8_sm": ("dec8", "dec8_sm")}


def _batch(cfg, B=3, seed=5):
    rng = np.random.default_rng(seed)
    S = cfg.decoder.context("article").max_len
    mask = np.zeros((B, S), bool)
    mask[0, S // 2:] = True
    return {"image_grid": rng.normal(size=(B, 9, 32)).astype(np.float32),
            "article_hiddens": rng.normal(size=(B, S, 3, 24)
                                          ).astype(np.float32),
            "article_mask": mask,
            "face_embeds": rng.normal(size=(B, 4, 16)).astype(np.float32),
            "obj_embeds": rng.normal(size=(B, 8, 32)).astype(np.float32)}


def check_searches(model, monkeypatch, lever):
    """Greedy and beam 5 under a lever (or dec8 + dec8_sm) against
    tell_tpu's jitted generate and beam_search under its flags: ids equal,
    log-probs and scores 1e-5; dec8's step tables tell_tpu's (see
    above)."""
    cfg, jcfg, params, tparams = model
    on = LEVERS[lever]
    for name in on:
        monkeypatch.setenv(ENV[name], "1")
    if "dec8" in on:
        tables = _as_port_tables(_jax_step_quant(params, jcfg))
        monkeypatch.setattr(td, "decode_step_quant", lambda p: tables)
    batch = _batch(cfg)
    want = jax.jit(lambda p, b: j_generate(p, jcfg, b))(params, batch)
    wbeam = jax.jit(lambda p, b: j_beam(p, jcfg, b, beam_size=5))(params,
                                                                  batch)
    kw = {name: True for name in on}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = generate(tparams, cfg, tb, **kw)
        gbeam = beam_search(tparams, cfg, tb, beam_size=5, **kw)
        fp = generate(tparams, cfg, tb)
    np.testing.assert_array_equal(to_numpy(got["token_ids"]),
                                  np.asarray(want["token_ids"]))
    np.testing.assert_allclose(to_numpy(got["log_probs"]),
                               np.asarray(want["log_probs"]), **LP_TOL)
    np.testing.assert_array_equal(to_numpy(gbeam["token_ids"]),
                                  np.asarray(wbeam["token_ids"]))
    np.testing.assert_allclose(to_numpy(gbeam["scores"]),
                               np.asarray(wbeam["scores"]), **LP_TOL)
    if lever != "merged_vocab":   # int8 moves the log-probs
        assert float((got["log_probs"] - fp["log_probs"]).abs().max()) > 0


@pytest.mark.parametrize("lever", ["dec8_sm", "merged_vocab"])
def test_searches_equal_jax_under_the_table_levers(model, monkeypatch,
                                                   lever):
    check_searches(model, monkeypatch, lever)
