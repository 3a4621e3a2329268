"""Top-k sampling and the full-vocabulary log-probs against tell_tpu on the
CPU.

* Along teacher-forced tokens, each step's top-4 candidates (ids equal,
  log-probs within 1e-4) equal tell_tpu's decoder_top_k at k=4, on the
  exact route and on the fused route (kernel E's plain version here).
* The sampler: with a fixed generator, the frequency of each candidate
  over 200,000 draws from one row of top-k log-probs lies within 0.005 of
  softmax(topk_lp / temp) (the standard error of a frequency is at most
  0.5 / sqrt(200,000) = 0.0011, so the bound is 4.5 of them; the draws are
  seeded, so the test is deterministic), at temperature 1 and 0.7.
* generate with sampling_topk=4 at temperature 0.5: the same generator
  seed gives the same tokens; each sampled token lies in its step's exact
  top-4 and its reported log-prob is the model's untempered one (the
  full-vocabulary log-prob at that token, within 1e-4); a filler row
  (row_live False) emits <pad> at log-prob 0, and so does every row after
  its EOS.
* adaptive_log_probs / decoder_log_probs against tell_tpu's (1e-4), each
  row's logsumexp 0 within 1e-5.

The two frameworks draw different numbers from one seed, so the draws
themselves are compared with the port's own distribution, not with JAX's.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tell_tpu.models import decoder as jd
from tell_tpu.models.captioner import (build_contexts as j_contexts,
                                       init_captioner as j_init)
from tell_tpu_torch.bridge import to_numpy, to_torch
from tell_tpu_torch.models import decoder as td
from tell_tpu_torch.models.captioner import (build_contexts, generate,
                                             sample_top_k)
from tests.test_torch_siblings import _batch, _cfg, _tb

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dataclasses.replace(_cfg("faces_objects"), gen_len=8,
                          sampling_topk=4, sampling_temp=0.5)
DCFG = CFG.decoder


@pytest.fixture(scope="module")
def model():
    params = jax.jit(lambda r: j_init(r, CFG))(jax.random.PRNGKey(2))
    tparams = to_torch(jax.tree.map(np.asarray, params), "cpu")
    feats, cap = _batch(CFG, 3, 8, 5)
    return params, tparams, feats, cap


def _forced_features(model):
    """Step features along the caption tokens: tell_tpu's and the
    port's, [T, B, E] each."""
    params, tparams, feats, cap = model
    B = cap.shape[0]
    jctx = j_contexts(params, CFG, feats)
    j_state = jd.init_decode_state(params["decoder"], DCFG, jctx, B)
    j_step = jax.jit(lambda p, t, s: jd.decoder_step(p, DCFG, t, s)[:2])
    t_state = td.init_decode_state(
        tparams["decoder"], DCFG, build_contexts(tparams, CFG, _tb(feats)),
        B)
    jx, tx = [], []
    for t in range(cap.shape[1] - 1):
        x, j_state = j_step(params["decoder"], jnp.asarray(cap[:, t]),
                            j_state)
        jx.append(x)
        y, t_state = td.decoder_step(tparams["decoder"], DCFG,
                                     torch.from_numpy(cap[:, t]).long(),
                                     t_state)
        tx.append(y)
    return jnp.stack(jx), torch.stack(tx)


@pytest.mark.parametrize("fused", [False, True], ids=["exact", "fused"])
def test_top4_candidates_along_forced_tokens_match_jax(model, fused):
    params, tparams = model[:2]
    jx, tx = _forced_features(model)
    for t in range(tx.shape[0]):
        rv, ri = jd.decoder_top_k(params["decoder"], DCFG, jx[t], 4)
        v, i = td.decoder_top_k(tparams["decoder"], DCFG, tx[t], 4,
                                fused_topk=fused)
        np.testing.assert_array_equal(to_numpy(i), np.asarray(ri))
        np.testing.assert_allclose(to_numpy(v), np.asarray(rv), **TOL)


@pytest.mark.parametrize("temp", [1.0, 0.7])
def test_sampler_frequencies_follow_the_tempered_softmax(temp):
    n = 200_000
    top_lp = torch.tensor([[-0.4, -1.3, -2.0, -3.1]])
    gen = torch.Generator().manual_seed(3)
    choice = sample_top_k(top_lp.expand(n, 4), temp, gen)
    freq = torch.bincount(choice, minlength=4).double() / n
    want = torch.softmax(top_lp[0].double() / temp, dim=0)
    assert (freq - want).abs().max().item() < 0.005


def test_generate_samples_within_top_k_with_untempered_log_probs(model):
    _, tparams, feats, _ = model
    batch = {**_tb(feats), "row_live": torch.tensor([True, True, False])}
    with torch.inference_mode():
        a, b = (generate(tparams, CFG, batch,
                         gen=torch.Generator().manual_seed(9))
                for _ in range(2))
        other = generate(tparams, CFG, batch,
                         gen=torch.Generator().manual_seed(10))
        ids = a["token_ids"]
        B, T = ids.shape[0], ids.shape[1] - 1
        ctx = build_contexts(tparams, CFG, batch)
        state = td.init_decode_state(tparams["decoder"], DCFG, ctx, B)
        full, top = [], []
        for t in range(T):
            x, state = td.decoder_step(tparams["decoder"], DCFG, ids[:, t],
                                       state)
            full.append(td.decoder_log_probs(tparams["decoder"], DCFG, x))
            top.append(td.decoder_top_k(tparams["decoder"], DCFG, x, 4)[1])
    torch.testing.assert_close(a["token_ids"], b["token_ids"])
    torch.testing.assert_close(a["log_probs"], b["log_probs"])
    assert not torch.equal(a["token_ids"], other["token_ids"])
    live = torch.ones(B, dtype=torch.bool)
    live[2] = False
    for t in range(T):
        tok = ids[:, t + 1]
        lp = a["log_probs"][:, t]
        for r in range(B):
            if live[r]:
                assert tok[r] in top[t][r]
                np.testing.assert_allclose(float(lp[r]),
                                           float(full[t][r, tok[r]]), **TOL)
                live[r] = tok[r] != DCFG.eos_id
            else:
                assert tok[r] == DCFG.pad_id and lp[r] == 0.0


def test_adaptive_log_probs_match_jax(model):
    params, tparams = model[:2]
    jx, tx = _forced_features(model)
    ref = jd.decoder_log_probs(params["decoder"], DCFG, jx)
    out = td.decoder_log_probs(tparams["decoder"], DCFG, tx)
    assert out.shape == (*tx.shape[:2], DCFG.vocab_size)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), **TOL)
    np.testing.assert_allclose(to_numpy(torch.logsumexp(out, dim=-1)), 0.0,
                               atol=1e-5)
