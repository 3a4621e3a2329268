"""tell_tpu_torch.models.llm_decoder (the modern family's decode side)
against tell_tpu.models.llm_decoder on the CPU.

tell_tpu's init_llm_decoder makes the weights (carried across with
bridge.to_torch), numpy seeds make the contexts, at the small config of
tests/test_llm_decoder.py (dim 32, 2 layers, 4 heads over 2 K/V heads,
vocab 211, gen_len 6). Held: rms_norm, RoPE and the decode step's
features and caches (GQA and MHA, at a scalar step and at per-row steps,
the engine's) within 1e-4; greedy ids equal and log-probs within 1e-4,
with need_weights the maps too; beam 5 ids equal and scores within 1e-4;
the int8 K/V cache against tell_tpu's TELL_TPU_KV8 path; the tied top-k's
tie order; the cache and the position limit refused.
(modern_encode_contexts is held in tests/test_torch_vit.py.)
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.config import ContextSpec as JSpec
from tell_tpu.models import llm_decoder as J
from tell_tpu_torch.bridge import to_torch
from tell_tpu_torch.config import ContextSpec, LLMConfig
from tell_tpu_torch.models import llm_decoder as P

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
CONTEXTS = (("image", 16, 5), ("article", 12, 9), ("faces", 8, 3),
            ("obj", 16, 4))
FIELDS = dict(vocab_size=211, dim=32, num_layers=2, num_heads=4,
              num_kv_heads=2, ffn_dim=48, dropout=0.0,
              attention_dropout=0.0, max_target_positions=32, gen_len=6)


def configs(**over):
    """(tell_tpu's LLMConfig, the port's) with the same fields."""
    fields = {**FIELDS, **over}
    return (J.LLMConfig(**fields, contexts=tuple(JSpec(*c)
                                                 for c in CONTEXTS)),
            LLMConfig(**fields, contexts=tuple(ContextSpec(*c)
                                               for c in CONTEXTS)))


def make_batch(seed=1, B=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    faces = f(B, 3, 8)
    faces[:, -1] = np.nan
    return {"image_grid": f(B, 5, 16), "article": f(B, 9, 12),
            "article_mask": np.arange(9)[None] >= np.array(
                [9, 6, 4, 7, 2][:B])[:, None],
            "face_embeds": faces, "obj_embeds": f(B, 4, 16)}


def both(params_j, batch):
    """(JAX params/batch, the port's)."""
    return ((params_j, {k: jnp.asarray(v) for k, v in batch.items()}),
            (to_torch(jax.tree.map(np.asarray, params_j), "cpu"),
             {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}))


@functools.lru_cache(maxsize=None)
def _params(kv_heads):
    return J.init_llm_decoder(jax.random.PRNGKey(2),
                              configs(num_kv_heads=kv_heads)[0])


@pytest.fixture(scope="module")
def gqa():
    jcfg, pcfg = configs()
    params = J.init_llm_decoder(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, params, make_batch()


def test_rms_norm_and_rope_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        P.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                   1e-5).numpy(),
        np.asarray(J.rms_norm({"scale": scale}, x, 1e-5)), **TOL)
    pos = np.array([[0, 3, 7, 100, 511]])
    jc, js = J.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    pc, ps = P.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
    # half-split: the first half of each head rotates against its second
    np.testing.assert_allclose(
        P.apply_rope(torch.from_numpy(x), pc[0], ps[0]).numpy(),
        np.asarray(J.apply_rope(x, jc[0], js[0])), atol=1e-5)


@pytest.mark.parametrize("kv_heads", [2, None], ids=["gqa", "mha"])
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["scalar_step", "per_row_steps"])
def test_decoder_step_equals_jax(kv_heads, per_row):
    """Three steps from the same state: features, the self-K/V caches and
    the step within 1e-4. Per-row steps start each row elsewhere, as the
    engine's slots do."""
    jcfg, pcfg = configs(num_kv_heads=kv_heads)
    (jp, jb), (pp, pb) = both(_params(kv_heads), make_batch(3))
    jstate = J.init_llm_decode_state(jp, jcfg, J._build_contexts(jp, jcfg,
                                                                 jb), 3)
    pstate = P.init_llm_decode_state(pp, pcfg,
                                     P._build_contexts(pp, pcfg, pb), 3)
    if per_row:
        jstate["step"] = jnp.array([2, 0, 4], jnp.int32)
        pstate["step"] = torch.tensor([2, 0, 4])
    tokens = np.array([[0, 0, 0], [17, 5, 200], [3, 99, 2]])
    jstep = jax.jit(lambda p, t, s: J.llm_decoder_step(p, jcfg, t, s)[:2])
    for t in tokens:
        jf, jstate = jstep(jp, jnp.asarray(t), jstate)
        pf, pstate, _ = P.llm_decoder_step(pp, pcfg, torch.from_numpy(t),
                                           pstate)
        np.testing.assert_allclose(pf.numpy(), np.asarray(jf), **TOL)
    assert pstate["self_kv"][0]["k"].shape == (3, 7, jcfg.kv_heads, 8)
    for jc, pc in zip(jstate["self_kv"], pstate["self_kv"]):
        for n in ("k", "v"):
            np.testing.assert_allclose(pc[n].numpy(), np.asarray(jc[n]),
                                       **TOL)
    np.testing.assert_array_equal(pstate["step"].numpy(),
                                  np.asarray(jstate["step"]))


def test_greedy_equals_jax_with_and_without_maps(gqa):
    jcfg, pcfg, params, batch = gqa
    (jp, jb), (pp, pb) = both(params, batch)
    want = jax.jit(lambda p, b: J.llm_generate(p, jcfg, b))(jp, jb)
    got = P.llm_generate(pp, pcfg, pb)
    np.testing.assert_array_equal(got["token_ids"].numpy(),
                                  np.asarray(want["token_ids"]))
    np.testing.assert_allclose(got["log_probs"].numpy(),
                               np.asarray(want["log_probs"]), **TOL)
    np.testing.assert_array_equal(got["finished"].numpy(),
                                  np.asarray(want["finished"]))
    want = jax.jit(lambda p, b: J.llm_generate(p, jcfg, b,
                                               need_weights=True))(jp, jb)
    got = P.llm_generate(pp, pcfg, pb, need_weights=True)
    np.testing.assert_array_equal(got["token_ids"].numpy(),
                                  np.asarray(want["token_ids"]))
    assert len(got["attns"]) == jcfg.num_layers
    for gl, wl in zip(got["attns"], want["attns"]):
        assert set(gl) == set(wl) == {c[0] for c in CONTEXTS}
        for name in gl:
            assert gl[name].shape == wl[name].shape
            np.testing.assert_allclose(gl[name].numpy(),
                                       np.asarray(wl[name]), **TOL)


def test_beam5_equals_jax(gqa):
    jcfg, pcfg, params, batch = gqa
    (jp, jb), (pp, pb) = both(params, batch)
    want = jax.jit(lambda p, b: J.llm_beam_search(p, jcfg, b, beam_size=5))(
        jp, jb)
    got = P.llm_beam_search(pp, pcfg, pb, beam_size=5)
    np.testing.assert_array_equal(got["token_ids"].numpy(),
                                  np.asarray(want["token_ids"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), **TOL)
    np.testing.assert_array_equal(got["finished"].numpy(),
                                  np.asarray(want["finished"]))


def test_int8_kv_cache_equals_jax_kv8(gqa, monkeypatch):
    """kv_cache="int8" quantises the contexts' K/V as tell_tpu's
    TELL_TPU_KV8 does (kernel D's plain version on the CPU)."""
    jcfg, pcfg, params, batch = gqa
    (jp, jb), (pp, pb) = both(params, batch)
    monkeypatch.setenv("TELL_TPU_KV8", "1")
    want = jax.jit(lambda p, b: J.llm_generate(p, jcfg, b))(jp, jb)
    got = P.llm_generate(pp, pcfg, pb, kv_cache="int8")
    np.testing.assert_array_equal(got["token_ids"].numpy(),
                                  np.asarray(want["token_ids"]))
    np.testing.assert_allclose(got["log_probs"].numpy(),
                               np.asarray(want["log_probs"]), **TOL)


def test_tied_top_k_ties_go_to_the_lower_id():
    """Equal logits come back lowest id first, as lax.top_k's, at k = 1
    and k > 1."""
    _, pcfg = configs(vocab_size=12, dim=4)
    table = np.zeros((12, 4), np.float32)
    table[[2, 5, 9], 0] = 1.0          # three tied maxima
    table[[1, 7], 0] = 0.5             # two tied runners-up
    feats = np.array([[2.0, 0, 0, 0], [0, 0, 0, 0]], np.float32)
    params = {"tok_embed": torch.from_numpy(table)}
    for k in (1, 4, 6):
        lp, ids = P.tied_top_k(params, pcfg, torch.from_numpy(feats), k)
        logits = feats @ table.T
        wv, wi = jax.lax.top_k(jnp.asarray(logits), k)
        lse = jax.scipy.special.logsumexp(jnp.asarray(logits), axis=-1)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(wi))
        np.testing.assert_allclose(lp.numpy(),
                                   np.asarray(wv - lse[:, None]), atol=1e-6)


def test_cache_and_position_limits_raise(gqa):
    """tell_tpu clamps a write past the cache's last row; the port
    raises, and refuses a gen_len past max_target_positions before
    decoding."""
    _, pcfg, params, batch = gqa
    _, (pp, pb) = both(params, batch)
    state = P.init_llm_decode_state(pp, pcfg,
                                    P._build_contexts(pp, pcfg, pb), 3)
    state["step"] = torch.tensor(pcfg.gen_len + 1)
    with pytest.raises((IndexError, RuntimeError)):
        P.llm_decoder_step(pp, pcfg, torch.zeros(3, dtype=torch.long), state)
    state["step"] = torch.tensor([0, pcfg.gen_len + 1, 1])
    with pytest.raises((IndexError, RuntimeError)):
        P.llm_decoder_step(pp, pcfg, torch.zeros(3, dtype=torch.long), state)
    long = dataclasses.replace(pcfg, gen_len=pcfg.max_target_positions + 1)
    with pytest.raises(ValueError, match="max_target_positions"):
        P.llm_generate(pp, long, pb)
