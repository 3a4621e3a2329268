"""tell_tpu_torch's decode path against tell_tpu's on the CPU:
precompute_context_kv_cat, init_decode_state + decoder_step (greedy rows
and beam rows with a row_gather permutation) and decoder_top_k. The JAX
step runs its jnp attention and, with TELL_TPU_FUSED=1, its Pallas decode
kernel in interpret mode (as tests/test_kernels.py does).

small_test_config (2 layers, E=64, 4 contexts with padding), weights from
tell_tpu's init_decoder carried across with the bridge. Tolerance: 1e-4
on step features (a full decoder step, summed in another order), 1e-5 on
the K/V projections, exact on token ids.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tell_tpu.config import small_test_config
from tell_tpu.models import decoder as jd
from tell_tpu_torch.bridge import to_numpy, to_torch
from tell_tpu_torch.models import decoder as td

torch.set_num_threads(2)
CFG = small_test_config().decoder
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(lambda r: jd.init_decoder(r, CFG))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    B = 2
    contexts = {}
    for spec in CFG.contexts:
        feats = rng.normal(size=(B, spec.max_len, spec.kv_dim)).astype(
            np.float32)
        mask = np.zeros((B, spec.max_len), bool)
        mask[1, spec.max_len // 2:] = True
        contexts[spec.name] = (feats, mask)
    t_ctx = {k: (torch.from_numpy(f), torch.from_numpy(m))
             for k, (f, m) in contexts.items()}
    return (params, to_torch(jax.tree.map(np.asarray, params), "cpu"),
            contexts, t_ctx, B)


def test_precompute_context_kv_cat(setup):
    params, tparams, contexts, t_ctx, _ = setup
    ref = jd.precompute_context_kv_cat(params, CFG, contexts, beam=3)
    out = td.precompute_context_kv_cat(tparams, CFG, t_ctx, beam=3)
    assert len(out) == len(ref) == CFG.num_layers
    for (r,), o in zip(ref, out):          # JAX: one context group
        assert set(o) == set(r)
        assert o["k"].is_contiguous() and o["v"].is_contiguous()
        for key in r:
            np.testing.assert_allclose(to_numpy(o[key]), np.asarray(r[key]),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("beam,fused", [(1, "0"), (3, "0"), (3, "1")])
def test_decoder_steps_match_jax(setup, monkeypatch, beam, fused):
    """Three steps; with beam > 1 each step also permutes the conv windows
    through row_gather, as beam search does."""
    monkeypatch.setenv("TELL_TPU_FUSED", fused)   # read when JAX traces
    params, tparams, contexts, t_ctx, B = setup
    R = B * beam
    j_state = jax.jit(lambda p, c: jd.init_decode_state(
        p, CFG, c, B, beam=beam))(params, contexts)
    t_state = td.init_decode_state(tparams, CFG, t_ctx, B, beam=beam)
    j_step = jax.jit(lambda p, t, s, rg: jd.decoder_step(
        p, CFG, t, s, row_gather=rg)[:2])
    rng = np.random.default_rng(beam)
    for step in range(3):
        toks = rng.integers(3, CFG.vocab_size, size=R)
        # step 0 reads the windows as they are (identity parents)
        rg = (rng.integers(0, R, size=R) if beam > 1 and step
              else np.arange(R))
        rx, j_state = j_step(params, jnp.asarray(toks), j_state,
                             jnp.asarray(rg))
        x, t_state = td.decoder_step(tparams, CFG, torch.from_numpy(toks),
                                     t_state, row_gather=torch.from_numpy(rg))
        np.testing.assert_allclose(to_numpy(x), np.asarray(rx), **STEP_TOL)
        for c, rc in zip(t_state["conv"], j_state["conv"]):
            np.testing.assert_allclose(to_numpy(c), np.asarray(rc),
                                       **STEP_TOL)
        assert int(t_state["step"]) == int(j_state["step"]) == step + 1
    for k in (1, 3):
        rv, ri = jd.decoder_top_k(params, CFG, rx, k)
        v, i = td.decoder_top_k(tparams, CFG, x, k)
        np.testing.assert_allclose(to_numpy(v), np.asarray(rv), **STEP_TOL)
        np.testing.assert_array_equal(to_numpy(i), np.asarray(ri))


@pytest.mark.parametrize("override", [{"conv_type": "lightweight"},
                                      {"positional": "learned"},
                                      {"normalize_before": True,
                                       "final_norm": True}])
def test_unported_decoder_configs_raise(setup, override):
    """The three decoder options the port once refused now decode as
    tell_tpu does: the port's initialiser gives tell_tpu's keys and
    shapes, and on tell_tpu's weights three beam-3 steps (with a
    row_gather permutation) and the teacher-forced forward match."""
    import dataclasses
    from tell_tpu_torch.bridge import init_decoder
    cfg = dataclasses.replace(CFG, **override)
    _, _, contexts, t_ctx, B = setup
    params = jax.jit(lambda r: jd.init_decoder(r, cfg))(
        jax.random.PRNGKey(3))
    tparams = to_torch(jax.tree.map(np.asarray, params), "cpu")
    mine = init_decoder(torch.Generator().manual_seed(0), cfg)
    assert (jax.tree.map(np.shape, jax.tree.map(np.asarray, params))
            == jax.tree.map(np.shape, to_numpy(mine)))
    beam, R = 3, B * 3
    j_state = jax.jit(lambda p, c: jd.init_decode_state(
        p, cfg, c, B, beam=beam))(params, contexts)
    t_state = td.init_decode_state(tparams, cfg, t_ctx, B, beam=beam)
    j_step = jax.jit(lambda p, t, s, rg: jd.decoder_step(
        p, cfg, t, s, row_gather=rg)[:2])
    rng = np.random.default_rng(7)
    for step in range(3):
        toks = rng.integers(3, cfg.vocab_size, size=R)
        rg = rng.integers(0, R, size=R) if step else np.arange(R)
        rx, j_state = j_step(params, jnp.asarray(toks), j_state,
                             jnp.asarray(rg))
        x, t_state = td.decoder_step(tparams, cfg, torch.from_numpy(toks),
                                     t_state, row_gather=torch.from_numpy(rg))
        np.testing.assert_allclose(to_numpy(x), np.asarray(rx), **STEP_TOL)
    ids = rng.integers(3, cfg.vocab_size, size=(B, 5))
    ids[0, 3:] = cfg.pad_id
    rf = jax.jit(lambda p, i, c: jd.decoder_forward(p, cfg, i, c)[0])(
        params, jnp.asarray(ids), contexts)
    f = td.decoder_forward(tparams, cfg, torch.from_numpy(ids), t_ctx)
    np.testing.assert_allclose(to_numpy(f), np.asarray(rf), **STEP_TOL)


def test_decode_guards(setup):
    """Too many steps for the positional table raise instead of decoding;
    top-k sampling decodes, the same tokens for the same generator."""
    import dataclasses
    from tell_tpu_torch.models.captioner import generate, predict_forced
    from tell_tpu_torch.config import small_test_config
    _, tparams, contexts, _, B = setup
    batch = {"image_grid": torch.from_numpy(contexts["image"][0]),
             "article": torch.from_numpy(contexts["article"][0]),
             "article_mask": torch.from_numpy(contexts["article"][1]),
             "face_embeds": torch.from_numpy(contexts["faces"][0]),
             "obj_embeds": torch.from_numpy(contexts["obj"][0])}
    params = {"decoder": tparams}
    long = small_test_config(gen_len=CFG.max_target_positions + 1)
    with pytest.raises(ValueError, match="max_target_positions"):
        generate(params, dataclasses.replace(long, weigh_bert=False), batch)
    toks = torch.zeros(B, CFG.max_target_positions + 2, dtype=torch.long)
    with pytest.raises(ValueError, match="max_target_positions"):
        predict_forced(params, dataclasses.replace(long, weigh_bert=False),
                       batch, toks)
    sampling = dataclasses.replace(
        small_test_config(gen_len=3, sampling_topk=5), weigh_bert=False)
    a, b = (generate(params, sampling, batch,
                     gen=torch.Generator().manual_seed(11))
            for _ in range(2))
    assert a["token_ids"].shape == (B, 4)
    torch.testing.assert_close(a["token_ids"], b["token_ids"])
    torch.testing.assert_close(a["log_probs"], b["log_probs"])
