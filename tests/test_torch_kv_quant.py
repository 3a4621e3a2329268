"""The int8/int4 K/V cache of tell_tpu_torch against tell_tpu on the CPU:
quantize_kv / quantize_kv4 bytes and scales, unpack_int4, kernel D's plain
version (decode_attention_q8_plain) against the JAX reference and the JAX
Pallas kernels in interpret mode (single-shot and S-tiled), decoder_step
with kv_cache="int8"/"int4" against JAX's step under TELL_TPU_KV8=1 /
TELL_TPU_KV4=1, and greedy generate token ids, int8 at the small config
and int4 at head dim 64.

Inputs from numpy seeds; weights from tell_tpu's initialisers carried
across with the bridge. Tolerances: bytes, scales and token ids exact;
attention outputs 1e-5 (same int8 math, another summation order); step
features 1e-4 (a full decoder step).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tell_tpu.config import small_test_config
from tell_tpu.models import decoder as jd
from tell_tpu.models.captioner import (generate as j_generate,
                                       init_captioner as j_init)
from tell_tpu.ops.kernels import decode_attention as jk
from tell_tpu_torch.bridge import to_numpy, to_torch
from tell_tpu_torch.models import decoder as td
from tell_tpu_torch.models.captioner import generate
from tell_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_q8, decode_attention_q8_plain, unpack_int4)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
QUANT = {"int8": (td.quantize_kv, jd._quantize_kv),
         "int4": (td.quantize_kv4, jd._quantize_kv4)}
LEVER = {"int8": "TELL_TPU_KV8", "int4": "TELL_TPU_KV4"}


def _kv_tensor(seed, shape=(2, 3, 16, 40)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 2.0).astype(np.float32)


def _tie_column(t, levels):
    """Column 0 of (b=0, h=0): amax = levels, so the scale is exactly 1,
    and the other rows sit on .5 ties."""
    t = t.copy()
    hd = t.shape[2]
    t[0, 0, :, 0] = (np.arange(hd) % (2 * levels) - levels + 0.5)
    t[0, 0, 0, 0] = levels
    return t


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_kv_bytes_and_scales_equal_jax(mode):
    port, ref = QUANT[mode]
    t = _tie_column(_kv_tensor(0), 127 if mode == "int8" else 7)
    q, s = port(torch.from_numpy(t))
    jq, js = ref(jnp.asarray(t))
    assert q.dtype == torch.int8 and q.shape == tuple(jq.shape)
    np.testing.assert_array_equal(to_numpy(q), np.asarray(jq))
    np.testing.assert_array_equal(to_numpy(s), np.asarray(js))


def test_unpack_int4_round_trip():
    """quantize_kv4's packed bytes unpack to the clipped, rounded int4
    values in the original row order, as JAX's unpack_int4 gives them."""
    t = _kv_tensor(1)
    packed, scale = td.quantize_kv4(torch.from_numpy(t))
    got = unpack_int4(packed)
    want = np.clip(np.round(t / to_numpy(scale)), -7, 7).astype(np.int8)
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(
        to_numpy(got), np.asarray(jk.unpack_int4(jnp.asarray(
            to_numpy(packed)))))


def _q8_case(mode, B, H, M, G, S, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, M * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, H, hd, S)).astype(np.float32)
    v = rng.normal(size=(B, H, hd, S)).astype(np.float32)
    port = QUANT[mode][0]
    k8, ks = map(to_numpy, port(torch.from_numpy(k)))
    v8, vs = map(to_numpy, port(torch.from_numpy(v)))
    seg = np.sort(rng.integers(0, M, size=S))
    seg[:M] = np.arange(M)
    seg = np.sort(seg)
    pad = rng.random((B, S)) < 0.2
    pad[:, np.searchsorted(seg, np.arange(M))] = False
    pad[1, -min(50, S // 3):] = True
    bias = np.asarray(jk.segment_bias(jnp.asarray(seg), jnp.asarray(pad), M,
                                      G))
    return q, k8, ks, v8, vs, bias


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("form", ["single_shot", "tiled"])
def test_decode_attention_q8_plain_matches_jax(mode, form):
    """Against reference_decode_attention_q8 and the Pallas q8 kernels in
    interpret mode: single-shot at S=24, S-tiled (128-column tiles, a
    ragged third tile, a padded tail) at S=300."""
    S = 24 if form == "single_shot" else 300
    args = _q8_case(mode, 2, 2, 3, 2, S, 16, 2)
    out = decode_attention_q8(*(torch.from_numpy(a.copy()) for a in args))
    jargs = [jnp.asarray(a) for a in args]
    ref = jk.reference_decode_attention_q8(*jargs)
    if form == "tiled":
        kern = jk._tiled_decode_attention_q8(*jargs, 2, 128,
                                             pack4=mode == "int4")
    else:
        kern = jk.fused_decode_attention_q8(*jargs)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), **TOL)
    np.testing.assert_allclose(to_numpy(out), np.asarray(kern), **TOL)


def test_decode_attention_q8_plain_bf16_matches_jax_reference():
    """bf16 queries: both sides take fp32 scores and softmax, cast the
    probabilities times v_scale to bf16, and round the output to bf16;
    tolerance 1e-2 (a few bf16 ulps at |out| ~ 1)."""
    q, k8, ks, v8, vs, bias = _q8_case("int8", 2, 2, 2, 2, 40, 16, 3)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    out = decode_attention_q8_plain(tq, *(torch.from_numpy(a.copy()) for a
                                          in (k8, ks, v8, vs, bias)))
    ref = jk.reference_decode_attention_q8(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, (k8, ks, v8, vs,
                                                         bias)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


CFG = small_test_config().decoder


@pytest.fixture(scope="module")
def decoder_setup():
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


@pytest.mark.parametrize("mode,beam,fused", [("int8", 1, "0"),
                                             ("int8", 3, "1"),
                                             ("int4", 3, "0")])
def test_decoder_steps_with_quantised_cache_match_jax(decoder_setup,
                                                      monkeypatch, mode,
                                                      beam, fused):
    """The quantised cache equals JAX's (scales to fp32 rounding: the K/V
    projections are summed in another order; the bytes exactly at these
    inputs), and three steps (beam rows permuted through row_gather) agree;
    with TELL_TPU_FUSED=1 the JAX side runs its Pallas q8 kernel in
    interpret mode."""
    monkeypatch.setenv(LEVER[mode], "1")        # read when JAX traces
    monkeypatch.setenv("TELL_TPU_FUSED", fused)
    params, tparams, contexts, t_ctx, B = decoder_setup
    R = B * beam
    j_state = jax.jit(lambda p, c: jd.init_decode_state(
        p, CFG, c, B, beam=beam))(params, contexts)
    t_state = td.init_decode_state(tparams, CFG, t_ctx, B, beam=beam,
                                   kv_cache=mode)
    for (jc,), tc in zip(j_state["kv"], t_state["kv"]):
        for key in ("k", "v"):
            assert tc[key].is_contiguous() and tc[key].dtype == torch.int8
            np.testing.assert_array_equal(to_numpy(tc[key]),
                                          np.asarray(jc[key]))
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(to_numpy(tc[key]),
                                       np.asarray(jc[key]), rtol=1e-6)
    j_step = jax.jit(lambda p, t, s, rg: jd.decoder_step(
        p, CFG, t, s, row_gather=rg)[:2])
    rng = np.random.default_rng(beam)
    for step in range(3):
        toks = rng.integers(3, CFG.vocab_size, size=R)
        rg = (rng.integers(0, R, size=R) if beam > 1 and step
              else np.arange(R))
        rx, j_state = j_step(params, jnp.asarray(toks), j_state,
                             jnp.asarray(rg))
        x, t_state = td.decoder_step(tparams, CFG, torch.from_numpy(toks),
                                     t_state, row_gather=torch.from_numpy(rg))
        np.testing.assert_allclose(to_numpy(x), np.asarray(rx), **STEP_TOL)


def _gen_batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    dcfg = cfg.decoder
    S = dcfg.context("article").max_len
    mask = np.zeros((B, S), bool)
    mask[0, S // 2:] = True
    return {
        "image_grid": rng.normal(size=(B, 9, 32)).astype(np.float32),
        "article_hiddens": rng.normal(size=(B, S, 3, 24)).astype(np.float32),
        "article_mask": mask,
        "face_embeds": rng.normal(size=(B, 4, 16)).astype(np.float32),
        "obj_embeds": rng.normal(size=(B, 8, 32)).astype(np.float32),
    }


@pytest.mark.parametrize("mode,cfg", [
    ("int8", small_test_config(gen_len=8)),
    # hd = 64, the flagship's head dim (tests/test_decoder.py's int4 gate)
    ("int4", small_test_config(embed_dim=256, conv_dim=256, ffn_dim=512,
                               num_heads=4, gen_len=8)),
], ids=["int8", "int4_hd64"])
def test_quantised_greedy_generate_matches_jax(monkeypatch, mode, cfg):
    monkeypatch.setenv(LEVER[mode], "1")
    params = jax.jit(lambda r: j_init(r, cfg))(jax.random.PRNGKey(0))
    batch = _gen_batch(cfg, 2, 5)
    ref = jax.jit(lambda p, b: j_generate(p, cfg, b))(params, batch)
    tparams = to_torch(jax.tree.map(np.asarray, params), "cpu")
    with torch.inference_mode():
        out = generate(tparams, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                       kv_cache=mode)
    np.testing.assert_array_equal(to_numpy(out["token_ids"]),
                                  np.asarray(ref["token_ids"]))
    np.testing.assert_allclose(to_numpy(out["log_probs"]),
                               np.asarray(ref["log_probs"]), **STEP_TOL)


def test_unknown_kv_cache_mode_raises(decoder_setup):
    _, tparams, _, t_ctx, B = decoder_setup
    with pytest.raises(ValueError, match="kv_cache"):
        td.init_decode_state(tparams, CFG, t_ctx, B, kv_cache="int2")
