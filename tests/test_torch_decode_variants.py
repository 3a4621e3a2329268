"""Kernel F's plain route against the three single-shot TPU kernels it
replaces, the port's measurement tools end to end on the CPU, and the bf16
decode step those tools time.

The TPU kernels run as the JAX package's own tests run Pallas on the CPU,
in interpret mode, and nothing under tools/ changes for it:
tools/kernel_variants.py is loaded with importlib, its module globals H,
MG, hd and S set to the test's shape and its `pl` to a namespace whose
pallas_call is interpret=True; fused_batched (BB=1, 2) and fused_q4split
(BB=2) run from there. The BB=1 single-shot kernel of
tools/longctx_variants.py:52 is an inline function, so the same
pallas_call is built here around tell_tpu.ops.kernels.decode_attention.
_kernel. Inputs come from numpy with a seed, a segment bias with padding
and a ragged S (70, past one 64-column tile). Tolerances: fp32 atol 2e-5,
rtol 1e-4 (the same math summed in another order); bf16 2e-2 absolute
(both round p and the output to bf16).

Kernel F's route on the card (tests/test_torch_single_route.py holds it to
the three kernels) gives the same bits at bb = 1, 2 and 4 and for each
batch row alone; S=4096, past what a block's shared memory could hold
of the [MG, S] score row, runs.
"""
import functools
import importlib.util
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tell_tpu.models.decoder import _quantize_kv4
from tell_tpu.ops.kernels import decode_attention as jda
from tell_tpu_torch.bridge import to_numpy, to_torch, tree_map
from tell_tpu_torch.ops.kernels.decode_attention import (
    CHUNK, decode_attention_plain, decode_attention_q4split,
    decode_attention_q4split_split_plain, decode_attention_single,
    decode_attention_single_split_plain, segment_bias)
from tell_tpu_torch.tools import kernel_variants, longctx_variants
from tell_tpu_torch.tools import profile_decode

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_ATOL = 2e-2
B, H, M, G, HD, S = 4, 4, 3, 2, 16, 70
MG = M * G
_interpret = types.SimpleNamespace(
    pallas_call=functools.partial(pl.pallas_call, interpret=True),
    BlockSpec=pl.BlockSpec)


@pytest.fixture
def tpu_tools(monkeypatch):
    """tools/kernel_variants.py at the test's shape, Pallas interpreted."""
    spec = importlib.util.spec_from_file_location(
        "_tpu_kernel_variants", os.path.join(REPO, "tools",
                                             "kernel_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in (("H", H), ("MG", MG), ("hd", HD), ("S", S),
                        ("pl", _interpret)):
        monkeypatch.setattr(mod, name, value)
    return mod


def _inputs(seed):
    """q, k, v (numpy fp32) and a segment bias with padded columns."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, MG, HD)).astype(np.float32) * HD ** -0.5
    k = rng.normal(size=(B, H, HD, S)).astype(np.float32)
    v = rng.normal(size=(B, H, HD, S)).astype(np.float32)
    seg = np.sort(rng.integers(0, M, size=S))
    seg[:M] = np.arange(M)
    seg = np.sort(seg)
    pad = rng.random((B, S)) < 0.25
    pad[:, np.searchsorted(seg, np.arange(M))] = False
    bias = segment_bias(torch.from_numpy(seg), torch.from_numpy(pad), M, G)
    return q, k, v, to_numpy(bias)


def _single1(q, k, v, bias):
    """The inline fn of tools/longctx_variants.py:52: the package's
    single-shot _kernel at BB=1, one grid step per batch row."""
    Bn = q.shape[0]
    kv_spec = pl.BlockSpec((1, H, HD, S), lambda b: (b, 0, 0, 0),
                           memory_space=pltpu.VMEM)
    return _interpret.pallas_call(
        functools.partial(jda._kernel, H=H, BB=1),
        out_shape=jax.ShapeDtypeStruct((Bn, H, MG, HD), q.dtype),
        grid=(Bn,),
        in_specs=[pl.BlockSpec((1, H, MG, HD), lambda b: (b, 0, 0, 0),
                               memory_space=pltpu.VMEM),
                  kv_spec, kv_spec,
                  pl.BlockSpec((1, MG, S), lambda b: (b, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, H, MG, HD), lambda b: (b, 0, 0, 0),
                               memory_space=pltpu.VMEM),
    )(q, k, v, bias)


@pytest.mark.parametrize("form", ["batched1", "batched2", "single1"])
def test_single_shot_plain_matches_tpu_kernels_fp32(tpu_tools, form):
    q, k, v, bias = _inputs(0)
    bb = {"batched1": 1, "batched2": 2, "single1": 1}[form]
    if form == "single1":
        ref = _single1(q, k, v, bias)
    else:
        ref = tpu_tools.fused_batched(q, k, v, bias, BB=bb)
    out = decode_attention_single(*map(torch.from_numpy, (q, k, v, bias)),
                                  bb=bb)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), **FP32_TOL)
    np.testing.assert_allclose(to_numpy(out), np.asarray(
        jda.reference_decode_attention(q, k, v, bias)), **FP32_TOL)


def test_single_shot_plain_matches_tpu_kernel_bf16(tpu_tools):
    """bf16 storage: both round the normalised p and the output to bf16."""
    q, k, v, bias = _inputs(1)
    ref = tpu_tools.fused_batched(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), bias, BB=2)
    out = decode_attention_single(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        torch.from_numpy(bias), bb=2)
    assert out.dtype == torch.bfloat16
    err = np.abs(to_numpy(out.float()) - np.asarray(ref, np.float32)).max()
    assert err <= BF16_ATOL


def test_q4split_plain_matches_tpu_kernel(tpu_tools):
    q, k, v, bias = _inputs(2)
    k4, ks = _quantize_kv4(jnp.asarray(k))
    v4, vs = _quantize_kv4(jnp.asarray(v))
    ref = tpu_tools.fused_q4split(q, k4, ks, v4, vs, bias, BB=2)
    out = decode_attention_q4split(*(torch.from_numpy(np.array(a)) for a in
                                     (q, k4, ks, v4, vs, bias)), bb=2)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), **FP32_TOL)
    np.testing.assert_allclose(to_numpy(out), np.asarray(
        jda.reference_decode_attention_q8(q, k4, ks, v4, vs, bias)),
        **FP32_TOL)


def _split_inputs(S_, seed):
    """q, k, v (numpy fp32) and a bias [B, MG, S_] with random masked
    columns and one open column per row; where S_ > CHUNK, query row 0 of
    batch row 0 is open in one column of the last chunk only and row 1 in
    the first chunk only."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, MG, HD)).astype(np.float32) * HD ** -0.5
    k = rng.normal(size=(B, H, HD, S_)).astype(np.float32)
    v = rng.normal(size=(B, H, HD, S_)).astype(np.float32)
    bias = np.where(rng.random((B, MG, S_)) < 0.3, -np.inf, 0.0)
    bias[np.arange(B)[:, None], np.arange(MG)[None],
         rng.integers(0, S_, size=(B, MG))] = 0.0
    if S_ > CHUNK:
        bias[0, :2] = -np.inf
        bias[0, 0, S_ - 1] = 0.0
        bias[0, 1, :CHUNK] = 0.0
    return q, k, v, bias.astype(np.float32)


@pytest.mark.parametrize("form", ["fp32", "bf16", "int4"])
def test_single_shot_bb_changes_no_bit(form):
    """bb = 1, 2 and 4 give the same bits, through the wrappers (the
    plain version on the CPU) and batch row by batch row through the
    kernel's route: a row's result does not depend on its batch."""
    q, k, v, bias = (torch.from_numpy(a) for a in _split_inputs(300, 5))
    if form == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    if form == "int4":
        (k4, ks), (v4, vs) = (map(torch.from_numpy, map(np.array,
                                  _quantize_kv4(jnp.asarray(t.numpy()))))
                              for t in (k, v))
        outs = [decode_attention_q4split(q, k4, ks, v4, vs, bias, bb=bb)
                for bb in (1, 2, 4)]
        route = decode_attention_q4split_split_plain
        args = (q, k4, ks, v4, vs, bias)
    else:
        outs = [decode_attention_single(q, k, v, bias, bb=bb)
                for bb in (1, 2, 4)]
        route = decode_attention_single_split_plain
        args = (q, k, v, bias)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    full = route(*args)
    for b in range(B):
        assert torch.equal(route(*(t[b:b + 1] for t in args)),
                           full[b:b + 1])


def test_single_shot_refusals_and_counters():
    """S=4096 at MG=20, hd=64 (past what a block's shared memory could
    hold of the score row) runs, and equals the plain version by the kernel's
    route too; where bb does not divide B the wrappers refuse on every
    device; the CPU route launches nothing."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((1, 2, 20, 64), (1, 2, 64, 4096),
                             (1, 2, 64, 4096)))
    q = q * 0.125
    bias = torch.zeros(1, 20, 4096)
    out = decode_attention_single(q, k, v, bias)
    assert out.shape == q.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out, decode_attention_plain(q, k, v, bias),
                               atol=0, rtol=0)
    torch.testing.assert_close(
        decode_attention_single_split_plain(q, k, v, bias), out, **FP32_TOL)
    q, k, v, bias = map(torch.from_numpy, _inputs(3))
    with pytest.raises(ValueError, match="multiple of bb=3"):
        decode_attention_single(q, k, v, bias, bb=3)
    k4 = torch.zeros(B, H, HD // 2, S, dtype=torch.int8)
    sc = torch.ones(B, H, 1, S)
    with pytest.raises(ValueError, match="multiple of bb=8"):
        decode_attention_q4split(q, k4, sc, k4, sc, bias, bb=8)
    with pytest.raises(ValueError, match="packed int4"):
        decode_attention_q4split(q, k.to(torch.int8), sc, k.to(torch.int8),
                                 sc, bias)
    n = (decode_attention_single.launches, decode_attention_q4split.launches)
    decode_attention_single(q, k, v, bias, bb=4)
    decode_attention_q4split(q, k4, sc, k4, sc, bias, bb=2)
    assert (decode_attention_single.launches,
            decode_attention_q4split.launches) == n


def test_kernel_variants_tool_on_cpu(capsys):
    rc = kernel_variants.main(["--variant", "all", "--B", "4", "--S", "70",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    for v in kernel_variants.VARIANTS:
        assert f"{v}: max abs err vs plain = 0 " in out
        assert f"{v}: " in out and "ms per 100 calls" in out
    assert out.count("timed the plain version") == len(
        kernel_variants.VARIANTS)
    assert "GB/s" not in out              # no device rate from a CPU run
    with pytest.raises(SystemExit):
        kernel_variants.main(["--variant", "nope", "--device", "cpu",
                              "--B", "2", "--S", "8"])


def test_longctx_variants_tool_on_cpu(capsys):
    for v in longctx_variants.VARIANTS:
        assert longctx_variants.main(["--variant", v, "--B", "2", "--S",
                                      "130", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for v in longctx_variants.VARIANTS:
        assert f"{v}: max abs err vs plain = 0 " in out
        assert f"{v}: runs the plain version" in out
    assert out.count("timed the plain version") == 4
    res = longctx_variants.run("single1", B=1, S=4096, device="cpu")
    assert res["fits"] is True and res["ok"] and res["err"] == 0
    assert "single1: max abs err vs plain = 0 " in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        longctx_variants.main(["--variant", "tiled", "--BB", "2",
                               "--device", "cpu"])
    assert e.value.code == 2
    assert "fixed at 256 columns" in capsys.readouterr().err


def test_profile_decode_tool_on_cpu(capsys):
    res = profile_decode.run(B=2, K=2, S=12, device="cpu", small=True)
    out = capsys.readouterr().out
    assert list(res) == [name for name, _ in profile_decode.ABLATIONS]
    assert all(ms > 0 for ms in res.values())
    assert "rows=4 bf16" in out and "timed the plain version" in out
    assert out.count(" x100 ") == 4


def test_profile_decode_chain_is_the_step_without_attention():
    """The conv/proj/FFN ablation is decoder_step itself with the attention
    swapped out: scaling every context's values moves step_only's features
    and not the chain's, and the swap ends with the call."""
    from tell_tpu_torch.config import small_test_config
    from tell_tpu_torch.models import decoder
    attn = decoder._attn_group
    cfg = small_test_config(max_target_positions=profile_decode.STEPS)
    with torch.inference_mode():
        env = profile_decode.setup(cfg, 2, 2, 12, "cpu", 0)
        kv3 = [{n: leaf * 3 if n == "v" else leaf for n, leaf in kv.items()}
               for kv in env["state"]["kv"]]
        env3 = {**env, "state": {**env["state"], "kv": kv3}}
        chain, chain3 = (profile_decode.conv_chain_only(e)
                         for e in (env, env3))
        step, step3 = (profile_decode.step_only(e) for e in (env, env3))
    assert decoder._attn_group is attn
    assert torch.isfinite(chain.float()).all()
    assert torch.equal(chain, chain3)
    assert not torch.equal(step, step3)


def test_bf16_decode_step_follows_jax():
    """profile_decode's bf16 step. The JAX package's bf16 step does not run
    on XLA's CPU backend (DotThunk has no BF16 x BF16 = F32), so the port's
    bf16 step is held to JAX's fp32 step on the same bf16-rounded weights
    and contexts: features within 2e-2 of their largest magnitude (bf16
    rounds at each op, about 2^-8 relative), top-k log-probs within 0.1
    and equal top-1 ids over six greedy steps of beam rows."""
    from tell_tpu.config import small_test_config
    from tell_tpu.models import decoder as jd
    from tell_tpu_torch.models import decoder as td
    cfg = small_test_config().decoder
    params = jax.jit(lambda r: jd.init_decoder(r, cfg))(
        jax.random.PRNGKey(0))
    p32 = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16),
                                            np.float32)
                       if x.dtype == jnp.float32 else np.asarray(x), params)
    tparams = tree_map(lambda t: t.to(torch.bfloat16)
                       if t.dtype == torch.float32 else t,
                       to_torch(p32, "cpu"))
    rng = np.random.default_rng(0)
    nb, beam = 2, 3
    ctx = {}
    for spec in cfg.contexts:
        f = rng.normal(size=(nb, spec.max_len, spec.kv_dim)).astype(
            np.float32)
        f = np.asarray(jnp.asarray(f, jnp.bfloat16), np.float32)
        mask = np.zeros((nb, spec.max_len), bool)
        mask[1, spec.max_len // 2:] = True
        ctx[spec.name] = (f, mask)
    j_state = jax.jit(lambda p, c: jd.init_decode_state(
        p, cfg, c, nb, beam=beam))(p32, ctx)
    t_state = td.init_decode_state(
        tparams, cfg, {k: (torch.from_numpy(f).to(torch.bfloat16),
                           torch.from_numpy(m)) for k, (f, m) in ctx.items()},
        nb, beam=beam, dtype=torch.bfloat16)
    j_step = jax.jit(lambda p, t, s: jd.decoder_step(p, cfg, t, s)[:2])
    j_topk = jax.jit(lambda p, f: jd.decoder_top_k(p, cfg, f, 5))
    toks = rng.integers(3, cfg.vocab_size, size=nb * beam)
    for _ in range(6):
        rx, j_state = j_step(p32, jnp.asarray(toks), j_state)
        x, t_state = td.decoder_step(tparams, cfg, torch.from_numpy(toks),
                                     t_state)
        assert x.dtype == torch.bfloat16
        ref = np.asarray(rx)
        assert np.abs(to_numpy(x.float()) - ref).max() <= (
            2e-2 * np.abs(ref).max())
        jl, ji = j_topk(p32, rx)
        tl, ti = td.decoder_top_k(tparams, cfg, x, 5)
        np.testing.assert_array_equal(to_numpy(ti)[:, 0], np.asarray(ji)[:, 0])
        assert np.abs(to_numpy(tl.float()) - np.asarray(jl)).max() <= 0.1
        toks = np.asarray(ji)[:, 0]
