"""Kernel F's route against the three single-shot TPU kernels it replaces,
on the CPU.

decode_attention_single_split_plain and decode_attention_q4split_split_plain
compute kernel F's functions the way the CUDA kernel does: 256-column
chunks, each chunk's fp32 scores and (max from -1e30, sum of exp), the
global max and sum from those in chunk order, p = exp(s - m) / l (times
v_scale for int4) rounded to q's dtype, and the chunks' PV products summed
in chunk order. Here they are held to tools/kernel_variants.py's
fused_batched (BB=2) and fused_q4split (BB=2), and to the BB=1 single-shot
kernel of tools/longctx_variants.py:52 (tell_tpu's _kernel), in interpret
mode as tests/test_torch_decode_variants.py runs them (nothing under
tools/ changes), at S = 1, 256, 257 and 637 in fp32, bf16 and int4, with
masked columns, a row open in one column of the last chunk only and one in
the first chunk only.

Inputs from numpy seeds; int4 K/V by tell_tpu's _quantize_kv4.
Tolerances: fp32 atol 2e-5, rtol 1e-4 (the same math summed in another
order); bf16 2e-2 absolute (both round p and the output to bf16).
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
from tell_tpu_torch.bridge import to_numpy
from tell_tpu_torch.ops.kernels.decode_attention import (
    CHUNK, decode_attention_q4split_split_plain,
    decode_attention_single_split_plain, split_count)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_ATOL = 2e-2
B, H, MG, HD = 4, 4, 6, 16
_interpret = types.SimpleNamespace(
    pallas_call=functools.partial(pl.pallas_call, interpret=True),
    BlockSpec=pl.BlockSpec)


def _tpu_tools(S):
    """tools/kernel_variants.py at the test's shape and source length S,
    Pallas interpreted (a fresh module: its globals set the shapes)."""
    spec = importlib.util.spec_from_file_location(
        "_tpu_kernel_variants", os.path.join(REPO, "tools",
                                             "kernel_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in (("H", H), ("MG", MG), ("hd", HD), ("S", S),
                        ("pl", _interpret)):
        setattr(mod, name, value)
    return mod


def _single1(q, k, v, bias):
    """The inline fn of tools/longctx_variants.py:52: the package's
    single-shot _kernel at BB=1, one grid step per batch row."""
    S = k.shape[3]
    block = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    kv_spec = block((1, H, HD, S), lambda b: (b, 0, 0, 0))
    return _interpret.pallas_call(
        functools.partial(jda._kernel, H=H, BB=1),
        out_shape=jax.ShapeDtypeStruct((q.shape[0], H, MG, HD), q.dtype),
        grid=(q.shape[0],),
        in_specs=[block((1, H, MG, HD), lambda b: (b, 0, 0, 0)), kv_spec,
                  kv_spec, block((1, MG, S), lambda b: (b, 0, 0))],
        out_specs=block((1, H, MG, HD), lambda b: (b, 0, 0, 0)),
    )(q, k, v, bias)


def _inputs(S, seed):
    """q, k, v (numpy fp32) and a bias [B, MG, S] with random masked
    columns and one open column per row; where S > CHUNK, query row 0 of
    batch row 0 is open in one column of the last chunk only and row 1 in
    the first chunk only."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, MG, HD)).astype(np.float32) * HD ** -0.5
    k = rng.normal(size=(B, H, HD, S)).astype(np.float32)
    v = rng.normal(size=(B, H, HD, S)).astype(np.float32)
    bias = np.where(rng.random((B, MG, S)) < 0.3, -np.inf, 0.0)
    bias[np.arange(B)[:, None], np.arange(MG)[None],
         rng.integers(0, S, size=(B, MG))] = 0.0
    if S > CHUNK:
        bias[0, :2] = -np.inf
        bias[0, 0, S - 1] = 0.0
        bias[0, 1, :CHUNK] = 0.0
    return q, k, v, bias.astype(np.float32)


# S: one column, one chunk exactly, one column past it, the flagship's
# source (chunks of 256, 256, 125)
@pytest.mark.parametrize("S", [1, 256, 257, 637])
@pytest.mark.parametrize("form", ["fp32", "bf16", "int4"])
def test_single_shot_split_route_matches_tpu_kernels(form, S):
    """fp32 and bf16: fused_batched (BB=2) and the BB=1 single-shot kernel;
    int4: fused_q4split (BB=2)."""
    tools = _tpu_tools(S)
    q, k, v, bias = _inputs(S, 40 + S)
    assert split_count(S) == -(-S // CHUNK)
    if form == "int4":
        k4, ks = _quantize_kv4(jnp.asarray(k))
        v4, vs = _quantize_kv4(jnp.asarray(v))
        args = [np.array(a) for a in (q, k4, ks, v4, vs)] + [bias]
        out = decode_attention_q4split_split_plain(
            *map(torch.from_numpy, args))
        refs = [tools.fused_q4split(*args, BB=2)]
    elif form == "fp32":
        out = decode_attention_single_split_plain(
            *map(torch.from_numpy, (q, k, v, bias)))
        refs = [tools.fused_batched(q, k, v, bias, BB=2),
                _single1(q, k, v, bias)]
    else:
        qkv = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
        out = decode_attention_single_split_plain(
            *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
            torch.from_numpy(bias))
        assert out.dtype == torch.bfloat16
        refs = [tools.fused_batched(*qkv, bias, BB=2), _single1(*qkv, bias)]
    assert torch.isfinite(out.float()).all()
    for ref in refs:
        ref = np.asarray(ref, np.float32)
        if form == "bf16":
            assert np.abs(to_numpy(out.float()) - ref).max() <= BF16_ATOL
        else:
            np.testing.assert_allclose(to_numpy(out), ref, **FP32_TOL)
