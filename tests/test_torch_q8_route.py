"""Kernel D's chunked route against tell_tpu on the CPU.

decode_attention_q8_split_plain computes kernel D's function the way the
CUDA kernel does: K/V dequantised exactly (packed int4 unpacked), 256-column
chunks, the partial (m, l, acc) in fp32 with m from -1e30, l over the raw
exponentials and the PV product on p * v_scale (the TPU's tiled q8
kernel), combined in chunk order. Here it is held to tell_tpu's
fused_decode_attention_q8 and _tiled_decode_attention_q8 in interpret mode,
int8 and int4, at S below, at and across the chunks and at the flagship's
two sources (637, 2173), with a query row whose every chunk but the last
is fully masked.

Inputs from numpy seeds; K/V quantised by the port's quantize_kv /
quantize_kv4 (their bytes equal JAX's: tests/test_torch_kv_quant.py).
Tolerance: atol = rtol = 1e-5, the same int8 math summed in another order,
as test_decode_attention_q8_plain_matches_jax holds the plain version.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tell_tpu.ops.kernels import decode_attention as jk
from tell_tpu_torch.bridge import to_numpy
from tell_tpu_torch.models import decoder as td
from tell_tpu_torch.ops.kernels.decode_attention import (
    CHUNK, decode_attention_q8_plain, decode_attention_q8_split_plain,
    split_count)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
QUANT = {"int8": td.quantize_kv, "int4": td.quantize_kv4}


def _q8_case(mode, B, H, M, G, S, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, M * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, H, hd, S)).astype(np.float32)
    v = rng.normal(size=(B, H, hd, S)).astype(np.float32)
    k8, ks = map(to_numpy, QUANT[mode](torch.from_numpy(k)))
    v8, vs = map(to_numpy, QUANT[mode](torch.from_numpy(v)))
    seg = np.sort(rng.integers(0, M, size=S))
    seg[:M] = np.arange(M)
    seg = np.sort(seg)
    pad = rng.random((B, S)) < 0.2
    pad[:, np.searchsorted(seg, np.arange(M))] = False
    bias = np.array(jk.segment_bias(jnp.asarray(seg), jnp.asarray(pad), M,
                                    G))
    return [q, k8, ks, v8, vs, bias]


# S below, at and across kernel D's 256-column chunks, and the flagship's
# two sources
@pytest.mark.parametrize("S", [5, 256, 257, 637, 2173])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_decode_attention_q8_split_route_matches_jax(mode, S):
    """Query row 0 of batch row 0 is open in one column of the last chunk
    only, so every other chunk is fully masked for it (m = -1e30, l = 0,
    weight 0 in the combine); row 1 in the first chunk only."""
    args = _q8_case(mode, 2, 2, 4, 2, S, 16, 20 + S)
    bias = args[5]
    bias[0, :2] = -np.inf
    bias[0, 0, S - 1] = 0.0
    bias[0, 1, :min(S, CHUNK)] = 0.0
    if S > CHUNK:
        assert np.isinf(bias[0, 0, :CHUNK]).all()
    assert split_count(S) == -(-S // 256)
    targs = [torch.from_numpy(a) for a in args]
    out = to_numpy(decode_attention_q8_split_plain(*targs))
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(out, np.asarray(
        jk.fused_decode_attention_q8(*jargs)), **TOL)
    np.testing.assert_allclose(out, np.asarray(jk._tiled_decode_attention_q8(
        *jargs, 1, 128, pack4=mode == "int4")), **TOL)
    np.testing.assert_allclose(out, to_numpy(
        decode_attention_q8_plain(*targs)), **TOL)
    assert np.isfinite(out).all()
