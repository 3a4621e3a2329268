"""Plain versions of kernel A (decode attention) and kernel B (encoder
attention) against tell_tpu on the CPU, and the device dispatch rule.

The CUDA kernels themselves need the card: chip_smoke.py builds them and
holds them against these plain versions there. Here the JAX side runs as
its own tests run it on the CPU: the Pallas decode kernels in interpret
mode (fused_decode_attention picks interpret off the TPU) and their jnp
reference, RoBERTa's einsum attention. Tolerance: atol = rtol = 1e-5 for
fp32 outputs (same math, different summation order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tell_tpu_torch.bridge import to_numpy
from tell_tpu_torch.ops.kernels import build, dispatch
from tell_tpu_torch.ops.kernels.decode_attention import (
    CHUNK, decode_attention, decode_attention_plain,
    decode_attention_split_plain, segment_bias, split_count)
from tell_tpu_torch.ops.kernels.encoder_attention import (
    encoder_attention, encoder_attention_plain)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _decode_inputs(B, H, M, G, S, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, M * G, hd)).astype(np.float32) * hd ** -0.5
    k = rng.normal(size=(B, H, hd, S)).astype(np.float32)
    v = rng.normal(size=(B, H, hd, S)).astype(np.float32)
    seg = np.sort(rng.integers(0, M, size=S))
    seg[:M] = np.arange(M)          # every modality owns a column
    seg = np.sort(seg)
    pad = rng.random((B, S)) < 0.2
    pad[:, np.searchsorted(seg, np.arange(M))] = False   # its first column
    return q, k, v, seg, pad


def test_segment_bias_matches_jax():
    from tell_tpu.ops.kernels.decode_attention import segment_bias as j_sb
    _, _, _, seg, pad = _decode_inputs(3, 1, 4, 2, 30, 8, 0)
    ref = j_sb(jnp.asarray(seg), jnp.asarray(pad), 4, 2)
    out = segment_bias(torch.from_numpy(seg), torch.from_numpy(pad), 4, 2)
    np.testing.assert_array_equal(to_numpy(out), np.asarray(ref))


# (B, H, M, G, S, hd): the small shape takes the JAX single-shot kernel;
# the long one (S=2173, the 2048-token article's context) is past
# _pick_bb's VMEM limit and takes the S-tiled kernel with a ragged tile
@pytest.mark.parametrize("shape", [(2, 4, 3, 5, 24, 16),
                                   (2, 16, 4, 5, 2173, 64)],
                         ids=["single_shot", "tiled"])
def test_decode_attention_plain_matches_jax(shape):
    from tell_tpu.ops.kernels.decode_attention import (
        _pick_bb, _pick_tile, fused_decode_attention,
        reference_decode_attention, segment_bias as j_sb)
    B, H, M, G, S, hd = shape
    tiled = _pick_bb(B, H, hd, S, M * G, 4) is None
    assert tiled == (S > 1000)
    if tiled:
        assert _pick_tile(B, H, hd, S, M * G, 4) is not None
    q, k, v, seg, pad = _decode_inputs(B, H, M, G, S, hd, 1)
    bias = j_sb(jnp.asarray(seg), jnp.asarray(pad), M, G)
    out = decode_attention(*map(torch.from_numpy, (q, k, v)),
                           torch.from_numpy(np.array(bias)))
    np.testing.assert_allclose(to_numpy(out), np.asarray(
        fused_decode_attention(q, k, v, bias)), **TOL)
    np.testing.assert_allclose(to_numpy(out), np.asarray(
        reference_decode_attention(q, k, v, bias)), **TOL)


# S below, at and across kernel A's 256-column chunks, and the flagship's
# two sources; sorted segments leave whole chunks masked for most rows
@pytest.mark.parametrize("S", [5, 256, 257, 637, 2173])
def test_decode_attention_split_route_matches_jax(S):
    """decode_attention_split_plain (kernel A's chunked route: per-chunk
    (m, l, acc) from -1e30, combined in chunk order) against tell_tpu's
    fused_decode_attention and _tiled_decode_attention in interpret mode.
    Query row 0 of batch row 0 is open in one column of the last chunk
    only, row 1 in the first chunk only."""
    from tell_tpu.ops.kernels.decode_attention import (
        _tiled_decode_attention, fused_decode_attention, segment_bias as j_sb)
    B, H, M, G, hd = 2, 2, 4, 2, 16
    q, k, v, seg, pad = _decode_inputs(B, H, M, G, S, hd, S)
    bias = np.array(j_sb(jnp.asarray(seg), jnp.asarray(pad), M, G))
    bias[0, :2] = -np.inf
    bias[0, 0, S - 1] = 0.0
    bias[0, 1, :min(S, CHUNK)] = 0.0
    if S > CHUNK:   # some row sees none of some chunk
        masked = np.isinf(bias[:, :, :CHUNK]).all(-1)
        assert masked.any()
    assert split_count(S) == -(-S // 256)
    out = to_numpy(decode_attention_split_plain(
        *map(torch.from_numpy, (q, k, v, bias))))
    np.testing.assert_allclose(out, np.asarray(
        fused_decode_attention(q, k, v, bias)), **TOL)
    np.testing.assert_allclose(out, np.asarray(
        _tiled_decode_attention(q, k, v, bias, 1, 128)), **TOL)
    assert np.isfinite(out).all()


def test_decode_attention_plain_bf16_matches_jax_reference():
    """bf16 storage: both sides take fp32 scores/softmax, cast the
    probabilities to bf16 and round the output to bf16; tolerance 1e-2
    (a few bf16 ulps at |out| ~ 1)."""
    from tell_tpu.ops.kernels.decode_attention import (
        reference_decode_attention)
    q, k, v, seg, pad = _decode_inputs(2, 4, 3, 2, 40, 16, 2)
    bias = segment_bias(torch.from_numpy(seg), torch.from_numpy(pad), 3, 2)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = decode_attention(tq, tk, tv, bias)
    assert out.dtype == torch.bfloat16
    ref = reference_decode_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(to_numpy(bias)))
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref, np.float32),
                               atol=1e-2, rtol=1e-2)


def _jax_einsum_attention(q, k, v, key_pad):
    """roberta_encode's einsum attention (tell_tpu/models/backbones/
    roberta.py:206, 227-232) on [B, S, H, hd] inputs."""
    hd = q.shape[-1]
    neg = jnp.where(~key_pad, 0.0, -1e9)[:, None, None, :]
    scores = jnp.einsum("bthd,bshd->bhts", q, k,
                        preferred_element_type=jnp.float32)
    scores = scores * (hd ** -0.5) + neg
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    return jnp.einsum("bhts,bshd->bthd", probs, v,
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("S", [16, 77])
def test_encoder_attention_plain_matches_jax_einsum(S):
    B, H, hd = 3, 4, 32
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    key_pad = np.zeros((B, S), bool)
    key_pad[0, S // 2:] = True      # a padded article
    key_pad[2, :] = True            # an all-pad filler row
    out = encoder_attention(*map(torch.from_numpy, (q, k, v, key_pad)))
    ref = _jax_einsum_attention(*map(jnp.asarray, (q, k, v, key_pad)))
    # every row, pad rows included, matches the einsum path
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), **TOL)


def test_cpu_tensors_take_the_plain_path():
    q, k, v, seg, pad = _decode_inputs(2, 2, 2, 1, 10, 8, 3)
    bias = segment_bias(torch.from_numpy(seg), torch.from_numpy(pad), 2, 1)
    a0, b0 = decode_attention.launches, encoder_attention.launches
    out = decode_attention(*map(torch.from_numpy, (q, k, v)), bias)
    torch.testing.assert_close(out, decode_attention_plain(
        *map(torch.from_numpy, (q, k, v)), bias), rtol=0, atol=0)
    x = torch.randn(1, 5, 2, 32)
    kp = torch.zeros(1, 5, dtype=torch.bool)
    torch.testing.assert_close(encoder_attention(x, x, x, kp),
                               encoder_attention_plain(x, x, x, kp),
                               rtol=0, atol=0)
    assert (decode_attention.launches, encoder_attention.launches) == (a0, b0)


def test_dispatch_follows_the_device_only():
    cpu = torch.zeros(2)
    assert dispatch.use_kernel(cpu, cpu) is False
    with pytest.raises(ValueError, match="different devices"):
        dispatch.use_kernel(cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="no kernel or plain path"):
        dispatch.use_kernel(torch.zeros(2, device="meta"))
    with pytest.raises(TypeError, match="dtype"):
        dispatch.check_kernel_args("k", {"q": torch.zeros(2).half()},
                                   {"q": (torch.float32,)})
    with pytest.raises(ValueError, match="contiguous"):
        dispatch.check_kernel_args("k", {"q": torch.zeros(4, 4).T},
                                   {"q": (torch.float32,)})


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolkit: the build raises (no fallback to the plain path)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
    # the library name is keyed on the sources: stable for one tree
    assert build.library_path() == build.library_path()
    assert build.library_path().parent == build.BUILD_DIR
