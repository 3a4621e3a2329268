"""Kernel A's chunked route at the sibling configurations' decode shapes
against tell_tpu on the CPU: decode_attention_split_plain (per-chunk
(m, l, acc) from -1e30, combined in chunk order) against
fused_decode_attention in interpret mode at MG = M x G of 1 (no image,
greedy), 3 (faces, greedy), 5 (no image, beam 5) and 15 (faces, beam 5),
over the no-image source (S=514) and the faces one (S=571). On the card
these query-row counts take partial row tiles (the kernel's tiles hold
4/8/20/40 rows) and partial PV passes; chip_smoke.py phase 3 holds the
kernel itself to this plain version there. Tolerance: atol = rtol = 1e-5
(fp32, another summation order)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tell_tpu_torch.bridge import to_numpy
from tell_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, decode_attention_split_plain)
from tests.test_torch_kernels import _decode_inputs

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [514, 571])
@pytest.mark.parametrize("MG", [1, 3, 5, 15])
def test_split_route_at_sibling_rows_matches_jax(MG, S):
    from tell_tpu.ops.kernels.decode_attention import (
        fused_decode_attention, segment_bias as j_sb)
    M = 3 if MG % 3 == 0 else 1
    B, H, hd = 2, 2, 64
    q, k, v, seg, pad = _decode_inputs(B, H, M, MG // M, S, hd, MG * S)
    bias = np.array(j_sb(jnp.asarray(seg), jnp.asarray(pad), M, MG // M))
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    out = to_numpy(decode_attention_split_plain(*args))
    np.testing.assert_allclose(out, np.asarray(
        fused_decode_attention(q, k, v, bias)), **TOL)
    # the wrapper on CPU tensors: the plain version, same numbers
    np.testing.assert_allclose(to_numpy(decode_attention(*args)), out,
                               **TOL)
    assert np.isfinite(out).all()
