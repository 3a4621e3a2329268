"""Kernel E's schedule and its fp32 route against tell_tpu on the CPU.

topk_logits_tiled computes kernel E's function the way the CUDA kernel
does: 128-entry vocabulary chunks, each chunk's top-k (lower id first on
ties) and (max, sum of exp), then the merge. Here it is held to tell_tpu's
Pallas topk_logits in interpret mode and to its jnp reference, with a
ragged last chunk, the pinned padding row in the first, a middle and the
last chunk (tell_tpu's kernel has no zero_row, so its table has that row
zeroed), equal logits in three chunks, and k from 1 to 8. The kernel's
fp32 route, 3xTF32 tensor-core products with the operands cut by masks
(tell_tpu_torch/ops/kernels/tf32.py), is held to float64 on the engine's
value scale; under a model of the mma fragment's accumulation (the sum
rounded toward zero at every k-step), which gives the error the card
showed for one fragment over all of D, the kernel's per-slot fragments
added in fp32 keep TOPK_TOL in fp32 and bf16.

Inputs from numpy seeds. Tolerances: values and logsumexp 1e-5 (the same
fp32 products summed in another order), ids exact; the 3xTF32 emulation
within chip_smoke.py's TOPK_TOL (1e-5) of float64.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tell_tpu.ops.kernels import topk_logits as jt
from tell_tpu_torch.bridge import to_numpy
from tell_tpu_torch.ops.kernels.tf32 import (mm_3xtf32, mm_tf32,
                                             mma_accumulate, split)
from tell_tpu_torch.ops.kernels.topk_logits import (CHUNK, topk_logits_plain,
                                                    topk_logits_tiled)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(N, V, D, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    table = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    return x, table


def _check(out, ref):
    vals, ids, lse = out
    assert ids.dtype == torch.int32
    np.testing.assert_allclose(to_numpy(vals), np.asarray(ref[0]), **TOL)
    np.testing.assert_array_equal(to_numpy(ids), np.asarray(ref[1]))
    np.testing.assert_allclose(to_numpy(lse), np.asarray(ref[2]), **TOL)


# V = 1000 leaves a ragged last chunk of 104 entries; the pinned row sits
# in the first (1), a middle (500) or the last chunk (990)
@pytest.mark.parametrize("k", range(1, 9))
def test_topk_logits_tiled_matches_jax_kernel(k):
    zero_row = (1, 500, 990)[k % 3]
    x, table = _case(5, 1000, 16, 30 + k)
    assert 1000 % CHUNK == 104
    table[:, -1] = 1.0
    x[1] = 0.0
    x[1, -1] = -5.0              # row 1: -5 everywhere but the pinned 0
    zeroed = table.copy()
    zeroed[zero_row] = 0.0
    out = topk_logits_tiled(torch.from_numpy(x), torch.from_numpy(table), k,
                            zero_row=zero_row)
    _check(out, jt.topk_logits(jnp.asarray(x), jnp.asarray(zeroed), k))
    _check(out, jt.reference_topk_logits(jnp.asarray(x), jnp.asarray(zeroed),
                                         k))
    assert to_numpy(out[1])[1, 0] == zero_row


def test_topk_logits_tiled_ties_across_chunks_lower_id_first():
    """Equal logits in chunks 0, 2 and 5 (one 2048-row tile of the Pallas
    kernel): the lower id first, as the Pallas kernel and jax.lax.top_k
    give them, and the same values as the plain version's."""
    x, table = _case(3, 900, 16, 7)
    table[[40, 300]] = table[700]
    x[0] = table[700] * 8.0
    out = topk_logits_tiled(torch.from_numpy(x), torch.from_numpy(table), 5)
    _check(out, jt.topk_logits(jnp.asarray(x), jnp.asarray(table), 5))
    assert to_numpy(out[1])[0, :3].tolist() == [40, 300, 700]
    plain = topk_logits_plain(torch.from_numpy(x), torch.from_numpy(table), 5)
    assert torch.equal(out[1], plain[1])


def _engine_scale(V, seed=4, D=1024):
    """The engine's value scale: 40 rows x ~ N(0, 1), the table at
    D^-1/2."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(40, D)).astype(np.float32))
    table = torch.from_numpy(
        (rng.normal(size=(V, D)) * D ** -0.5).astype(np.float32))
    return x, table


def test_tf32x3_emulation_keeps_topk_tolerance():
    """The kernel's fp32 route at the engine's value scale (x ~ N(0, 1),
    the table at D^-1/2, D = 1024): logits as 3xTF32 products with the
    operands cut by masks stay within TOPK_TOL of float64, in their
    values and their logsumexp, as close to it as an fp32 product is (2.9e-6
    and 2.8e-6 at these inputs); one TF32 product would not (3.4e-3)."""
    x, table = _engine_scale(3000)
    ref = x.double() @ table.double().T
    x3 = mm_3xtf32("nd,vd->nv", x, table)
    one = mm_tf32("nd,vd->nv", x, table)
    torch.testing.assert_close(x3.double(), ref, **TOL)
    torch.testing.assert_close(torch.logsumexp(x3, -1).double(),
                               torch.logsumexp(ref, -1), **TOL)
    err3 = (x3.double() - ref).abs().max().item()
    err1 = (one.double() - ref).abs().max().item()
    err32 = ((x @ table.T).double() - ref).abs().max().item()
    assert err3 < min(TOL["atol"] / 2, 2 * err32), (err3, err32)
    assert err1 > 10 * TOL["atol"], err1


@pytest.mark.parametrize("route", ["3xtf32", "bf16"])
def test_mma_fragments_added_per_slot_keep_topk_tolerance(route):
    """Kernel E's logits under the accumulator model (mma_accumulate): one
    fragment over all 1024 elements of D drifts from float64 (fp32: 4.0e-5,
    past TOPK_TOL, as an H100 read 3.4e-5..6.4e-5 for a kernel built that
    way; bf16: 6.0e-6, 7x its fp32 sum's error); a fresh fragment per
    ring slot (32 fp32 or 64 bf16 elements of D), added to the logits in
    fp32, stays within twice the error of an fp32 product."""
    x, table = _engine_scale(1000)
    if route == "3xtf32":
        (xh, xl), (th, tl) = split(x), split(table)
        pairs, k_step, slot = ((xl, th), (xh, tl), (xh, th)), 8, 32
    else:
        x, table = x.bfloat16().float(), table.bfloat16().float()
        pairs, k_step, slot = ((x, table),), 16, 64
    ref = x.double() @ table.double().T
    err32 = ((x @ table.T).double() - ref).abs().max().item()
    one = (mma_accumulate(pairs, k_step).double() - ref).abs().max().item()
    per_slot = (mma_accumulate(pairs, k_step, slot).double()
                - ref).abs().max().item()
    assert per_slot < min(TOL["atol"] / 2, 2 * err32), (per_slot, err32)
    assert one > 3 * per_slot, (one, per_slot)
    if route == "3xtf32":
        assert one > TOL["atol"], one
