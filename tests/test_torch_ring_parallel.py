"""Ring-attention context parallelism (tell_tpu_torch/parallel/ring.py)
on 2 and 4 gloo ranks against tell_tpu's roberta_encode_ring on the
virtual 8-device mesh (its "model" axis of the same size), one layer.

Each rank's shard, concatenated in rank order, equals tell_tpu's output
within 1e-4 (fp32), with ragged padding; 2 heads over 4 ranks run (the
head count need not divide the ring). The gradients of every param of
sum(w * h) (h the final hidden state, w fixed random weights, zero on
pad rows), each rank's summed over the ring, equal jax.grad of tell_tpu's
ring encode within 1e-4 relative L2 per leaf (a leaf whose gradient is
zero up to rounding, the key bias's, within 1e-7 absolute). S beyond
max_positions - 2 is refused with tell_tpu's message.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tell_tpu.parallel import make_mesh
from tell_tpu.parallel.ring import roberta_encode_ring as j_ring
from tell_tpu_torch.bridge import tree_leaves
from tell_tpu_torch.parallel import Ranks
from tests import _torch_parallel_workers as W
from tests.test_torch_sequence_parallel import TOL, _error, setup


def _weights(ids, dim, pad_id):
    w = np.random.default_rng(5).normal(size=ids.shape + (dim,))
    return (w * (ids != pad_id)[..., None]).astype(np.float32)


@pytest.mark.parametrize("P", [2, 4])
def test_ring_forward_and_gradient_equal_tell_tpu(P):
    jcfg, params, cfg, ids = setup(S=32, num_layers=1)
    w = _weights(ids, cfg.dim, cfg.pad_id)
    odd = setup(S=32, num_heads=2, num_layers=1)
    long = setup(S=64, max_positions=40, num_layers=1)
    # the gradient on 2 ranks, the odd head count on 4
    todo = [("encode", (params, cfg, ids, "ring", True,
                        w if P == 2 else None)),
            ("encode", (odd[1], odd[2], odd[3], "ring", False, None)),
            ("refused", (long[1], long[2], long[3], "ring"))]
    if P == 2:
        todo = [todo[0], todo[2]]
    ranks = Ranks(W.jobs, P, (todo,), deadline_s=120)
    mesh = make_mesh(n_data=8 // P, n_model=P)

    def ring(p, cfg, i, all_hiddens=True):
        return j_ring(p, cfg, i, mesh, seq_axis="model",
                      return_all_hiddens=all_hiddens)
    wants = [np.asarray(jax.jit(lambda p, i: ring(p, jcfg, i))(params, ids))]
    if P == 4:
        wants.append(np.asarray(jax.jit(
            lambda p, i: ring(p, odd[0], i, False))(odd[1], odd[3])))
    else:
        grads = jax.jit(jax.grad(lambda p: jnp.sum(
            w * ring(p, jcfg, ids, False).astype(jnp.float32))))(params)
    refused = _error(lambda: ring(long[1], long[0], long[3]))
    outs = ranks.join()
    for job, ref in enumerate(wants):
        got = np.concatenate([o[job]["out"].numpy() for o in outs], axis=1)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **TOL)
    if P == 2:
        got_g = tree_leaves(outs[0][0]["grads"])
        ref_g = [np.asarray(x) for x in jax.tree.leaves(grads)]
        assert len(got_g) == len(ref_g)
        for a, b in zip(got_g, ref_g):
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b) + 1e-7
    assert outs[0][-1] == refused and "S=64 exceeds" in refused
