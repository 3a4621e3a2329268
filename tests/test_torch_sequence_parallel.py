"""Ulysses sequence parallelism (tell_tpu_torch/parallel/sequence.py) on
2 and 4 gloo ranks against tell_tpu's roberta_encode_seq_parallel on the
virtual 8-device mesh (its "model" axis of the same size).

Each rank's shard, concatenated in rank order, equals tell_tpu's output
within 1e-4 (fp32): every hidden layer, and the final one alone, with
ragged padding. The heads go through kernel B's plain version at
[B, S, H/P, hd]. The refusals are tell_tpu's, message for message: heads
not divisible by the ranks, and S beyond max_positions - 2.
"""
import jax
import numpy as np
import pytest

from tell_tpu.models.backbones.roberta import RobertaConfig as JConfig
from tell_tpu.models.backbones.roberta import init_roberta
from tell_tpu.parallel import make_mesh
from tell_tpu.parallel.sequence import roberta_encode_seq_parallel as j_sp
from tell_tpu_torch.models.backbones.roberta import RobertaConfig
from tell_tpu_torch.parallel import Ranks
from tests import _torch_parallel_workers as W

TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = dict(vocab_size=200, dim=32, num_layers=2, num_heads=4,
              ffn_dim=64)


def setup(S=64, num_heads=4, max_positions=None, num_layers=2):
    """tell_tpu's config and params (numpy), the port's config, ids."""
    fields = {**FIELDS, "num_heads": num_heads, "num_layers": num_layers,
              "max_positions": max_positions or S + 4}
    jcfg = JConfig(**fields)
    params = jax.tree.map(np.asarray,
                          init_roberta(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 200, (2, S)).astype(np.int32)
    ids[:, 0] = 0
    ids[0, S - 10:] = jcfg.pad_id
    ids[1, S // 2 - 3:S // 2 + 2] = jcfg.pad_id
    return jcfg, params, RobertaConfig(**fields), ids


def _reference(jcfg, params, ids, P, all_hiddens):
    mesh = make_mesh(n_data=8 // P, n_model=P)
    fn = jax.jit(lambda p, i: j_sp(p, jcfg, i, mesh, seq_axis="model",
                                   return_all_hiddens=all_hiddens))
    return np.asarray(fn(params, ids))


def _error(fn):
    try:
        fn()
    except (AssertionError, ValueError) as e:
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("P", [2, 4])
def test_ulysses_equals_tell_tpu_and_refuses_as_it_does(P):
    jcfg, params, cfg, ids = setup()
    odd = setup(num_heads=2)             # 2 heads over 4 ranks
    long = setup(S=64, max_positions=40)
    todo = [("encode", (params, cfg, ids, "ulysses", True, None)),
            ("encode", (params, cfg, ids, "ulysses", False, None)),
            ("refused", (long[1], long[2], long[3], "ulysses"))]
    if P == 4:
        todo.append(("refused", (odd[1], odd[2], odd[3], "ulysses")))
    ranks = Ranks(W.jobs, P, (todo,), deadline_s=120)
    wants = [_reference(jcfg, params, ids, P, a) for a in (True, False)]
    outs = ranks.join()
    for job, want in enumerate(wants):
        got = np.concatenate([o[job]["out"].numpy() for o in outs], axis=1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    mesh = make_mesh(n_data=8 // P, n_model=P)
    want = _error(lambda: j_sp(long[1], long[0], long[3], mesh))
    assert outs[0][2] == want and "S=64 exceeds" in want
    if P == 4:
        want = _error(lambda: j_sp(odd[1], odd[0], odd[3], mesh))
        assert outs[0][3] == want and "divisible" in want
