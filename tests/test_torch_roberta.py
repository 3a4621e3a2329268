"""tell_tpu_torch's RoBERTa encoder against tell_tpu's on the CPU.

JAX runs its einsum attention path (the flash kernel is TPU-only); the port
runs kernel B's plain version. Weights: tell_tpu's init_roberta carried
across with the bridge, with random LayerNorm params so they count.
Tolerance: 1e-4 absolute and relative on the hidden states (a stack of
layers, summed in another order); every row, pad rows included.
"""
import numpy as np
import jax
import pytest
import torch

from tell_tpu.models.backbones.roberta import (
    RobertaConfig as JRobertaConfig, init_roberta as j_init,
    roberta_encode as j_encode, roberta_encode_windowed as j_windowed)
from tell_tpu_torch.bridge import to_numpy, to_torch
from tell_tpu_torch.models.backbones.roberta import (
    RobertaConfig, RobertaEncoder, roberta_encode, roberta_encode_windowed)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
RK = dict(vocab_size=300, dim=32, num_layers=2, num_heads=2, ffn_dim=64,
          max_positions=20)
JCFG, CFG = JRobertaConfig(**RK), RobertaConfig(**RK)


@pytest.fixture(scope="module")
def params():
    p = jax.tree.map(np.array, j_init(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(0)
    for ln in [p["embed_ln"]] + [lp[n] for lp in p["layers"]
                                 for n in ("attn_ln", "ffn_ln")]:
        ln["scale"] = rng.uniform(0.5, 1.5, ln["scale"].shape).astype(
            np.float32)
        ln["bias"] = rng.normal(0, 0.1, ln["bias"].shape).astype(np.float32)
    return p


def _ids(B, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, RK["vocab_size"], size=(B, S))
    ids[:, 0] = 0
    ids[1, S // 2:] = CFG.pad_id       # padded article
    ids[-1, :] = CFG.pad_id            # all-pad filler row
    return ids


@pytest.mark.parametrize("all_hiddens", [True, False])
def test_roberta_encode_matches_jax(params, all_hiddens):
    ids = _ids(3, 16, 1)
    ref = j_encode(params, JCFG, ids, return_all_hiddens=all_hiddens)
    out = roberta_encode(to_torch(params, "cpu"), CFG, torch.from_numpy(ids),
                         return_all_hiddens=all_hiddens)
    assert out.shape == ref.shape
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), **TOL)


def test_roberta_encode_windowed_matches_jax(params):
    ids = _ids(2, 41, 2)    # 3 windows of 18 (max_positions - 2), ragged
    ref = j_windowed(params, JCFG, ids)
    enc = RobertaEncoder(to_torch(params, "cpu"), CFG)
    out = enc(torch.from_numpy(ids))
    assert out.shape == (2, 41, CFG.num_layers + 1, CFG.dim)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), **TOL)
    torch.testing.assert_close(out, roberta_encode_windowed(
        enc.frozen()["roberta"], CFG, torch.from_numpy(ids)))


def test_config_mirror_matches_jax():
    import dataclasses
    for name in ("large", "base", "tiny"):
        port = dataclasses.asdict(getattr(RobertaConfig, name)())
        # the port's one field beyond tell_tpu's: the FFN's GELU, which
        # tell_tpu reads from TELL_TPU_FAST_GELU (unset: erf)
        assert port.pop("gelu") == "erf"
        assert port == dataclasses.asdict(getattr(JRobertaConfig, name)())
