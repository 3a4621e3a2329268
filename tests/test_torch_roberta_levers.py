"""The frozen RoBERTa's tanh-GELU lever and the HuggingFace conversion
against tell_tpu on the CPU.

* roberta_encode with RobertaConfig(gelu="tanh") encodes as tell_tpu does
  with TELL_TPU_FAST_GELU=tanh (set in this test only), and gelu="erf" as
  it does with erf; the two differ (atol = rtol = 1e-4, as
  tests/test_torch_roberta.py); RobertaEncoder encodes with its config's
  mode. The default is erf; an unknown mode is refused.
* convert_hf_roberta on a random HuggingFace-layout state dict of torch
  tensors, with bare (RobertaModel) and "roberta."-prefixed
  (RobertaForMaskedLM) keys, equals tell_tpu's conversion of the same dict
  leaf for leaf, and encodes as it does.
* `python -m tell_tpu_torch.tools.convert_towers` writes
  towers/roberta/state.pt, its depth read from the keys, which the CLI's
  _frozen_towers reads back equal (with --gelu's mode in its config).
"""
import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from tell_tpu.models.backbones.roberta import (
    RobertaConfig as JRobertaConfig, convert_hf_roberta as j_convert,
    init_roberta as j_init, roberta_encode as j_encode)
from tell_tpu_torch.bridge import to_numpy, to_torch, tree_leaves
from tell_tpu_torch.models.backbones.roberta import (
    RobertaConfig, RobertaEncoder, convert_hf_roberta, roberta_encode)
from tests.test_torch_roberta import RK, _ids

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
JCFG, CFG = JRobertaConfig(**RK), RobertaConfig(**RK)


@pytest.mark.parametrize("mode", ["erf", "tanh"])
def test_gelu_modes_encode_as_jax(monkeypatch, mode):
    monkeypatch.setenv("TELL_TPU_FAST_GELU", mode)
    params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), JCFG))
    ids = _ids(3, 16, 1)
    ref = j_encode(params, JCFG, ids)
    tp = to_torch(params, "cpu")
    cfg = dataclasses.replace(CFG, gelu=mode)
    out = roberta_encode(tp, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), **TOL)
    other = roberta_encode(tp, dataclasses.replace(
        CFG, gelu="erf" if mode == "tanh" else "tanh"), torch.from_numpy(ids))
    assert not torch.equal(out, other)
    enc = RobertaEncoder(tp, cfg)
    assert enc.frozen()["roberta_cfg"].gelu == mode
    assert torch.equal(enc(torch.from_numpy(ids)), out)


def test_unknown_gelu_mode_is_refused():
    assert CFG.gelu == "erf"
    with pytest.raises(ValueError, match="gelu"):
        dataclasses.replace(CFG, gelu="relu")


def _hf_state_dict(prefix: str) -> dict:
    """Random weights under HuggingFace RobertaModel's key names."""
    g = torch.Generator().manual_seed(0)
    D, F = RK["dim"], RK["ffn_dim"]

    def t(*shape):
        return torch.randn(shape, generator=g) * 0.05

    sd = {"embeddings.word_embeddings.weight": t(RK["vocab_size"], D),
          "embeddings.position_embeddings.weight": t(RK["max_positions"], D),
          "embeddings.token_type_embeddings.weight": t(1, D),
          "embeddings.LayerNorm.weight": 1 + t(D),
          "embeddings.LayerNorm.bias": t(D)}
    for i in range(RK["num_layers"]):
        pre = f"encoder.layer.{i}."
        for name, (dout, din) in (
                ("attention.self.query", (D, D)),
                ("attention.self.key", (D, D)),
                ("attention.self.value", (D, D)),
                ("attention.output.dense", (D, D)),
                ("intermediate.dense", (F, D)), ("output.dense", (D, F))):
            sd[pre + name + ".weight"] = t(dout, din)
            sd[pre + name + ".bias"] = t(dout)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + name + ".weight"] = 1 + t(D)
            sd[pre + name + ".bias"] = t(D)
    sd["pooler.dense.weight"] = t(D, D)       # present in HF, unused
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["", "roberta."],
                         ids=["RobertaModel", "RobertaForMaskedLM"])
def test_convert_hf_roberta_matches_jax(prefix):
    sd = _hf_state_dict(prefix)
    ref = jax.tree.map(np.asarray, j_convert(sd, JCFG))
    out = convert_hf_roberta(sd, CFG)
    assert (jax.tree.structure(ref)
            == jax.tree.structure(jax.tree.map(lambda x: 0, to_numpy(out))))
    for a, b in zip(jax.tree.leaves(to_numpy(out)), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    ids = _ids(2, 12, 3)
    np.testing.assert_allclose(
        to_numpy(roberta_encode(out, CFG, torch.from_numpy(ids))),
        np.asarray(j_encode(ref, JCFG, ids)), **TOL)


def test_converted_tower_is_what_the_cli_reads(tmp_path):
    from tell_tpu_torch.commands import __main__ as cli
    from tell_tpu_torch.config_io import load_experiment
    from tell_tpu_torch.tools import convert_towers
    from tests.test_torch_cli import write_e2e_config
    cfg = write_e2e_config(tmp_path)
    exp = load_experiment(cfg)
    n = RK["num_layers"]
    sd = _hf_state_dict("roberta.")
    src = tmp_path / "hf.pt"
    torch.save(sd, src)
    assert convert_towers.main(["--out", cli._towers_dir(exp), "--roberta",
                                str(src)]) == 0
    assert os.path.exists(os.path.join(cli._towers_dir(exp), "roberta",
                                       "state.pt"))
    frozen = cli._frozen_towers(exp, "cpu", gelu="tanh")
    assert frozen["roberta_cfg"].gelu == "tanh"
    want = convert_hf_roberta(sd, CFG)
    assert len(frozen["roberta"]["layers"]) == n
    for a, b in zip(tree_leaves(frozen["roberta"]), tree_leaves(want)):
        assert torch.equal(a, b)
