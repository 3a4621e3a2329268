"""The port's evaluate_split against tell_tpu's on the CPU.

One JAX init of the captioner and of the tiny RoBERTa, carried across with
bridge.to_torch; the same shards (tests/test_e2e_cli.py's corpus and small
config, preprocessed by the port); both packages' evaluate_split, greedy
and beam 2: the generations files are identical line for line, and the
metrics are equal apart from the two timing keys.
"""
import json
import os

import jax
import pytest
import torch

from tell_tpu.commands.evaluate import evaluate_split as j_evaluate
from tell_tpu.config_io import load_experiment as j_load
from tell_tpu.data.tokenizer import RobertaTokenizer as JTokenizer
from tell_tpu.models.backbones.roberta import RobertaConfig as JRoberta
from tell_tpu.models.backbones.roberta import init_roberta as j_roberta
from tell_tpu.models.captioner import init_captioner as j_captioner
from tell_tpu_torch.bridge import to_torch
from tell_tpu_torch.commands.__main__ import main
from tell_tpu_torch.commands.evaluate import evaluate_split
from tell_tpu_torch.config_io import load_experiment
from tell_tpu_torch.data.tokenizer import RobertaTokenizer
from tell_tpu_torch.models.backbones.roberta import RobertaConfig
from tests.test_torch_cli import write_e2e_config

TIMING = ("captions_per_sec", "captions_per_sec_steady")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval")
    cfg = write_e2e_config(root)
    assert main(["preprocess", cfg, "-s", "valid"]) == 0
    jexp, exp = j_load(cfg), load_experiment(cfg)
    key = jax.random.PRNGKey(3)
    params = j_captioner(key, jexp.model)
    roberta = j_roberta(jax.random.fold_in(key, 1), JRoberta.tiny())
    jax_side = (params, {"roberta": roberta, "roberta_cfg": JRoberta.tiny()},
                JTokenizer.from_files(jexp.data.vocab_file,
                                      jexp.data.merges_file, max_len=128,
                                      use_native=False))
    torch_side = (to_torch(params, "cpu"),
                  {"roberta": to_torch(roberta, "cpu"),
                   "roberta_cfg": RobertaConfig.tiny()},
                  RobertaTokenizer.from_files(exp.data.vocab_file,
                                              exp.data.merges_file,
                                              max_len=128))
    return root, jexp, exp, jax_side, torch_side


@pytest.mark.parametrize("beam", [1, 2])
def test_evaluate_split_equals_jax(setup, beam):
    torch.set_num_threads(2)
    root, jexp, exp, jax_side, torch_side = setup
    jdir, tdir = str(root / f"jax{beam}"), str(root / f"torch{beam}")
    jm = j_evaluate(jexp, *jax_side, split="valid", beam_size=beam,
                    out_dir=jdir)
    tm = evaluate_split(exp, *torch_side, split="valid", beam_size=beam,
                        out_dir=tdir, device="cpu")
    with open(os.path.join(jdir, "generations-valid.jsonl")) as f:
        jrows = [json.loads(line) for line in f]
    with open(os.path.join(tdir, "generations-valid.jsonl")) as f:
        trows = [json.loads(line) for line in f]
    assert len(trows) == 10
    assert trows == jrows
    assert any(r["generation"] for r in trows)
    for k in TIMING:
        jm.pop(k), tm.pop(k)
    assert tm == jm
