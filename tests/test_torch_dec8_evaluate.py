"""The port's evaluate_split under the int8 and merged-table levers against
tell_tpu's under its flags, on the CPU: beam 2 with the int8 decode step
and the merged table (--dec8 --merged-vocab; TELL_TPU_DEC8,
TELL_TPU_MERGED_VOCAB) here, greedy with the int8 tower (--enc8;
TELL_TPU_ENC8) in tests/test_torch_dec8_evaluate_enc8.py, one evaluate a
file so that each runs in under 30 s (the int8 softmax tables, --dec8-sm,
are held to tell_tpu's in greedy and beam search by
tests/test_torch_dec8_search.py; the command line's flags reach
evaluate_split in tests/test_torch_dec8_serving.py). The int8 tower is
compared on its own: its features differ from tell_tpu's in the last bits
(its LayerNorms and attention sum in another order), and dec8's per-step
int8 rounding would turn that into whole int8 steps
(tests/test_torch_dec8.py).

The e2e corpus and config of tests/test_torch_cli.py, preprocessed by the
port; one jitted JAX init of the captioner and of the tiny RoBERTa carried
across with the bridge. Each package quantises the tower as its command
line does (eagerly, at load). Under dec8 the port's decode takes tell_tpu's
step tables (decode_step_quant patched), for the reason
tests/test_torch_dec8_search.py gives. The generations files are
identical line for line over the split's first four captions (one batch
of the YAML's four), and the metrics are equal apart from the two timing
keys.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from tell_tpu.commands.evaluate import evaluate_split as j_evaluate
from tell_tpu.config_io import load_experiment as j_load
from tell_tpu.data.tokenizer import RobertaTokenizer as JTokenizer
from tell_tpu.models import decoder as jd
from tell_tpu.models.backbones.roberta import RobertaConfig as JRoberta
from tell_tpu.models.backbones.roberta import init_roberta as j_roberta
from tell_tpu.models.captioner import init_captioner as j_captioner
from tell_tpu.ops import quant as jq
from tell_tpu_torch.bridge import to_torch
from tell_tpu_torch.commands.__main__ import main
from tell_tpu_torch.commands.evaluate import evaluate_split
from tell_tpu_torch.config_io import load_experiment
from tell_tpu_torch.data.tokenizer import RobertaTokenizer
from tell_tpu_torch.models import decoder as td
from tell_tpu_torch.models.backbones.roberta import RobertaConfig
from tell_tpu_torch.ops import quant as tq
from tests.test_torch_cli import write_e2e_config
from tests.test_torch_dec8 import _as_port_tables

TIMING = ("captions_per_sec", "captions_per_sec_steady")
LIMIT = 4
ENV = {"enc8": "TELL_TPU_ENC8", "dec8": "TELL_TPU_DEC8",
       "merged_vocab": "TELL_TPU_MERGED_VOCAB"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval_levers")
    cfg = write_e2e_config(root)
    assert main(["preprocess", cfg, "-s", "valid"]) == 0
    jexp, exp = j_load(cfg), load_experiment(cfg)
    params, roberta = jax.tree.map(np.asarray, jax.jit(lambda k: (
        j_captioner(k, jexp.model),
        j_roberta(jax.random.fold_in(k, 1), JRoberta.tiny())))(
            jax.random.PRNGKey(3)))
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


def check_evaluate(setup, monkeypatch, beam, on):
    """Both packages' evaluate_split with the levers `on`, equal."""
    torch.set_num_threads(2)
    root, jexp, exp, jax_side, torch_side = setup
    for name in on:
        monkeypatch.setenv(ENV[name], "1")
    jparams, jfrozen, jtok = jax_side
    tparams, tfrozen, ttok = torch_side
    if "enc8" in on:
        jfrozen = jq.maybe_quantize_frozen(jfrozen)
        tfrozen = tq.maybe_quantize_frozen(tfrozen, True)
    if "dec8" in on:
        tables = _as_port_tables(jax.jit(
            lambda p: jd.decode_step_quant(p, jexp.model.decoder))(
                jparams["decoder"]))
        monkeypatch.setattr(td, "decode_step_quant", lambda p: tables)
    tag = "_".join(on)
    jdir, tdir = str(root / f"jax_{tag}"), str(root / f"torch_{tag}")
    jm = j_evaluate(jexp, jparams, jfrozen, jtok, split="valid",
                    beam_size=beam, out_dir=jdir, limit=LIMIT)
    tm = evaluate_split(exp, tparams, tfrozen, ttok, split="valid",
                        beam_size=beam, out_dir=tdir, device="cpu",
                        limit=LIMIT,
                        **{n: True for n in on if n != "enc8"})
    rows = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "generations-valid.jsonl")) as f:
            rows.append([json.loads(line) for line in f])
    assert len(rows[1]) == LIMIT and rows[1] == rows[0]
    assert any(r["generation"] for r in rows[1])
    for k in TIMING:
        jm.pop(k), tm.pop(k)
    assert tm == jm
    assert np.isfinite(tm["bleu-4"])


def test_evaluate_split_under_dec8_and_the_merged_table_equals_jax(
        setup, monkeypatch):
    check_evaluate(setup, monkeypatch, 2, ("dec8", "merged_vocab"))
