"""Machine-check the port's committed quality-loop evidence from the card
(tests/fixtures/quality/torch_h100/, written by `chip_smoke.py --quality`
on an NVIDIA H100; mirrors tests/test_quality_fixtures.py).

The beam-5 generations are re-scored with the port's scorer and with
tell_tpu's: both give the same numbers, and those are the metrics the
run committed (METEOR's stem stage runs only where nltk is installed, so
the re-score takes the stemmer away where the card's run had none). The
phase journal must meet the loop's thresholds: before CIDEr <= 5, after
beam CIDEr >= 900 with >= 30 of 32 training captions exact, the kv8
and fused top-k A/Bs reported with kernels D and E launched, and the
tanh-GELU A/B reported against the erf decode.
"""
import json
import os

import pytest

from tell_tpu.commands.evaluate import score_file as j_score_file
from tell_tpu.evalm import meteor as j_meteor
from tell_tpu_torch.commands.evaluate import score_file
from tell_tpu_torch.evalm import meteor as t_meteor

H100 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "quality", "torch_h100")
GENERATIONS = os.path.join(H100, "generations-after-beam5.jsonl")
SCORE_KEYS = ("bleu-1", "bleu-2", "bleu-3", "bleu-4", "rouge-l",
              "meteor_exact_stem", "cider", "meteor")


@pytest.fixture(scope="module")
def journal():
    with open(os.path.join(H100, "quality-phases.json"),
              encoding="utf-8") as f:
        return json.load(f)


def _rows():
    with open(GENERATIONS, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_rescore_equals_jax_and_the_committed_metrics(journal, monkeypatch):
    assert score_file(GENERATIONS) == j_score_file(GENERATIONS)
    if not journal["after"]["config"]["nltk"]:
        for mod in (t_meteor, j_meteor):
            monkeypatch.setattr(mod, "_STEMMER", False)
    port, jax = score_file(GENERATIONS), j_score_file(GENERATIONS)
    assert port == jax
    committed = journal["after"]["after_beam"]
    assert {k: port[k] for k in SCORE_KEYS} == {
        k: committed[k] for k in SCORE_KEYS}
    assert journal["after"]["score_rescore_beam"] == port


def test_thresholds_and_lever_ab(journal):
    rows = _rows()
    assert len(rows) == 32
    exact = sum(r["generation"] == r["caption"] for r in rows)
    assert exact >= 30
    after = journal["after"]["after_beam"]
    assert after["cider"] >= 900
    assert after["caption_reproduction_exact"] == exact / 32
    assert journal["before"]["metrics"]["cider"] <= 5
    assert journal["preprocess"]["examples"] == 32
    assert journal["train"]["result"]["epochs"] == 200
    assert after["kv_cache_mode"] == "fp" and after["topk_mode"] == "exact"
    assert after["kernel_launches"]["decode_attention"] > 0
    for ab, name, mode in (("ab_kv8", "decode_attention_q8",
                            ("int8", "exact")),
                           ("ab_fused_topk", "topk_logits", ("fp", "fused"))):
        res = journal["after"][ab]
        assert 0.0 <= res["caption_agreement_vs_default"] <= 1.0
        assert (res["kv_cache_mode"], res["topk_mode"]) == mode
        assert res["kernel_launches"][name] > 0
    gelu = journal["after"]["ab_fast_gelu"]
    assert gelu["flags"] == ["--gelu", "tanh"] and gelu["gelu_mode"] == "tanh"
    assert (gelu["kv_cache_mode"], gelu["topk_mode"]) == ("fp", "exact")
    assert 0.0 <= gelu["caption_agreement_vs_default"] <= 1.0
    assert after["gelu_mode"] == "erf"


def test_readme_names_the_card_and_the_command():
    with open(os.path.join(H100, "README.md"), encoding="utf-8") as f:
        text = f.read()
    for word in ("NVIDIA H100", "chip_smoke.py --quality", "seed 0",
                 "overfit_flagship.yaml"):
        assert word in text
