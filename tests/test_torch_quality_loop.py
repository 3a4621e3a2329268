"""The port's quality loop on the CPU at a tiny size, and its gazetteer
scoring against tools/quality_loop.py's.

The loop runs every phase through `python -m tell_tpu_torch.commands`
(preprocess, before, train, after greedy and beam, re-score, the kv8 and
fused top-k A/Bs) on overfit_small.yaml cut to 2 epochs, 64-token
articles and 4-token captions, journals its phases, and with --resume
skips the journaled ones. (Convergence is the card's run:
tests/fixtures/quality/torch_h100.)
"""
import glob
import importlib.util
import json
import os

import torch

from tell_tpu_torch.tools import quality_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(ROOT, "tests", "fixtures", "quality")


def _jax_loop():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_loop", os.path.join(ROOT, "tools", "quality_loop.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gazetteer_scoring_equals_jax():
    jax_loop = _jax_loop()
    with open(os.path.join(QUALITY, "entities.json"), encoding="utf-8") as f:
        entities = json.load(f)
    text = "Zainab Weber met Zainab in Lisbon at Halcyon Labs, not Lisbonia."
    assert (quality_loop.gazetteer_ner(entities)(text)
            == jax_loop.gazetteer_ner(entities)(text))
    for path in sorted(glob.glob(os.path.join(QUALITY, "r05", "*.jsonl"))):
        assert (quality_loop.reproduction_and_entities(path, entities)
                == jax_loop.reproduction_and_entities(path, entities))


def test_quality_loop_phases_and_resume(tmp_path):
    torch.set_num_threads(2)
    over = json.dumps({
        "trainer": {"serialization_dir": str(tmp_path / "run"),
                    "num_epochs": 2},
        "data": {"shards_dir": str(tmp_path / "shards"),
                 "objects_jsonl": str(tmp_path / "feat" / "objects.jsonl"),
                 "images_dir": str(tmp_path / "feat" / "grids")},
        # a 64-token article context: the encode is most of the time here
        "model": {"gen_len": 4, "decoder": {"contexts": [
            {"name": "image", "kv_dim": 2048, "max_len": 49},
            {"name": "article", "kv_dim": 1024, "max_len": 64},
            {"name": "faces", "kv_dim": 512, "max_len": 4},
            {"name": "obj", "kv_dim": 2048, "max_len": 64}]}},
        "bucketing": {"article_lengths": [64]}})
    argv = ["--expt", os.path.join(ROOT, "expt/quality/overfit_small.yaml"),
            "--device", "cpu", "--beam", "2", "--overrides", over]
    assert quality_loop.main(argv) == 0
    run = tmp_path / "run"
    with open(run / "quality.json") as f:
        q = json.load(f)
    with open(run / "quality-phases.json") as f:
        journal = json.load(f)
    assert set(journal) == {"preprocess", "before", "train", "after"}
    assert journal["preprocess"]["examples"] == 32
    assert journal["train"]["result"]["epochs"] == 2
    for key in ("before", "before_beam", "after_greedy", "after_beam"):
        assert q[key]["n_samples"] == q[key]["n"] == 32
    assert q["ab_kv8"]["kv_cache_mode"] == "int8"
    assert q["ab_fused_topk"]["topk_mode"] == "fused"
    assert q["ab_fast_gelu"]["gelu_mode"] == "tanh"
    assert q["after_beam"]["gelu_mode"] == "erf"
    for ab in ("ab_kv8", "ab_fused_topk", "ab_fast_gelu"):
        assert 0.0 <= q[ab]["caption_agreement_vs_default"] <= 1.0
        # the CPU runs every kernel's plain version
        assert set(q[ab]["kernel_launches"].values()) == {0}
    assert q["score_rescore_beam"]["cider"] == q["after_beam"]["cider"]
    assert (run / "generations-after-beam2.jsonl").exists()
    assert (tmp_path / "feat" / "grids" / "qh0000.npy").exists()

    # --resume skips the journaled phases and evaluates again
    os.remove(run / "generations-after-beam2.jsonl")
    assert quality_loop.main(argv + ["--resume"]) == 0
    with open(run / "quality.json") as f:
        again = json.load(f)
    assert again["train_seconds"] == q["train_seconds"]
    assert again["before_seconds"] == q["before_seconds"]
    assert (run / "generations-after-beam2.jsonl").exists()
