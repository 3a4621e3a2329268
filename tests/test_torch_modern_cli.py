"""The modern family through `python -m tell_tpu_torch.commands` on the
CPU: expts 10 and 12 (nytimes/10_vit_modern.yaml, 12_moe_modern.yaml)
shrunk by an override (dim 32, 2 layers, 4 heads over 2 K/V heads, vocab
300, gen_len 6; the article and faces contexts of tests/test_torch_cli.py's
corpus; 12 keeps its 8 experts, top 2).

The shards come from `preprocess` of that corpus; a checkpoint of random
weights (bridge.init_llm_decoder) stands in for a trained run. `evaluate`
decodes and scores the valid split greedily and at beam 5 and refuses
--fused-topk (the tied head has none); `serve` answers /caption in
micro-batch and engine mode, and the engine refuses --attention as
tell_tpu's does; `train` runs each expt for two epochs from the train
split (the YAMLs' dropouts, 12's MoE at capacity 1.25), validates, and
its best checkpoint evaluates. (tests/test_torch_llm_decoder.py,
test_torch_llm_training.py and test_torch_modern_serving.py hold the
decode, the loss and the service to tell_tpu's.)
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from tell_tpu_torch.bridge import init_llm_decoder
from tell_tpu_torch.commands.__main__ import main
from tell_tpu_torch.config_io import load_experiment
from tests.test_e2e_cli import _articles
from tests.test_tokenizer import build_synthetic_vocab
from tests.test_torch_cli import _last_json, _start_serve

EXPTS = ("expt/nytimes/10_vit_modern.yaml", "expt/nytimes/12_moe_modern.yaml")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _override(root, vf, mf, run: str) -> str:
    return json.dumps({
        "model": {"vocab_size": 300, "dim": 32, "num_layers": 2,
                  "num_heads": 4, "num_kv_heads": 2, "ffn_dim": 48,
                  "gen_len": 6, "max_target_positions": 64,
                  "dropout": 0.0, "attention_dropout": 0.0,
                  "contexts": [
                      {"name": "article", "kv_dim": 1024, "max_len": 128},
                      {"name": "faces", "kv_dim": 512, "max_len": 4}]},
        "reader": {"use_objects": False, "token_budget": 40},
        "trainer": {"serialization_dir": os.path.join(root, run)},
        "data": {"shards_dir": os.path.join(root, "shards"),
                 "articles_jsonl": os.path.join(root, "articles.jsonl"),
                 "vocab_file": vf, "merges_file": mf,
                 "instances_per_epoch": None, "val_limit": 4,
                 "roberta": "tiny"},
        "bucketing": {"article_lengths": [128], "caption_lengths": [16],
                      "max_batch": 4}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The corpus preprocessed once (the valid split), and per expt its
    override and a random-weight checkpoints/best."""
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("modern_cli")
    vf, mf = build_synthetic_vocab(tmp)
    root = str(tmp)
    _articles(os.path.join(root, "articles.jsonl"))
    out = {}
    for i, path in enumerate(EXPTS):
        over = _override(root, str(vf), str(mf), f"run{i}")
        exp = load_experiment(os.path.join(ROOT, path), over)
        best = os.path.join(exp.trainer.serialization_dir, "checkpoints",
                            "best")
        os.makedirs(best)
        torch.save({"params": init_llm_decoder(
            torch.Generator().manual_seed(i), exp.model)},
            os.path.join(best, "state.pt"))
        out[path] = (os.path.join(ROOT, path), over, exp)
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["preprocess", out[EXPTS[0]][0], "-o",
                     out[EXPTS[0]][1], "-s", "valid"]) == 0
    return out


@pytest.mark.parametrize("path", EXPTS)
def test_evaluate_runs_greedy_and_beam(runs, path, capsys):
    yaml, over, exp = runs[path]
    assert exp.model.moe_experts == (8 if "12_" in path else None)
    for beam in ("1", "5"):
        assert main(["evaluate", yaml, "-o", over, "-s", "valid",
                     "--device", "cpu", "-b", beam]) == 0
        metrics = _last_json(capsys)
        assert metrics["n_samples"] == 10 and metrics["kv_cache_mode"] == "fp"
        with open(os.path.join(exp.trainer.serialization_dir,
                               "generations-valid.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        assert len(rows) == 10 and all(r["generation"] for r in rows)
    with pytest.raises(ValueError, match="tied head"):
        main(["evaluate", yaml, "-o", over, "-s", "valid", "--device", "cpu",
              "--fused-topk"])


@pytest.mark.parametrize("path", EXPTS)
def test_serve_answers_in_both_modes(runs, path):
    yaml, over, exp = runs[path]
    for extra in ([], ["--engine-slots", "2", "--engine-beam", "2"]):
        call, server, rc = _start_serve(yaml, ["-o", over] + extra)
        status, body = call("POST", "/caption",
                            {"context": "the mayor spoke in the city"})
        assert status == 200 and "error" not in body, body
        ids = np.asarray(body["token_ids"])
        assert ids.shape == (exp.model.gen_len + 1,) and ids[0] == 0
        assert ids.max() < exp.model.vocab_size
        assert ("alternatives" in body) == bool(extra)
        status, st = call("GET", "/status")
        assert st["config"]["contexts"] == ["article", "faces"]
        call("POST", "/shutdown")
        server.join(timeout=60)
        assert not server.is_alive() and rc == [0]
    with pytest.raises(ValueError, match="attention replay"):
        main(["serve", yaml, "-o", over, "--device", "cpu",
              "--engine-slots", "2", "--attention"])


@pytest.fixture(scope="module")
def train_split(runs):
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["preprocess", runs[EXPTS[0]][0], "-o",
                     runs[EXPTS[0]][1], "-s", "train"]) == 0


@pytest.mark.parametrize("path", EXPTS)
def test_train_runs_the_modern_family(runs, train_split, path, capsys):
    yaml, over, exp = runs[path]
    run = exp.trainer.serialization_dir + "-train"
    over = json.loads(over)
    over["model"].update(dropout=0.1, attention_dropout=0.1)
    over["trainer"].update(serialization_dir=run, num_epochs=2)
    over = json.dumps(over)
    assert main(["train", yaml, "-o", over, "--device", "cpu"]) == 0
    assert _last_json(capsys)["epochs"] == 2
    with open(os.path.join(run, "metrics.jsonl")) as f:
        hist = [json.loads(line) for line in f]
    assert len(hist) == 2 and all(h["batches"] == 3 and h["skipped"] == 0
                                  and np.isfinite(h["val_loss"])
                                  for h in hist)
    assert main(["evaluate", yaml, "-o", over, "-s", "valid",
                 "--device", "cpu"]) == 0
    assert _last_json(capsys)["n_samples"] == 10


def test_a_converted_vit_tower_is_loaded(runs, tmp_path):
    """towers/vit/state.pt (convert_towers --vit's output) is loaded onto
    the device with ViT-L's config, as tell_tpu's _frozen_towers does."""
    import dataclasses

    from tell_tpu_torch.bridge import init_vit
    from tell_tpu_torch.commands.__main__ import _frozen_towers
    from tell_tpu_torch.models.backbones.vit import ViTConfig
    _, _, exp = runs[EXPTS[0]]
    exp = dataclasses.replace(exp, data=dataclasses.replace(
        exp.data, shards_dir=str(tmp_path / "shards")))
    tree = init_vit(torch.Generator().manual_seed(4),
                    ViTConfig(dim=16, num_layers=1, ffn_dim=32))
    os.makedirs(tmp_path / "towers" / "vit")
    torch.save(tree, tmp_path / "towers" / "vit" / "state.pt")
    frozen = _frozen_towers(exp, torch.device("cpu"))
    assert frozen["vit_cfg"] == ViTConfig.large()
    assert torch.equal(frozen["vit"]["pos_embed"], tree["pos_embed"])
