"""Expts 1-3 (the LSTM and GloVe models) through `python -m
tell_tpu_torch.commands` on the CPU: nytimes/1_lstm_glove.yaml
(baseline_glove), 2_transformer_glove.yaml (the captioner over GloVe)
and 3_lstm_roberta.yaml (lstm_decoder_flattened), shrunk by an override
(E=32, vocab 300 in bands 50/200/300, gen_len 6, the conv decoder of
expt 2 at kernel sizes 3 and 5; image 4 x 16 grids from <hash>.npy files,
the article 128 wide: 1024-d from the tiny RoBERTa for expt 3, 300-d
GloVe features for 1 and 2), compute_dtype bfloat16 as the YAMLs have
it.

`preprocess` with data.glove_file writes the GloVe features into the
shards (tests/test_torch_glove.py holds them to tell_tpu's); `train` runs
two epochs of each expt from the train split and validates; `evaluate`
decodes the valid split greedily (expt 3 also with --fused-topk, kernel
E's plain version here: the same captions) and refuses --beam 5 on the
LSTM as tell_tpu's assert does; `serve` answers /caption in micro-batch
mode for expt 3, refuses --engine-slots on the LSTM with tell_tpu's
error, and fails each request of a GloVe model (tell_tpu's service has
no GloVe encode either).
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from tell_tpu_torch.commands.__main__ import main
from tests.test_e2e_cli import _articles
from tests.test_tokenizer import build_synthetic_vocab
from tests.test_torch_cli import _last_json, _start_serve
from tests.test_torch_glove import write_glove

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPTS = {1: "expt/nytimes/1_lstm_glove.yaml",
         2: "expt/nytimes/2_transformer_glove.yaml",
         3: "expt/nytimes/3_lstm_roberta.yaml"}


def _override(root, vf, mf, expt: int) -> str:
    glove = expt in (1, 2)
    dec = {"embed_dim": 32, "vocab_size": 300, "adaptive_cutoffs": [50, 200],
           "max_target_positions": 64,
           "contexts": [{"name": "image", "kv_dim": 16, "max_len": 4},
                        {"name": "article", "kv_dim": 300 if glove else 1024,
                         "max_len": 128}]}
    if expt == 2:
        dec.update(conv_dim=32, ffn_dim=64, num_heads=4, kernel_sizes=[3, 5])
    data = {"shards_dir": os.path.join(root, "shards_glove" if glove
                                       else "shards"),
            "articles_jsonl": os.path.join(root, "articles.jsonl"),
            "images_dir": os.path.join(root, "grids"),
            "vocab_file": vf, "merges_file": mf,
            "instances_per_epoch": None, "val_limit": 4, "roberta": "tiny"}
    if glove:
        data["glove_file"] = os.path.join(root, "glove.txt")
    return json.dumps({
        "model": {"gen_len": 6, "decoder": dec},
        "reader": {"use_objects": False, "token_budget": 40},
        "trainer": {"serialization_dir": os.path.join(root, f"run{expt}"),
                    "num_epochs": 2},
        "data": data,
        "bucketing": {"article_lengths": [128], "caption_lengths": [16],
                      "max_batch": 4}})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The corpus, its grids and a GloVe file; each shard set preprocessed
    (train, valid) and each expt trained; {expt: (yaml, override, train's
    JSON line)}."""
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("lstm_cli")
    root = str(tmp)
    vf, mf = build_synthetic_vocab(tmp)
    _articles(os.path.join(root, "articles.jsonl"))
    write_glove(os.path.join(root, "glove.txt"), seed=3)
    os.makedirs(os.path.join(root, "grids"))
    rng = np.random.default_rng(0)
    for i in range(10):
        np.save(os.path.join(root, "grids", f"h{i}.npy"),
                rng.normal(size=(4, 16)).astype(np.float32))
    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for expt, path in EXPTS.items():
            yaml = os.path.join(ROOT, path)
            over = _override(root, vf, mf, expt)
            if expt in (1, 3):            # one shard set each
                for split in ("train", "valid"):
                    assert main(["preprocess", yaml, "-o", over, "-s",
                                 split]) == 0
            assert main(["train", yaml, "-o", over, "--device", "cpu"]) == 0
            out[expt] = (yaml, over, json.loads(buf.getvalue().splitlines()
                                                [-1]))
    return out


@pytest.mark.parametrize("expt", [1, 2, 3])
def test_train_then_evaluate_greedily(trained, expt, capsys):
    yaml, over, result = trained[expt]
    assert result["epochs"] == 2
    run = json.loads(over)["trainer"]["serialization_dir"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        hist = [json.loads(line) for line in f]
    assert len(hist) == 2 and all(h["batches"] == 3 and h["skipped"] == 0
                                  and np.isfinite(h["loss"])
                                  and np.isfinite(h["val_loss"])
                                  for h in hist)
    assert os.path.isdir(os.path.join(run, "checkpoints", "best"))
    assert main(["evaluate", yaml, "-o", over, "-s", "valid",
                 "--device", "cpu"]) == 0
    assert _last_json(capsys)["n_samples"] == 10
    gen_path = os.path.join(run, "generations-valid.jsonl")
    with open(gen_path) as f:
        exact = [json.loads(line)["generation"] for line in f]
    if expt == 3:
        assert main(["evaluate", yaml, "-o", over, "-s", "valid",
                     "--device", "cpu", "--fused-topk"]) == 0
        assert _last_json(capsys)["topk_mode"] == "fused"
        with open(gen_path) as f:
            assert [json.loads(line)["generation"] for line in f] == exact
    if expt != 2:
        with pytest.raises(ValueError, match="decodes with --beam 1"):
            main(["evaluate", yaml, "-o", over, "-s", "valid", "--device",
                  "cpu", "-b", "5"])


def test_serve_answers_the_lstm_in_micro_batch_mode(trained):
    yaml, over, _ = trained[3]
    call, server, rc = _start_serve(yaml, ["-o", over])
    try:
        status, body = call("POST", "/caption",
                            {"context": "Anna Smith went to Milan"})
        assert status == 200 and "error" not in body, body
        ids = np.asarray(body["token_ids"])
        assert ids.shape == (7,) and ids[0] == 0 and ids.max() < 300
    finally:
        call("POST", "/shutdown")
        server.join(timeout=60)
    assert rc == [0]
    with pytest.raises(ValueError, match="captioner and modern families "
                       "only"):
        main(["serve", yaml, "-o", over, "--device", "cpu",
              "--engine-slots", "2"])


@pytest.mark.parametrize("expt", [1, 2])
def test_a_glove_model_fails_each_request_as_tell_tpu(trained, expt):
    yaml, over, _ = trained[expt]
    call, server, rc = _start_serve(yaml, ["-o", over])
    try:
        status, body = call("POST", "/caption",
                            {"context": "Anna Smith went to Milan"})
        assert status == 500 and "300-d" in body["error"], body
    finally:
        call("POST", "/shutdown")
        server.join(timeout=60)
    assert rc == [0]
