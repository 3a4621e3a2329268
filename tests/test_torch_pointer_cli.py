"""The pointer family (expts a1-a3) through `python -m
tell_tpu_torch.commands` on the CPU.

The six pointer YAMLs (NYTimes and GoodNews a1_pointer, a2_copy_fix,
a3_pointer_2) load into configs equal to tell_tpu.config_io's, and their
adapters carry tell_tpu's fields (a PointerConfig of the same fields, an
e2e loss, no beam) with the port's no-engine and no-maps flags. Then
nytimes/a1_pointer.yaml and a3_pointer_2.yaml shrunk by an override (E=32,
vocab 300 in bands 50/200/300, kernel sizes 3 and 5, gen_len 6; image
4 x 16 grids from <hash>.npy files, the article 128 wide from the tiny
RoBERTa's 3 hidden layers (weigh_bert), faces 4 x 512), compute_dtype
bfloat16 as the YAMLs have it: `preprocess` writes the copy masks from
the articles' named entities (reader.emit_copy_masks); a seeded faces
captioner's checkpoint is the warm start of `train` (two epochs of a1,
one of a3), whose Trainer holds it in params["captioner"] bit for bit
before its first step while the heads keep their init (a pointer's own
checkpoint, which is not a captioner's tree, and an orbax directory are
refused); `evaluate` decodes greedily, with the shards' proper masks,
and refuses --beam 5 as tell_tpu's assert does; `serve --attention`
answers requests with string and NER-dict entities without maps (the
pointer decode records none, as in tell_tpu), a request whose entity has
no text fails alone, and `serve --engine-slots` is refused with
tell_tpu's error.
"""
import contextlib
import dataclasses
import glob
import io
import json
import os

import numpy as np
import pytest
import torch

from tell_tpu.config_io import load_experiment as j_load
from tell_tpu.models.registry import get_model as j_get_model
from tell_tpu_torch.bridge import init_captioner, tree_leaves
from tell_tpu_torch.commands.__main__ import build_trainer, main
from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.config_io import load_experiment
from tell_tpu_torch.data.records import RecordDataset
from tell_tpu_torch.models import pointer as PM
from tell_tpu_torch.models.registry import get_model
from tests.test_e2e_cli import _articles
from tests.test_tokenizer import build_synthetic_vocab
from tests.test_torch_cli import _last_json, _start_serve
from tests.test_torch_config_io import _assert_configs_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTER_YAMLS = sorted(
    os.path.relpath(p, ROOT) for pat in ("a1_*", "a2_*", "a3_*")
    for p in glob.glob(os.path.join(ROOT, "expt", "*", pat + ".yaml")))
EXPTS = {"a1": "expt/nytimes/a1_pointer.yaml",
         "a3": "expt/nytimes/a3_pointer_2.yaml"}


def _override(root, vf, mf, expt, **trainer) -> str:
    dec = {"embed_dim": 32, "conv_dim": 32, "ffn_dim": 64, "num_heads": 4,
           "kernel_sizes": [3, 5], "vocab_size": 300,
           "adaptive_cutoffs": [50, 200], "max_target_positions": 64,
           "contexts": [{"name": "image", "kv_dim": 16, "max_len": 4},
                        {"name": "article", "kv_dim": 1024, "max_len": 128},
                        {"name": "faces", "kv_dim": 512, "max_len": 4}]}
    data = {"shards_dir": os.path.join(root, "shards"),
            "articles_jsonl": os.path.join(root, "articles.jsonl"),
            "images_dir": os.path.join(root, "grids"),
            "vocab_file": vf, "merges_file": mf,
            "instances_per_epoch": None, "val_limit": 4, "roberta": "tiny"}
    return json.dumps({
        "model": {"gen_len": 6, "num_bert_layers": 3, "decoder": dec},
        "reader": {"use_objects": False, "token_budget": 40},
        "trainer": {"serialization_dir": os.path.join(root, f"run_{expt}"),
                    "num_epochs": 2, **trainer},
        "data": data,
        "bucketing": {"article_lengths": [128], "caption_lengths": [16],
                      "max_batch": 4, "max_faces": 4}})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The corpus and its grids preprocessed (train, valid); a seeded
    faces captioner saved as a checkpoint; a1 trained two epochs and a3
    one, each warm-started from it. {expt: (yaml, override, train's JSON
    line)} and the checkpoint's directory."""
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("pointer_cli")
    root = str(tmp)
    vf, mf = build_synthetic_vocab(tmp)
    _articles(os.path.join(root, "articles.jsonl"))
    os.makedirs(os.path.join(root, "grids"))
    rng = np.random.default_rng(0)
    for i in range(10):
        np.save(os.path.join(root, "grids", f"h{i}.npy"),
                rng.normal(size=(4, 16)).astype(np.float32))
    ckpt = os.path.join(root, "captioner")
    os.makedirs(ckpt)
    out = {"captioner": ckpt}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for expt, epochs in (("a1", 2), ("a3", 1)):
            yaml = os.path.join(ROOT, EXPTS[expt])
            over = _override(root, vf, mf, expt, num_epochs=epochs,
                             warm_start=ckpt)
            if expt == "a1":
                for split in ("train", "valid"):
                    assert main(["preprocess", yaml, "-o", over, "-s",
                                 split]) == 0
                cap_cfg = load_experiment(yaml, over).model
                torch.save({"params": init_captioner(
                    torch.Generator().manual_seed(3), cap_cfg)},
                    os.path.join(ckpt, "state.pt"))
            assert main(["train", yaml, "-o", over, "--device", "cpu"]) == 0
            out[expt] = (yaml, over, json.loads(buf.getvalue().splitlines()
                                                [-1]))
    return out


@pytest.mark.parametrize("path", POINTER_YAMLS)
def test_pointer_yamls_and_adapters_equal_jax(path):
    full = os.path.join(ROOT, path)
    exp, jexp = load_experiment(full), j_load(full)
    _assert_configs_equal(exp, jexp)
    assert exp.reader.emit_copy_masks and exp.model.weigh_bert
    ad, jad = (get_model(exp.model_type, exp.model),
               j_get_model(jexp.model_type, jexp.model))
    assert ad.name == jad.name == {"a1": "pointer_v1", "a2": "pointer_v2",
                                   "a3": "pointer_v2"}[
        os.path.basename(path)[:2]]
    assert (dataclasses.asdict(ad.config)
            == dataclasses.asdict(jad.config))
    assert ad.beam is None and jad.beam is None
    assert ad.loss_e2e is not None and ad.encode is not None
    assert (ad.engine, ad.attention_maps, ad.kv_cache_levers,
            ad.fused_topk, ad.copy_masks) == (False, False, True, True, True)


@pytest.mark.parametrize("expt", ["a1", "a3"])
def test_train_then_evaluate_greedily(trained, expt, capsys, monkeypatch):
    yaml, over, result = trained[expt]
    epochs = json.loads(over)["trainer"]["num_epochs"]
    assert result["epochs"] == epochs
    run = json.loads(over)["trainer"]["serialization_dir"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        hist = [json.loads(line) for line in f]
    assert len(hist) == epochs and all(
        h["batches"] == 3 and h["skipped"] == 0 and np.isfinite(h["loss"])
        and np.isfinite(h["val_loss"]) for h in hist)
    # the shards carry the copy masks, and the captions hold entities
    examples = list(RecordDataset(os.path.join(
        json.loads(over)["data"]["shards_dir"], "train-*.npz")).epoch())
    assert all(len(e["proper_masks"]) == len(e["context_ids"])
               for e in examples)
    assert any((e["caption_copy_masks"] >= 1).any() for e in examples)
    # evaluate's batches carry the shards' proper masks to the decode
    seen = []
    inner = PM.pointer_generate

    def recorded(params, cfg, batch, **kw):
        seen.append(batch["proper_masks"])
        return inner(params, cfg, batch, **kw)

    monkeypatch.setattr(PM, "pointer_generate", recorded)
    assert main(["evaluate", yaml, "-o", over, "-s", "valid",
                 "--device", "cpu"]) == 0
    assert _last_json(capsys)["n_samples"] == 10
    assert seen and any((m >= 1).any() for m in seen)
    with open(os.path.join(run, "generations-valid.jsonl")) as f:
        assert len(f.readlines()) == 10
    with pytest.raises(ValueError, match="decodes with --beam 1"):
        main(["evaluate", yaml, "-o", over, "-s", "valid", "--device",
              "cpu", "-b", "5"])


def test_warm_start_takes_the_captioner_and_keeps_the_heads(trained,
                                                            tmp_path):
    yaml, over, _ = trained["a1"]
    warm = build_trainer(load_experiment(yaml, over), "cpu")
    warm.initialize()
    cold = build_trainer(load_experiment(yaml, json.dumps(
        {**json.loads(over), "trainer": {"warm_start": ""}})), "cpu")
    cold.initialize()
    saved = torch.load(os.path.join(trained["captioner"], "state.pt"),
                       weights_only=True)["params"]
    got = warm.state["params"]
    pairs = list(zip(tree_leaves(got["captioner"]), tree_leaves(saved)))
    assert len(pairs) == len(tree_leaves(saved))
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(cold.state["params"]["captioner"]), tree_leaves(saved)))
    for head in ("entity_attn", "entity_fc", "copy_attn", "bert_weight_2"):
        for a, b in zip(tree_leaves(got[head]),
                        tree_leaves(cold.state["params"][head])):
            assert torch.equal(a, b), head
    # a pointer's own checkpoint is not a captioner's tree; an orbax
    # directory is refused naming the converter
    best = os.path.join(json.loads(over)["trainer"]["serialization_dir"],
                        "checkpoints", "best")
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    for bad, err, match in ((best, ValueError, "captioner's tree"),
                            (str(orbax), NotPortedError, "orbax_to_torch")):
        t = build_trainer(load_experiment(yaml, json.dumps(
            {**json.loads(over), "trainer": {"warm_start": bad}})), "cpu")
        with pytest.raises(err, match=match):
            t.initialize()


def test_serve_answers_entities_without_maps_and_refuses_the_engine(
        trained):
    yaml, over, _ = trained["a1"]
    call, server, rc = _start_serve(yaml, ["-o", over, "--attention"])
    text = "Anna Smith went to Milan on day 3. Anna Smith stayed."
    try:
        for ents in (["Anna Smith", "Milan"],
                     [{"text": "Anna Smith", "label": "PERSON"}], None):
            req = {"context": text}
            if ents is not None:
                req["entities"] = ents
            status, body = call("POST", "/caption", req)
            assert status == 200 and "error" not in body, body
            ids = np.asarray(body["token_ids"])
            assert ids.shape == (7,) and ids[0] == 0 and ids.max() < 300
            assert "attns" not in body and isinstance(body["caption"], str)
        status, body = call("POST", "/caption",
                            {"context": text,
                             "entities": [{"label": "PERSON"}]})
        assert status == 200 and body["error"].startswith("bad context")
    finally:
        call("POST", "/shutdown")
        server.join(timeout=60)
    assert rc == [0]
    with pytest.raises(ValueError, match="captioner and modern families "
                       "only"):
        main(["serve", yaml, "-o", over, "--device", "cpu",
              "--engine-slots", "2"])
