"""`python -m tell_tpu_torch.commands` end to end on the CPU, on
tests/test_e2e_cli.py's synthetic corpus and small config: preprocess,
train (2 epochs, the loss falls, checkpoints/best is written), evaluate
(10 samples scored, tell_tpu's generation fields) and score; `train -r`
with nothing to recover fails; a model command without a card and without
`--device cpu` raises; what the port does not run yet is refused with its
ROADMAP item. (evaluate_split against tell_tpu's on bridged weights is
tests/test_torch_evaluate.py.)
"""
import contextlib
import http.client
import io
import json
import os
import socket
import threading
import time

import pytest
import torch

from tell_tpu_torch.commands.__main__ import main
from tell_tpu_torch.config import NotPortedError
from tests.test_e2e_cli import _articles
from tests.test_tokenizer import build_synthetic_vocab

E2E_YAML = """
name: e2e
model_type: transformer_faces
model:
  weigh_bert: false
  gen_len: 6
  decoder:
    vocab_size: 300
    embed_dim: 64
    conv_dim: 64
    ffn_dim: 128
    num_heads: 4
    kernel_sizes: [3, 5]
    adaptive_cutoffs: [50, 200]
    dropout: 0.0
    weight_dropout: 0.0
    input_dropout: 0.0
    attention_dropout: 0.0
    max_target_positions: 128
    tail_capacity_frac: null
    contexts:
      - {{name: article, kv_dim: 1024, max_len: 128}}
      - {{name: faces, kv_dim: 512, max_len: 4}}
reader:
  strategy: location_aware
  use_faces: true
  use_objects: false
  token_budget: 40
trainer:
  serialization_dir: {root}/run
  num_epochs: 2
  t_total: 100
  warmup: 0.0
  log_every: 100
  n_data: 1

bucketing:
  article_lengths: [128]
  caption_lengths: [16]
  max_batch: 4
data:
  shards_dir: {root}/shards
  articles_jsonl: {root}/articles.jsonl
  vocab_file: {vf}
  merges_file: {mf}
  instances_per_epoch: null
  val_limit: 4
  roberta: tiny
"""


def write_e2e_config(root) -> str:
    """tests/test_e2e_cli.py's corpus and config under `root`."""
    vf, mf = build_synthetic_vocab(root)
    _articles(root / "articles.jsonl")
    path = root / "cfg.yaml"
    path.write_text(E2E_YAML.format(root=root, vf=vf, mf=mf))
    return str(path)


@pytest.fixture(scope="module")
def exp_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_e2e")
    return write_e2e_config(root), str(root)


@pytest.fixture(scope="module")
def trained(exp_yaml):
    """preprocess (train, valid) and 2 epochs of train on the CPU; returns
    the config, the root and the three commands' JSON lines."""
    torch.set_num_threads(2)
    cfg, root = exp_yaml
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["preprocess", cfg, "-s", "train"]) == 0
        assert main(["preprocess", cfg, "-s", "valid"]) == 0
        assert main(["train", cfg, "--device", "cpu", "--report-launches",
                     os.path.join(root, "launches.json")]) == 0
    outs = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    return cfg, root, outs


def _last_json(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def test_preprocess_train_evaluate_score_on_cpu(trained, capsys):
    cfg, root, outs = trained
    assert outs[:2] == [{"examples": 10, "split": "train"},
                        {"examples": 10, "split": "valid"}]
    assert outs[2]["epochs"] == 2
    assert os.path.isdir(os.path.join(root, "run", "checkpoints", "best"))
    with open(os.path.join(root, "run", "metrics.jsonl")) as f:
        hist = [json.loads(line) for line in f]
    assert hist[-1]["loss"] < hist[0]["loss"]
    # the CPU takes every kernel's plain version
    with open(os.path.join(root, "launches.json")) as f:
        assert set(json.load(f).values()) == {0}

    assert main(["evaluate", cfg, "-s", "valid", "--device", "cpu"]) == 0
    metrics = _last_json(capsys)
    assert metrics["n_samples"] == 10
    assert metrics["kv_cache_mode"] == "fp"
    assert metrics["topk_mode"] == "exact"
    assert metrics["captions_per_sec_steady"] > 0
    gen_path = os.path.join(root, "run", "generations-valid.jsonl")
    with open(gen_path) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 10
    assert set(rows[0]) == {"caption", "generation", "image_hash", "web_url",
                            "caption_readability", "gen_readability",
                            "caption_np", "gen_np"}
    assert rows[0]["caption"].startswith("Anna Smith in Milan")

    assert main(["evaluate", cfg, "-s", "valid", "--device", "cpu", "-b",
                 "2", "--kv-cache", "int8", "--fused-topk"]) == 0
    lever = _last_json(capsys)
    assert (lever["kv_cache_mode"], lever["topk_mode"]) == ("int8", "fused")
    assert lever["n_samples"] == 10

    assert main(["score", gen_path]) == 0
    scored = _last_json(capsys)
    assert scored == {k: metrics[k] for k in scored}


def _start_serve(cfg, extra):
    """`serve` in a thread on a free port: (call(method, path, payload),
    the thread, its return codes)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rc = []
    server = threading.Thread(target=lambda: rc.append(main(
        ["serve", cfg, "--device", "cpu", "-p", str(port), "-b", "2"]
        + extra)), daemon=True)
    server.start()

    def call(method, path, payload=None):
        for _ in range(300):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=60)
                conn.request(method, path, json.dumps(payload or {}),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            except ConnectionRefusedError:
                time.sleep(0.1)
        raise TimeoutError(path)

    return call, server, rc


def test_serve_answers_text_and_shuts_down(trained):
    """`serve` on the trained checkpoint: a text request through the
    port's tokenizer, /status, then /shutdown ends main()."""
    call, server, rc = _start_serve(trained[0], ["--warmup"])
    status, body = call("POST", "/caption",
                        {"context": "Anna Smith went to Milan on day 3."})
    assert status == 200 and "error" not in body
    assert body["token_ids"][0] == 0 and isinstance(body["caption"], str)
    status, info = call("GET", "/status")
    assert status == 200 and info["config"]["kv_cache_mode"] == "fp"
    assert call("POST", "/shutdown")[0] == 200
    server.join(timeout=60)
    assert not server.is_alive() and rc == [0]


def test_serve_attention_answers_with_maps(trained):
    """`serve --attention`: a scraped-article request (sections around an
    image) comes back with per-step maps of every context, each summing
    to 1, and their word merge; /status reports need_attention."""
    call, server, rc = _start_serve(trained[0], ["--attention"])
    status, body = call("POST", "/caption", {
        "title": "Anna Smith in Milan",
        "sections": [{"type": "paragraph", "text": "Anna Smith went to "
                      "Milan on day 3."},
                     {"type": "caption", "text": "a photo"},
                     {"type": "paragraph", "text": "She met Bob Jones."}],
        "image_position": 1})
    assert status == 200 and "error" not in body
    assert set(body["attns"]) == {"article", "faces"}
    for name, maps in body["attns"].items():
        assert len(maps) == 6                       # gen_len steps
        for row in maps:
            assert abs(sum(row) - 1.0) < 1e-4, name
    assert len(body["word_attns"]) == len(body["caption_words"])
    assert "\n" in body["article_words"]
    for row in body["word_attns"]:
        assert len(row["article"]) == len(body["article_words"])
    status, info = call("GET", "/status")
    assert status == 200 and info["config"]["need_attention"] is True
    assert call("POST", "/shutdown")[0] == 200
    server.join(timeout=60)
    assert not server.is_alive() and rc == [0]


@pytest.mark.parametrize("decoder", [
    {"positional": "learned"},
    {"conv_type": "lightweight", "normalize_before": True,
     "final_norm": True}], ids=["learned", "lightweight_final_norm"])
def test_train_and_evaluate_decoder_options(trained, tmp_path, capsys,
                                            decoder):
    """expt 13's learned positions (and the lightweight conv with the
    final norm) train and evaluate through the CLI on the trained
    fixture's shards: the checkpoint holds the position table or the
    final LayerNorm that the option adds."""
    import json as _json
    cfg, root, _ = trained
    over = _json.dumps({"model": {"decoder": decoder},
                        "trainer": {"serialization_dir": str(tmp_path)}})
    assert main(["train", cfg, "-o", over, "--device", "cpu"]) == 0
    assert _last_json(capsys)["epochs"] == 2
    state = torch.load(tmp_path / "checkpoints" / "best" / "state.pt",
                       weights_only=True)
    dec = state["params"]["decoder"]
    assert ("pos_embed" in dec) == (decoder.get("positional") == "learned")
    assert ("final_ln" in dec) == ("final_norm" in decoder)
    assert main(["evaluate", cfg, "-o", over, "-s", "valid", "-b", "2",
                 "--device", "cpu"]) == 0
    assert _last_json(capsys)["n_samples"] == 10


def test_train_recover_without_checkpoint_fails(tmp_path, capsys):
    cfg = write_e2e_config(tmp_path)
    assert main(["preprocess", cfg, "-s", "train"]) == 0
    assert main(["preprocess", cfg, "-s", "valid"]) == 0
    assert main(["train", cfg, "-r", "--device", "cpu"]) == 1
    assert "no checkpoint to recover" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there")
@pytest.mark.parametrize("cmd", ["train", "evaluate"])
def test_model_commands_need_the_card_or_device_cpu(tmp_path, cmd):
    cfg = write_e2e_config(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([cmd, cfg])


@pytest.mark.parametrize("argv, item", [
    (["bench"], "queue 1 item 1"),
    (["serve", "{cfg}", "-o", '{{"trainer": {{"n_model": 2}}}}',
      "--device", "cpu"], "queue 1 item 10"),
    (["train", "{cfg}", "--coordinator", "h:1", "--device", "cpu"],
     "queue 1 item 10"),
    (["serve", "{cfg}", "--mesh-data", "2", "--device", "cpu"],
     "queue 1 item 10"),
    (["train", "expt/nytimes/a1_pointer.yaml", "--device", "cpu"],
     "queue 1 item 9"),
    (["train", "{cfg}", "-o", '{{"trainer": {{"n_data": 2}}}}', "--device",
      "cpu"], "queue 1 item 10"),
])
def test_what_is_not_ported_is_refused_with_its_item(tmp_path, argv, item):
    cfg = write_e2e_config(tmp_path)
    argv = [a.format(cfg=cfg) for a in argv]
    with pytest.raises(NotPortedError, match=item):
        main(argv)


def test_orbax_roberta_tower_is_refused(tmp_path):
    from tell_tpu_torch.commands import __main__ as cli
    from tell_tpu_torch.config_io import load_experiment
    cfg = write_e2e_config(tmp_path)
    orbax = tmp_path / "towers" / "roberta"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(NotPortedError, match="orbax_to_torch.py towers"):
        cli._frozen_towers(load_experiment(cfg), "cpu")


def test_saved_roberta_tower_is_read(tmp_path):
    """A towers/roberta/state.pt is the tower train and evaluate use."""
    from tell_tpu_torch.bridge import init_roberta
    from tell_tpu_torch.commands import __main__ as cli
    from tell_tpu_torch.config_io import load_experiment
    from tell_tpu_torch.models.backbones.roberta import RobertaConfig
    cfg = write_e2e_config(tmp_path)
    exp = load_experiment(cfg)
    tree = init_roberta(torch.Generator().manual_seed(5),
                        RobertaConfig.tiny())
    (tmp_path / "towers" / "roberta").mkdir(parents=True)
    torch.save(tree, tmp_path / "towers" / "roberta" / "state.pt")
    got = cli._frozen_towers(exp, "cpu")["roberta"]
    assert torch.equal(got["word_embed"], tree["word_embed"])
    assert torch.equal(got["layers"][1]["fc2"]["w"],
                       tree["layers"][1]["fc2"]["w"])


def test_convert_resnet_then_preprocess_embeds_a_photo(tmp_path,
                                                       monkeypatch):
    """convert_towers --resnet on a seeded torchvision-named state dict,
    then preprocess over an images_dir with one .jpg: the shard's
    image_grid is the photo's grid through the converted tower, in fp16.
    ResNetConfig.resnet152 is shrunk to blocks (1, 1, 1, 1), width 8."""
    from tell_tpu_torch.bridge import to_torch
    from tell_tpu_torch.data.images import resize_shortest_crop
    from tell_tpu_torch.data.jpeg import decode_jpeg
    from tell_tpu_torch.data.records import ShardReader
    from tell_tpu_torch.models.backbones import resnet as tr
    from tell_tpu_torch.tools import convert_towers
    from tests.test_torch_resnet import torchvision_state_dict
    tiny = tr.ResNetConfig((1, 1, 1, 1), 8)
    monkeypatch.setattr(tr.ResNetConfig, "resnet152",
                        staticmethod(lambda: tiny))
    cfg = write_e2e_config(tmp_path)
    sd = {k: torch.from_numpy(v)
          for k, v in torchvision_state_dict(tiny, seed=4).items()}
    torch.save(sd, tmp_path / "resnet152.pth")
    towers = tmp_path / "towers"
    assert convert_towers.main(["--out", str(towers), "--resnet",
                                str(tmp_path / "resnet152.pth")]) == 0
    photo = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fixtures", "images", "news_a_320x240_420.jpg")
    (tmp_path / "imgs").mkdir()
    with open(photo, "rb") as f:
        data = f.read()
    (tmp_path / "imgs" / "h0.jpg").write_bytes(data)
    over = json.dumps({"data": {"images_dir": str(tmp_path / "imgs")}})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["preprocess", cfg, "-o", over, "-s", "train",
                     "--device", "cpu"]) == 0
    assert json.loads(buf.getvalue()) == {"examples": 1, "split": "train"}
    reader = ShardReader(str(tmp_path / "shards" / "train-00000.npz"))
    assert len(reader) == 1
    got = reader[0]["image_grid"]
    tree = to_torch(tr.convert_torchvision_resnet(sd, tiny), "cpu")
    want = tr.image_grid(tr.prepare_resnet(tree), tiny, resize_shortest_crop(
        decode_jpeg(data)).astype("float32"))
    assert got.dtype == "float16" and got.shape == (49, 256)
    assert (got == want.astype("float16")).all()
    # the tower goes to the card unless asked otherwise, and there is none
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["preprocess", cfg, "-o", over, "-s", "train"])


def test_resnet_tower_is_read_and_an_orbax_one_refused(tmp_path):
    """towers/resnet152/state.pt is loaded as frozen["resnet"], in the
    forward's layout, with ResNetConfig.resnet152(); a towers/resnet152
    without one (tell_tpu's orbax tree) is refused naming
    migrate/orbax_to_torch.py, as RoBERTa's is."""
    from tell_tpu_torch.bridge import init_resnet
    from tell_tpu_torch.commands import __main__ as cli
    from tell_tpu_torch.config_io import load_experiment
    from tell_tpu_torch.models.backbones.resnet import (ResNetConfig,
                                                        prepare_resnet)
    exp = load_experiment(write_e2e_config(tmp_path))
    assert "resnet" not in cli._frozen_towers(exp, "cpu")
    (tmp_path / "towers" / "resnet152").mkdir(parents=True)
    with pytest.raises(NotPortedError, match="orbax_to_torch.py towers"):
        cli._frozen_towers(exp, "cpu")
    tree = init_resnet(torch.Generator().manual_seed(1),
                       ResNetConfig((1, 1, 1, 1), 8))
    torch.save(tree, tmp_path / "towers" / "resnet152" / "state.pt")
    frozen = cli._frozen_towers(exp, "cpu")
    assert frozen["resnet_cfg"] == ResNetConfig.resnet152()
    assert torch.equal(frozen["resnet"]["stages"][3][0]["conv2"],
                       prepare_resnet(tree)["stages"][3][0]["conv2"])
