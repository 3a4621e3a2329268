"""tell_tpu_torch never imports JAX, `regex`, PyYAML, bs4, tensorboard,
orbax or Pillow.

A fresh interpreter with those blocked (sys.modules["jax"] = None makes
any `import jax` raise; none of the others is a dependency of the port,
and the card's machine has none of bs4, tensorboard and orbax) imports
every tell_tpu_torch module, checks that no tell_tpu module was loaded
(the port keeps its own config dataclasses, tokenizer, YAML reader,
TensorBoard writer, HTML parser and JPEG decoder), loads an expt/ YAML,
round-trips text through the tokenizer (the C++ BPE), parses an article
page, writes and reads back a TensorBoard scalar, decodes and crops a JPEG
and embeds it with a tiny ResNet, decodes a progressive JPEG and a PNG
(Adam7) through decode_image with Pillow blocked, runs the photo through the vision
pipeline with tiny MTCNN, FaceNet and YOLOv3 towers (the letterbox, the
faces and the objects with Pillow blocked), then runs the slices on CPU
tensors at a tiny size (greedy
generate, a train step, the continuous-batching engine with the int8 K/V
cache and the fused top-k, and kernel F's two forms) and checks that the
plain paths ran: the kernels' launch counters stay 0.
"""
import json
import os
import subprocess
import sys

_SCRIPT = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
BLOCKED = ("regex", "yaml", "bs4", "tensorboard", "orbax", "PIL")
for name in BLOCKED:
    sys.modules[name] = None
import tell_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    tell_tpu_torch.__path__, "tell_tpu_torch."))
for name in names:
    importlib.import_module(name)
jax_pkg = sorted(m for m in sys.modules
                 if m == "tell_tpu" or m.startswith("tell_tpu."))

import dataclasses
import torch
torch.set_num_threads(1)
from tell_tpu_torch.bridge import init_captioner, init_roberta
from tell_tpu_torch.config import small_test_config
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder)
from tell_tpu_torch.models.captioner import Captioner, encode_contexts
from tell_tpu_torch.models.decoder import quantize_kv4
from tell_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, decode_attention_q4split, decode_attention_q8,
    decode_attention_single)
from tell_tpu_torch.ops.kernels.dynamic_conv import fused_dynamic_conv
from tell_tpu_torch.ops.kernels.encoder_attention import encoder_attention
from tell_tpu_torch.ops.kernels.topk_logits import topk_logits
from tell_tpu_torch.serving.engine import DecodeEngine
from tell_tpu_torch.training.optimizer import bert_adam
from tell_tpu_torch.training.train_step import make_train_step
cfg = small_test_config(gen_len=3)
dec = dataclasses.replace(cfg.decoder, contexts=tuple(
    dataclasses.replace(c, kv_dim=32) if c.name == "article" else c
    for c in cfg.decoder.contexts))
cfg = dataclasses.replace(cfg, decoder=dec)
rcfg = RobertaConfig(vocab_size=500, dim=32, num_layers=2, num_heads=2,
                     ffn_dim=64, max_positions=20)
g = torch.Generator().manual_seed(0)
cap = Captioner(init_captioner(g, cfg), cfg)
enc = RobertaEncoder(init_roberta(g, rcfg), rcfg)
batch = {"context_ids": torch.randint(3, 500, (2, 16), generator=g),
         "image_grid": torch.randn(2, 9, 32, generator=g),
         "face_embeds": torch.randn(2, 4, 16, generator=g),
         "obj_embeds": torch.randn(2, 8, 32, generator=g)}
with torch.inference_mode():
    out = cap.generate(encode_contexts(enc.frozen(), cfg, batch))
opt = bert_adam(t_total=10)
params = init_captioner(g, cfg)
batch["caption_ids"] = torch.randint(3, 500, (2, 6), generator=g)
_, _, m = make_train_step(cfg, opt)(params, opt.init(params), batch, g,
                                    enc.frozen())
eng = DecodeEngine(cap.tree(), cfg, "cpu", slots=2, beam=2, chunk_steps=2,
                   kv_cache="int8", fused_topk=True)
with torch.inference_mode():
    enc1 = encode_contexts(enc.frozen(), cfg,
                           {k: v[:1] for k, v in batch.items()
                            if k != "caption_ids"})
fut = eng.submit({k: v for k, v in enc1.items() if k != "context_ids"})
eng.run_until_drained()
beams = fut.result(timeout=0)["token_ids"]
q = torch.randn(2, 2, 4, 8, generator=g)
kv = torch.randn(2, 2, 8, 70, generator=g)
bias = torch.zeros(2, 4, 70)
single = decode_attention_single(q, kv, kv, bias, bb=2)
q4split = decode_attention_q4split(q, *quantize_kv4(kv), *quantize_kv4(kv),
                                   bias, bb=2)
from tell_tpu_torch.config_io import load_experiment
from tell_tpu_torch.data.tokenizer import RobertaTokenizer
exp = load_experiment("expt/quality/overfit_flagship.yaml")
tok = RobertaTokenizer.from_files(exp.data.vocab_file, exp.data.merges_file)
text = "Zainab Weber speaks in Lisbon, ½ of Ⅻ."
from tell_tpu_torch.serving.extractor import extract_text
sections, title = extract_text(
    '<h1>T</h1><p class="story-body-text">Para &amp; more.</p>')
import tempfile
from tell_tpu_torch.training.tensorboard import TensorBoardWriter, read_events
w = TensorBoardWriter(tempfile.mkdtemp())
w.add_scalar("train/loss", 0.5, step=3)
w.close()
from tell_tpu_torch.bridge import init_resnet
from tell_tpu_torch.data.images import resize_shortest_crop
from tell_tpu_torch.data.jpeg import decode_jpeg
from tell_tpu_torch.models.backbones.resnet import (ResNetConfig, image_grid,
                                                    prepare_resnet)
with open("tests/fixtures/images/news_a_320x240_420.jpg", "rb") as f:
    photo = decode_jpeg(f.read())
from tell_tpu_torch.data.images import decode_image
forms = {}
for name in ("news_a_320x240_420_progressive.jpg",
             "png_adam7_rgb_37x29.png"):
    with open("tests/fixtures/images/" + name, "rb") as f:
        forms[name] = list(decode_image(f.read()).shape)
rcfg_img = ResNetConfig((1, 1, 1, 1), 8)
grid = image_grid(prepare_resnet(init_resnet(g, rcfg_img)), rcfg_img,
                  resize_shortest_crop(photo).astype("float32"))
from tell_tpu_torch.bridge import init_facenet, init_mtcnn, init_yolov3
from tell_tpu_torch.models.backbones import facenet, mtcnn, yolov3
from tell_tpu_torch.serving import vision
ydefs = yolov3.parse_darknet_cfg(
    "[convolutional]\nbatch_normalize=1\nfilters=8\nsize=3\nstride=2\n"
    "activation=leaky\n[convolutional]\nfilters=27\nsize=1\nstride=1\n"
    "[yolo]\nmask=0,1,2\nclasses=4\n")
vision.DET_CANVAS = 48
towers = {"mtcnn": mtcnn.prepare_mtcnn(init_mtcnn(g)),
          "facenet": facenet.prepare_facenet(init_facenet(
              g, facenet.FaceNetConfig(repeats=(1, 1, 1)))),
          "yolov3": yolov3.prepare_yolov3(init_yolov3(g, ydefs)),
          "yolov3_defs": ydefs,
          "resnet": prepare_resnet(init_resnet(g, rcfg_img)),
          "resnet_cfg": rcfg_img}
feats = vision.VisionPipeline(towers).process({"image": photo})
print(json.dumps({"modules": names, "jax_package": jax_pkg,
                  "text_round_trip": tok.decode(tok.encode(text)) == text,
                  "bpe": type(tok.bpe).__name__,
                  "extract": [sections, title],
                  "events": read_events(w.path)[1]["scalars"],
                  "photo": [list(photo.shape), list(grid.shape)],
                  "forms": forms,
                  "vision": {k: list(v.shape) for k, v in feats.items()},
                  "expt_kernel_sizes": list(exp.model.decoder.kernel_sizes),
                  "blocked_loaded": [m for m in BLOCKED
                                     if sys.modules.get(m) is not None],
                  "jax_loaded": "jax" in sys.modules
                                and sys.modules["jax"] is not None,
                  "token_ids": list(out["token_ids"].shape),
                  "train_loss_finite": bool(torch.isfinite(m["loss"])),
                  "engine_beams": list(beams.shape),
                  "single": [list(single.shape), list(q4split.shape)],
                  "launches": [decode_attention.launches,
                               encoder_attention.launches,
                               fused_dynamic_conv.launches,
                               decode_attention_q8.launches,
                               topk_logits.launches,
                               decode_attention_single.launches,
                               decode_attention_q4split.launches]}))
"""


def test_port_imports_no_jax_and_runs_plain_on_cpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "tell_tpu_torch.serving.server" in res["modules"]
    assert "tell_tpu_torch.models.beam" in res["modules"]
    for name in ("ops.kernels.dynamic_conv", "ops.kernels.topk_logits",
                 "serving.engine", "serving.encode_batcher",
                 "training.optimizer",
                 "training.train_step", "training.checkpoint",
                 "training.trainer", "data.records", "data.bucketing",
                 "data.prefetch", "tools.timing", "tools.kernel_variants",
                 "tools.longctx_variants", "tools.profile_decode",
                 "data.tokenizer", "data.readers", "data.pipeline",
                 "data.native", "training.tensorboard", "serving.extractor",
                 "serving.client",
                 "config_io", "evalm.bleu", "evalm.rouge", "evalm.cider",
                 "evalm.meteor", "evalm.entities", "evalm.readability",
                 "commands.evaluate", "commands.__main__",
                 "tools.gen_quality_corpus", "tools.quality_loop",
                 "data.jpeg", "data.png", "data.images", "serving.vision",
                 "commands.towers", "commands.jax_random",
                 "models.backbones.resnet", "tools.convert_towers",
                 "models.backbones.mtcnn", "models.backbones.facenet",
                 "models.backbones.yolov3", "ops.image_resize"):
        assert f"tell_tpu_torch.{name}" in res["modules"]
    assert res["jax_package"] == []
    assert res["jax_loaded"] is False
    assert res["blocked_loaded"] == []
    assert res["text_round_trip"] is True
    assert res["bpe"] == "NativeBPE"
    assert res["extract"] == [[{"type": "paragraph", "text": "Para & more."}],
                              "T"]
    assert res["events"] == {"train/loss": 0.5}
    assert res["photo"] == [[240, 320, 3], [49, 256]]
    assert res["forms"] == {"news_a_320x240_420_progressive.jpg": [240, 320,
                                                                   3],
                            "png_adam7_rgb_37x29.png": [29, 37, 3]}
    assert res["vision"] == {"image_grid": [49, 256],
                             "face_embeds": [4, 512],
                             "obj_embeds": [64, 256]}
    assert res["expt_kernel_sizes"] == [3, 7, 15, 31]
    assert res["token_ids"] == [2, 4]
    assert res["train_loss_finite"] is True
    assert res["engine_beams"] == [2, 4]
    assert res["single"] == [[2, 2, 4, 8], [2, 2, 4, 8]]
    assert res["launches"] == [0, 0, 0, 0, 0, 0, 0]
