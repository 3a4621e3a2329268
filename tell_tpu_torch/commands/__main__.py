"""`python -m tell_tpu_torch.commands`: train / evaluate / preprocess /
serve / score / towers verify (counterpart of
tell_tpu/commands/__main__.py, `tnt`).

The subcommands and flags are tnt's where they mean the same thing. The
model runs on `--device` (default cuda): without a card and without
`--device cpu` a model command raises; nothing falls back to the CPU. The
numerics levers are flags: `--kv-cache {fp,int8,int4}`, `--fused-topk`
and `--gelu {erf,tanh}` (the frozen encoder's GELU; tell_tpu's
TELL_TPU_FAST_GELU). `serve --attention` adds the word-attention payload.
What tnt runs and the port does not yet is refused with its ROADMAP queue
item: `bench` (item 1), `--coordinator` and `--mesh-data` (item 10), the
model types outside the captioner family (config_io.py).

The frozen RoBERTa is read from <shards_dir>/../towers/roberta/state.pt
(the port's torch format: the param tree saved with torch.save, as
`python -m tell_tpu_torch.tools.convert_towers` writes it from a
HuggingFace state dict), or, when there is none, initialised at random
from seed 0 on the CPU (so the same weights on every device) with
tell_tpu's warning. The vision towers beside it are loaded onto `--device`
where their directories exist: towers/resnet152 (convert_towers --resnet),
with which `serve` embeds raw-image requests' grids and `preprocess` raw
<hash>.jpg photos, and towers/mtcnn, towers/facenet and towers/yolov3
(--mtcnn, --facenet, --yolo-cfg/--yolo-weights), with which `serve` finds
and embeds their faces and, with the ResNet, their objects. A tower
directory that holds no state.pt (tell_tpu's orbax tree) is refused,
naming migrate/orbax_to_torch.py, which converts tell_tpu's orbax runs and
towers where JAX and orbax are installed. `towers verify DIR [--tower
NAME] [--json] [--device D]` probes each converted tower
(commands/towers.py). What remains of item 8: ViT, the image forms
data/jpeg.py and data/png.py refuse, and the dataset tools.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

import torch

from ..config import NotPortedError, orbax_refusal

log = logging.getLogger("tell_tpu_torch.commands")

ROBERTA_INIT_SEED = 0


def _add_common(p):
    p.add_argument("config", help="experiment YAML (see expt/)")
    p.add_argument("-o", "--overrides", default=None,
                   help="JSON merged over the YAML config")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (default) or cpu")


def _add_levers(p):
    p.add_argument("--kv-cache", default="fp", choices=("fp", "int8", "int4"),
                   help="decode K/V cache numerics (int8/int4: kernel D)")
    p.add_argument("--fused-topk", action="store_true",
                   help="the adaptive softmax's top-k through kernel E")
    p.add_argument("--gelu", default="erf", choices=("erf", "tanh"),
                   help="the frozen RoBERTa's FFN GELU (tanh: the "
                   "approximation, gated by fast_gelu_token_agreement)")


def _add_report(p):
    p.add_argument("--report-launches", default=None, metavar="PATH",
                   help="write the kernel launch counts of this command "
                   "to PATH as JSON")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tell_tpu_torch.commands",
                                description="Transform-and-Tell on PyTorch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model")
    _add_common(t)
    _add_report(t)
    t.add_argument("-r", "--recover", action="store_true",
                   help="resume from the latest checkpoint")
    t.add_argument("--coordinator", default=None,
                   help="multi-host training (not ported)")

    e = sub.add_parser("evaluate", help="decode a split and score it")
    _add_common(e)
    _add_levers(e)
    _add_report(e)
    e.add_argument("-m", "--model", default=None,
                   help="checkpoint dir (default: <run>/checkpoints/best)")
    e.add_argument("-s", "--split", default="test")
    e.add_argument("-b", "--beam", type=int, default=1)
    e.add_argument("--limit", type=int, default=None)

    pre = sub.add_parser("preprocess", help="articles.jsonl -> shards")
    _add_common(pre)
    pre.add_argument("-s", "--split", default="train")

    sv = sub.add_parser("serve", help="start the caption HTTP service")
    _add_common(sv)
    _add_levers(sv)
    sv.add_argument("-m", "--model", default=None)
    sv.add_argument("-p", "--port", type=int, default=5558)
    sv.add_argument("-b", "--max-batch", type=int, default=32)
    sv.add_argument("--host", default="127.0.0.1",
                    help="bind address (0.0.0.0 to expose; the service "
                    "has an unauthenticated /shutdown)")
    sv.add_argument("--attention", action="store_true",
                    help="add per-step and per-word attention maps to "
                    "every answer")
    sv.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel serving (not ported; 1 only)")
    sv.add_argument("--engine-slots", type=int, default=0,
                    help="continuous-batching beam decode with this many "
                    "request slots (0 = micro-batch mode)")
    sv.add_argument("--engine-beam", type=int, default=5)
    sv.add_argument("--engine-buckets", action="store_true",
                    help="one resident engine per article bucket")
    sv.add_argument("--engine-length-penalty", type=float, default=0.0)
    sv.add_argument("--encode-batch", type=int, default=8,
                    help="rows of one batched article encode in front of "
                    "the engine")
    sv.add_argument("--warmup", action="store_true",
                    help="drive every decode shape before accepting traffic")
    sv.add_argument("--numerics-ab", action="store_true",
                    help="report each decode lever's teacher-forced "
                    "agreement with the fp path at startup")

    sc = sub.add_parser("score", help="re-score a generations.jsonl")
    sc.add_argument("generations")
    sc.add_argument("-c", "--counters", default=None,
                    help="name_counters.pkl for rare-name P/R")

    b = sub.add_parser("bench", help="not ported (queue 1 item 1, the "
                       "port's benchmark)")
    b.add_argument("rest", nargs=argparse.REMAINDER)
    b.set_defaults(not_ported="queue 1 item 1, the port's benchmark")

    tw = sub.add_parser("towers", help="frozen-tower utilities")
    tw.add_argument("action", choices=["verify"],
                    help="verify: probe converted towers and print "
                         "activation checksums")
    tw.add_argument("dir", help="towers dir (python -m "
                    "tell_tpu_torch.tools.convert_towers --out, or "
                    "migrate/orbax_to_torch.py towers)")
    tw.add_argument("-t", "--tower", action="append", default=None,
                    help="restrict to specific towers (repeatable)")
    tw.add_argument("--json", action="store_true", dest="as_json")
    tw.add_argument("--device", default="cuda")
    return p


def _load(args):
    from ..config_io import load_experiment
    return load_experiment(args.config, args.overrides)


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "--device cpu to run on the CPU")
    return dev


def _article_len(exp) -> int:
    for c in exp.model.decoder.contexts:
        if c.name == "article":
            return c.max_len
    return 512


def _tokenizer(exp, use_native: bool = True):
    from ..data.tokenizer import RobertaTokenizer
    return RobertaTokenizer.from_files(exp.data.vocab_file,
                                       exp.data.merges_file,
                                       max_len=_article_len(exp),
                                       use_native=use_native)


def _towers_dir(exp) -> str:
    """<shards_dir>/../towers (normalised: the shards dir need not exist
    yet)."""
    return os.path.normpath(os.path.join(exp.data.shards_dir, "..",
                                         "towers"))


def _frozen_towers(exp, device, gelu: str = "erf") -> dict:
    """{"roberta": params on `device`, "roberta_cfg": RobertaConfig with
    the FFN's GELU mode `gelu`}, and each converted vision tower in the
    towers directory on `device` in its forward's layout: "resnet" (with
    "resnet_cfg": ResNetConfig.resnet152()), "mtcnn", "facenet" and
    "yolov3" (whose module defs are yolov3_spp_module_defs(), as
    tell_tpu's)."""
    from ..bridge import init_roberta, tree_map
    from ..models.backbones.roberta import RobertaConfig
    rcfg = dataclasses.replace(getattr(RobertaConfig, exp.data.roberta)(),
                               gelu=gelu)
    path = os.path.join(_towers_dir(exp), "roberta")
    if os.path.exists(path):
        state = os.path.join(path, "state.pt")
        if not os.path.exists(state):
            raise orbax_refusal(path, "towers", _towers_dir(exp))
        roberta = torch.load(state, map_location="cpu", weights_only=True)
    else:
        logging.warning("no converted RoBERTa weights at %s; using random "
                        "init (quality will be garbage — convert with "
                        "python -m tell_tpu_torch.tools.convert_towers)",
                        path)
        g = torch.Generator().manual_seed(ROBERTA_INIT_SEED)
        roberta = init_roberta(g, rcfg)
    frozen = {"roberta": tree_map(lambda x: x.to(device), roberta),
              "roberta_cfg": rcfg}
    resnet = os.path.join(_towers_dir(exp), "resnet152")
    if os.path.exists(resnet):
        from ..models.backbones.resnet import ResNetConfig, load_tower
        frozen["resnet"] = load_tower(resnet, device)
        frozen["resnet_cfg"] = ResNetConfig.resnet152()
    from ..models.backbones.facenet import load_facenet
    from ..models.backbones.mtcnn import load_mtcnn
    from ..models.backbones.yolov3 import load_yolov3
    for name, load in (("mtcnn", load_mtcnn), ("facenet", load_facenet),
                       ("yolov3", load_yolov3)):
        path = os.path.join(_towers_dir(exp), name)
        if os.path.exists(path):
            frozen[name] = load(path, device)
    return frozen


def _restore_params(exp, model_dir, device) -> dict:
    path = os.path.abspath(model_dir or os.path.join(
        exp.trainer.serialization_dir, "checkpoints", "best"))
    if os.path.isdir(path) and not os.path.exists(
            os.path.join(path, "state.pt")):
        raise orbax_refusal(path, "run", os.path.dirname(
            os.path.dirname(path)))
    state = torch.load(os.path.join(path, "state.pt"), map_location=device,
                       weights_only=True)
    return state["params"]


def _kernel_launches() -> dict:
    from ..ops.kernels.decode_attention import (decode_attention,
                                                decode_attention_q8)
    from ..ops.kernels.dynamic_conv import fused_dynamic_conv
    from ..ops.kernels.encoder_attention import encoder_attention
    from ..ops.kernels.topk_logits import topk_logits
    return {f.__name__: f.launches for f in (
        decode_attention, encoder_attention, fused_dynamic_conv,
        decode_attention_q8, topk_logits)}


def _report_launches(args) -> None:
    """The launches of this command (the counters count per process, and
    the quality loop runs several commands in one)."""
    if getattr(args, "report_launches", None):
        now = _kernel_launches()
        with open(args.report_launches, "w") as f:
            json.dump({k: n - args.launches_before[k]
                       for k, n in now.items()}, f)


def build_trainer(exp, device):
    """The Trainer that `train` runs for the experiment: the shards of
    exp.data read through the C++ reader and packed by bucket_batches, the
    frozen towers on `device`."""
    from ..data.bucketing import bucket_batches
    from ..data.records import RecordDataset
    from ..training.trainer import Trainer

    d = exp.data
    train_ds = RecordDataset(os.path.join(d.shards_dir, "train-*.npz"),
                             seed=d.seed)
    val_ds = RecordDataset(os.path.join(d.shards_dir, "valid-*.npz"),
                           seed=d.seed)

    def train_batches(epoch):
        # an order that is a pure function of (seed, epoch), so a
        # recovered run repeats the interrupted epoch's batches
        return bucket_batches(
            train_ds.epoch(epoch_index=epoch, lazy=True,
                           limit=d.instances_per_epoch), exp.bucketing)

    def val_batches():
        return bucket_batches(val_ds.epoch(lazy=True, limit=d.val_limit),
                              exp.bucketing)

    return Trainer(exp.model, exp.trainer, train_batches, val_batches,
                   _frozen_towers(exp, device), device=device)


def cmd_train(args) -> int:
    if args.coordinator is not None:
        raise NotPortedError("multi-host training is not ported yet (ROADMAP "
                             "queue 1 item 10, parallelism)")
    exp = _load(args)
    trainer = build_trainer(exp, _device(args))
    if args.recover and not trainer.recover():
        print(f"train -r: no checkpoint to recover in "
              f"{exp.trainer.serialization_dir}", file=sys.stderr)
        return 1
    result = trainer.train()
    _report_launches(args)
    print(json.dumps(result))
    return 0


def cmd_evaluate(args) -> int:
    from .evaluate import evaluate_split
    exp = _load(args)
    device = _device(args)
    metrics = evaluate_split(
        exp, _restore_params(exp, args.model, device),
        _frozen_towers(exp, device, args.gelu), _tokenizer(exp),
        split=args.split,
        beam_size=args.beam, limit=args.limit, device=device,
        kv_cache=args.kv_cache, fused_topk=args.fused_topk)
    _report_launches(args)
    print(json.dumps(metrics, indent=2))
    return 0


def preprocess(exp, split: str, use_native: bool = True,
               device="cuda") -> tuple[int, str]:
    """The split's articles into shards under exp.data.shards_dir, tokenized
    through the C++ BPE (use_native=False: the Python ByteBPE), raw photos
    embedded on `device` by the converted ResNet-152; returns the example
    count and the BPE's class name."""
    from ..data.pipeline import (load_objects_jsonl, make_image_grid_fn,
                                 preprocess_split, read_articles_jsonl)
    objects_lookup = None
    if exp.data.objects_jsonl:
        objects_lookup = load_objects_jsonl(exp.data.objects_jsonl)
    image_grid_fn = None
    if exp.data.images_dir:
        image_grid_fn = make_image_grid_fn(exp.data.images_dir,
                                           _towers_dir(exp), device)
    tok = _tokenizer(exp, use_native)
    n = preprocess_split(
        read_articles_jsonl(exp.data.articles_jsonl), tok, exp.reader,
        exp.data.shards_dir, split, image_grid_fn=image_grid_fn,
        objects_lookup=objects_lookup)
    bpe = type(tok.bpe).__name__
    log.info("preprocess %s: %d examples tokenized by %s", split, n, bpe)
    return n, bpe


def cmd_preprocess(args) -> int:
    n, _ = preprocess(_load(args), args.split, device=args.device)
    print(json.dumps({"examples": n, "split": args.split}))
    return 0


def cmd_serve(args) -> int:
    from ..models.backbones.roberta import RobertaEncoder
    from ..serving import CaptionService, serve
    if args.mesh_data != 1:
        raise NotPortedError("data-parallel serving is not ported yet "
                             "(ROADMAP queue 1 item 10, parallelism)")
    exp = _load(args)
    device = _device(args)
    frozen = _frozen_towers(exp, device, args.gelu)
    service = CaptionService(
        _restore_params(exp, args.model, device),
        RobertaEncoder(frozen["roberta"], frozen["roberta_cfg"]), exp.model,
        device, tokenizer=_tokenizer(exp), max_batch=args.max_batch,
        engine_slots=args.engine_slots, engine_beam=args.engine_beam,
        engine_length_penalty=args.engine_length_penalty,
        engine_buckets=args.engine_buckets, encode_batch=args.encode_batch,
        kv_cache=args.kv_cache, fused_topk=args.fused_topk,
        need_attention=args.attention,
        towers={k: frozen[k] for k in ("resnet", "resnet_cfg", "mtcnn",
                                       "facenet", "yolov3") if k in frozen})
    if args.warmup:
        w = service.warmup()
        print(f"warmed article widths {w['widths']} in {w['seconds']:.1f}s")
    if args.numerics_ab:
        ab = service.numerics_ab()
        print(f"numerics A/B: int8-KV token agreement "
              f"{ab['kv8_token_agreement']:.3f}, tanh-GELU "
              f"{ab['fast_gelu_token_agreement']:.3f} (active modes: "
              f"{ab['kv_cache_mode']}, {ab['gelu_mode']}; "
              f"{ab['seconds']:.1f}s)")
    print(f"serving on {args.host}:{args.port}"
          + (f" (continuous batching: {args.engine_slots} slots, beam "
             f"{args.engine_beam})" if args.engine_slots else ""))
    try:
        serve(service, port=args.port, host=args.host)
    finally:
        service.close()
    return 0


def cmd_score(args) -> int:
    from .evaluate import score_file
    print(json.dumps(score_file(args.generations, args.counters), indent=2))
    return 0


def cmd_towers(args) -> int:
    from .towers import verify
    return verify(args.dir, args.tower, args.as_json, _device(args))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    args.launches_before = _kernel_launches()
    if getattr(args, "not_ported", None):
        raise NotPortedError(f"{args.cmd} is not ported yet (ROADMAP "
                             f"{args.not_ported})")
    return {"train": cmd_train, "evaluate": cmd_evaluate,
            "preprocess": cmd_preprocess, "serve": cmd_serve,
            "score": cmd_score, "towers": cmd_towers}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
