"""`python -m tell_tpu_torch.commands`: train / evaluate / preprocess /
serve / score (counterpart of tell_tpu/commands/__main__.py, `tnt`).

The subcommands and flags are tnt's where they mean the same thing. The
model runs on `--device` (default cuda): without a card and without
`--device cpu` a model command raises; nothing falls back to the CPU. The
numerics levers are flags: `--kv-cache {fp,int8,int4}`, `--fused-topk`
and `--gelu {erf,tanh}` (the frozen encoder's GELU; tell_tpu's
TELL_TPU_FAST_GELU). `serve --attention` adds the word-attention payload.
What tnt runs and the port does not yet is refused with its ROADMAP queue
item: `bench` (item 1), `towers` (item 8, the remaining towers),
`--coordinator` and `--mesh-data` (item 10), the model types outside the
captioner family (config_io.py).

The frozen RoBERTa is read from <shards_dir>/../towers/roberta/state.pt
(the port's torch format: the param tree saved with torch.save, as
`python -m tell_tpu_torch.tools.convert_towers` writes it from a
HuggingFace state dict), or, when there is none, initialised at random
from seed 0 on the CPU (so the same weights on every device) with
tell_tpu's warning. A converted ResNet-152 at towers/resnet152/state.pt
(convert_towers --resnet) is loaded beside it: `serve` then embeds
raw-image requests and `preprocess` raw <hash>.jpg photos on `--device`.
A towers/roberta or towers/resnet152 that holds anything else (tell_tpu's
orbax tree) is refused, and so is `serve` over a towers directory with
tell_tpu's mtcnn, facenet or yolov3 (not ported: item 8).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

import torch

from ..config import NotPortedError

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

    for name, item in (("bench", "queue 1 item 1, the port's benchmark"),
                       ("towers", "queue 1 item 8, the remaining towers")):
        b = sub.add_parser(name, help=f"not ported ({item})")
        b.add_argument("rest", nargs=argparse.REMAINDER)
        b.set_defaults(not_ported=item)
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
    the FFN's GELU mode `gelu`}, and with a converted ResNet-152 in the
    towers directory {"resnet": its tree on `device` in the forward's
    layout (load_tower), "resnet_cfg": ResNetConfig.resnet152()}."""
    from ..bridge import init_roberta, tree_map
    from ..models.backbones.roberta import RobertaConfig
    rcfg = dataclasses.replace(getattr(RobertaConfig, exp.data.roberta)(),
                               gelu=gelu)
    path = os.path.join(_towers_dir(exp), "roberta")
    if os.path.exists(path):
        state = os.path.join(path, "state.pt")
        if not os.path.exists(state):
            raise NotPortedError(
                f"{path} holds no state.pt (a tell_tpu orbax tree?): reading "
                "tell_tpu checkpoints needs the JAX-side conversion step of "
                "ROADMAP queue 1 item 6")
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
    return frozen


def _restore_params(exp, model_dir, device) -> dict:
    path = os.path.abspath(model_dir or os.path.join(
        exp.trainer.serialization_dir, "checkpoints", "best"))
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
    from ..serving.vision import refuse_unported_towers
    if args.mesh_data != 1:
        raise NotPortedError("data-parallel serving is not ported yet "
                             "(ROADMAP queue 1 item 10, parallelism)")
    exp = _load(args)
    device = _device(args)
    if os.path.isdir(_towers_dir(exp)):
        refuse_unported_towers(os.listdir(_towers_dir(exp)))
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
        towers={k: frozen[k] for k in ("resnet", "resnet_cfg")
                if k in frozen})
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


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    args.launches_before = _kernel_launches()
    if getattr(args, "not_ported", None):
        raise NotPortedError(f"{args.cmd} is not ported yet (ROADMAP "
                             f"{args.not_ported})")
    return {"train": cmd_train, "evaluate": cmd_evaluate,
            "preprocess": cmd_preprocess, "serve": cmd_serve,
            "score": cmd_score}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
