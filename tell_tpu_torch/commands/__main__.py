"""`python -m tell_tpu_torch.commands`: train / evaluate / preprocess /
serve / score / towers verify (counterpart of
tell_tpu/commands/__main__.py, `tnt`).

The subcommands and flags are tnt's where they mean the same thing. The
model runs on `--device` (default cuda): without a card and without
`--device cpu` a model command raises; nothing falls back to the CPU. The
numerics levers are flags: `--kv-cache {fp,int8,int4}`, `--fused-topk`,
`--gelu {erf,tanh}` (the frozen encoder's GELU; tell_tpu's
TELL_TPU_FAST_GELU), and the int8 ones, tell_tpu's environment switches:
`--dec8`, `--dec8-sm` and `--merged-vocab` on evaluate and serve
(TELL_TPU_DEC8, _DEC8_SM, _MERGED_VOCAB; a family refuses those its
decode does not read), and `--enc8` on train, evaluate and serve
(TELL_TPU_ENC8: the frozen RoBERTa quantised once at load). `serve
--attention` adds the word-attention payload.

Several devices: `train` with trainer.n_data N > 1 and no coordinator
spawns N local ranks, one a device (N gloo ranks under --device cpu;
a null n_data, which in tell_tpu meshes every device of its process,
trains on one, with a warning where more GPUs are visible);
`train --coordinator HOST:PORT --num-processes P --process-id I` is one
rank of P, run on every host (the backend follows --device: NCCL for
cuda, gloo for cpu; the process uses GPU I mod the visible count, or
LOCAL_RANK where set). With more than one rank the bucketing config must
have one shape, and bucketing.max_batch is the global batch. `serve
--mesh-data N` keeps a replica on each of N devices and splits each
micro-batch's rows over them, or, with `--engine-slots S`, shards the
engine's S slots over them (S/N a device). `train` with trainer.n_model
> 1 runs tensor-parallel on n_data x n_model ranks (spawned locally, or
one a process with --coordinator). What tnt runs and the port does not
yet is refused with its ROADMAP queue item: `bench` (item 1).
Every family (the captioner and its siblings, the GloVe captioner, the
pointer models of expts a1-a3, the LSTM and the modern LM) trains,
evaluates and serves through its registry adapter (the pointer and the
LSTM decode greedily and serve in micro-batch mode only; the pointer's
requests may carry `entities`, and its train takes a captioner checkpoint
as trainer.warm_start);
`preprocess` writes GloVe article features where data.glove_file names
a vectors file (data/glove.py).

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
and embeds their faces and, with the ResNet, their objects, and
towers/vit (--vit), ViT-L/16, with which the modern family's encode turns
a batch's `image` into its image context. A tower
directory that holds no state.pt (tell_tpu's orbax tree) is refused,
naming migrate/orbax_to_torch.py, which converts tell_tpu's orbax runs and
towers where JAX and orbax are installed. `towers verify DIR [--tower
NAME] [--json] [--device D]` probes each converted tower
(commands/towers.py). The dataset build's tools (get_articles_nytimes,
process_images, detect_faces, annotate_objects) are modules of
tell_tpu_torch.tools. What remains of item 8: the image forms data/jpeg.py
and data/png.py refuse.
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
    p.add_argument("--dec8", action="store_true",
                   help="the decode step's projections in int8 (kernel G)")
    p.add_argument("--dec8-sm", action="store_true",
                   help="the adaptive softmax's decode tables in int8 "
                   "(kernel G)")
    p.add_argument("--merged-vocab", action="store_true",
                   help="the decode's softmax from one merged fp32 table")


def _add_enc8(p):
    p.add_argument("--enc8", action="store_true",
                   help="the frozen RoBERTa's dense layers in int8 "
                   "(w8a8, kernel G), quantised once at load")


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
                   help="multi-host training: rank 0's host:port (or an "
                   "init URL, file://...); run the same command on every "
                   "host with its own --process-id")
    t.add_argument("--num-processes", type=int, default=1)
    t.add_argument("--process-id", type=int, default=0)
    _add_enc8(t)

    e = sub.add_parser("evaluate", help="decode a split and score it")
    _add_common(e)
    _add_levers(e)
    _add_enc8(e)
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
    _add_enc8(sv)
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
                    help="data-parallel serving: a replica on each of N "
                    "devices, each micro-batch's rows split over them")
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


def _adapter(exp):
    from ..models.registry import get_model
    return get_model(exp.model_type, exp.model)


def _article_len(exp) -> int:
    for c in getattr(exp.model, "decoder", exp.model).contexts:
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


def _frozen_towers(exp, device, gelu: str = "erf",
                   enc8: bool = False) -> dict:
    """{"roberta": params on `device` (in int8 under enc8: ops/quant.py's
    maybe_quantize_frozen), "roberta_cfg": RobertaConfig with the FFN's
    GELU mode `gelu`}, and each converted vision tower in the
    towers directory on `device` in its forward's layout: "resnet" (with
    "resnet_cfg": ResNetConfig.resnet152()), "vit" (with "vit_cfg":
    ViTConfig.large(), as tell_tpu's), "mtcnn", "facenet" and "yolov3"
    (whose module defs are yolov3_spp_module_defs(), as tell_tpu's)."""
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
    vit = os.path.join(_towers_dir(exp), "vit")
    if os.path.exists(vit):
        from ..models.backbones.vit import ViTConfig, load_vit
        frozen["vit"] = load_vit(vit, device)
        frozen["vit_cfg"] = ViTConfig.large()
    from ..models.backbones.facenet import load_facenet
    from ..models.backbones.mtcnn import load_mtcnn
    from ..models.backbones.yolov3 import load_yolov3
    for name, load in (("mtcnn", load_mtcnn), ("facenet", load_facenet),
                       ("yolov3", load_yolov3)):
        path = os.path.join(_towers_dir(exp), name)
        if os.path.exists(path):
            frozen[name] = load(path, device)
    from ..ops.quant import maybe_quantize_frozen
    return maybe_quantize_frozen(frozen, enc8)


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


def build_trainer(exp, device, enc8: bool = False):
    """The Trainer that `train` runs for the experiment: its family's
    adapter, the shards of exp.data read through the C++ reader and packed
    by bucket_batches, the frozen towers on `device` (the RoBERTa in int8
    under enc8, quantised by the Trainer after its dtype cast); in a
    process group, this rank's stride of each epoch, in batches of its
    share of the global batch size."""
    from ..data.bucketing import bucket_batches
    from ..data.records import RecordDataset
    from ..training.trainer import Trainer, data_ranks

    d = exp.data
    train_ds = RecordDataset(os.path.join(d.shards_dir, "train-*.npz"),
                             seed=d.seed)
    val_ds = RecordDataset(os.path.join(d.shards_dir, "valid-*.npz"),
                           seed=d.seed)
    pi, pc = data_ranks(exp.bucketing, exp.trainer.n_model)

    def train_batches(epoch):
        # an order that is a pure function of (seed, epoch), so a
        # recovered run repeats the interrupted epoch's batches
        return bucket_batches(
            train_ds.epoch(epoch_index=epoch, lazy=True,
                           limit=d.instances_per_epoch, process_index=pi,
                           process_count=pc), exp.bucketing, ranks=pc)

    def val_batches():
        return bucket_batches(val_ds.epoch(lazy=True, limit=d.val_limit,
                                           process_index=pi,
                                           process_count=pc),
                              exp.bucketing, ranks=pc)

    return Trainer(exp.model, exp.trainer, train_batches, val_batches,
                   _frozen_towers(exp, device), device=device,
                   adapter=_adapter(exp), enc8=enc8)


def _train(exp, device, recover: bool, enc8: bool = False):
    """Build and run the Trainer; (exit code, result or None)."""
    trainer = build_trainer(exp, device, enc8)
    if recover and not trainer.recover():
        print(f"train -r: no checkpoint to recover in "
              f"{exp.trainer.serialization_dir}", file=sys.stderr)
        return 1, None
    return 0, trainer.train()


def _rank_device(device: torch.device, index: int) -> torch.device:
    """A rank's device: GPU `index` modulo the visible ones on cuda."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", index % torch.cuda.device_count())


def _train_rank(rank: int, world: int, config: str, overrides, device: str,
                recover: bool, enc8: bool = False) -> tuple:
    """One of `train`'s spawned local ranks: (exit code, result, the
    kernel launches of this rank)."""
    logging.basicConfig(level=logging.INFO)
    from ..config_io import load_experiment
    before = _kernel_launches()
    code, result = _train(load_experiment(config, overrides),
                          _rank_device(torch.device(device), rank), recover,
                          enc8)
    return code, result, {k: n - before[k]
                          for k, n in _kernel_launches().items()}


def _spawn_train(args, exp, device: torch.device) -> int:
    """trainer.n_data x trainer.n_model local ranks, one a device, each a
    process."""
    from ..parallel.mesh import check_mesh_size
    from ..parallel.multihost import backend_for, run_ranks
    t = exp.trainer
    n = (t.n_data or 1) * t.n_model
    available = (torch.cuda.device_count() if device.type == "cuda"
                 else n)
    check_mesh_size(t.n_data or 1, t.n_model, available)
    outs = run_ranks(_train_rank, n, (args.config, args.overrides,
                                      str(device), args.recover, args.enc8),
                     backend=backend_for(device), deadline_s=None)
    code, result = outs[0][:2]
    if code:
        return code
    if getattr(args, "report_launches", None):
        with open(args.report_launches, "w") as f:
            json.dump({k: sum(o[2][k] for o in outs) for k in outs[0][2]},
                      f)
    print(json.dumps(result))
    return 0


def cmd_train(args) -> int:
    device = _device(args)
    exp = _load(args)            # a bad config fails before the group
    if args.coordinator is not None:
        # one rank of --num-processes, before anything touches the group
        from ..parallel.multihost import backend_for, init_multihost
        local = int(os.environ.get("LOCAL_RANK", args.process_id))
        device = _rank_device(device, local)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_multihost(args.coordinator, args.num_processes,
                       args.process_id, backend_for(device))
    if args.coordinator is None and (
            (exp.trainer.n_data or 1) * exp.trainer.n_model > 1):
        return _spawn_train(args, exp, device)
    if (args.coordinator is None and exp.trainer.n_data is None
            and device.type == "cuda" and torch.cuda.device_count() > 1):
        # tell_tpu's null n_data meshes every device of its one process;
        # here one rank is one process, and the ranks are asked for
        log.warning("trainer.n_data is null: training on one of the %d "
                    "visible GPUs; set trainer.n_data to train on more",
                    torch.cuda.device_count())
    code, result = _train(exp, device, args.recover, args.enc8)
    if code:
        return code
    _report_launches(args)
    print(json.dumps(result))
    return 0


def cmd_evaluate(args) -> int:
    from .evaluate import evaluate_split
    exp = _load(args)
    device = _device(args)
    metrics = evaluate_split(
        exp, _restore_params(exp, args.model, device),
        _frozen_towers(exp, device, args.gelu, args.enc8), _tokenizer(exp),
        split=args.split,
        beam_size=args.beam, limit=args.limit, device=device,
        kv_cache=args.kv_cache, fused_topk=args.fused_topk, dec8=args.dec8,
        dec8_sm=args.dec8_sm, merged_vocab=args.merged_vocab)
    _report_launches(args)
    print(json.dumps(metrics, indent=2))
    return 0


def preprocess(exp, split: str, use_native: bool = True,
               device="cuda") -> tuple[int, str]:
    """The split's articles into shards under exp.data.shards_dir, tokenized
    through the C++ BPE (use_native=False: the Python ByteBPE), raw photos
    embedded on `device` by the converted ResNet-152, and with
    data.glove_file each article's GloVe features; returns the example
    count and the BPE's class name."""
    from ..data.pipeline import (load_objects_jsonl, make_image_grid_fn,
                                 preprocess_split, read_articles_jsonl)
    glove = None
    if exp.data.glove_file:
        from ..data.glove import GloveVectors
        glove = GloveVectors.from_file(exp.data.glove_file)
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
        objects_lookup=objects_lookup, glove=glove)
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
    exp = _load(args)
    device = _device(args)
    devices = None
    if args.mesh_data > 1:
        from ..parallel.mesh import check_mesh_size
        available = (torch.cuda.device_count() if device.type == "cuda"
                     else args.mesh_data)
        check_mesh_size(args.mesh_data, 1, available)
        devices = [_rank_device(device, i) for i in range(args.mesh_data)]
    # under --enc8 the tower is quantised here, so no fp copy stays
    # resident; the service's own quantisation then finds nothing to do
    frozen = _frozen_towers(exp, device, args.gelu, args.enc8)
    service = CaptionService(
        _restore_params(exp, args.model, device),
        RobertaEncoder(frozen["roberta"], frozen["roberta_cfg"]), exp.model,
        device, adapter=_adapter(exp), tokenizer=_tokenizer(exp),
        max_batch=args.max_batch,
        engine_slots=args.engine_slots, engine_beam=args.engine_beam,
        engine_length_penalty=args.engine_length_penalty,
        engine_buckets=args.engine_buckets, encode_batch=args.encode_batch,
        kv_cache=args.kv_cache, fused_topk=args.fused_topk, dec8=args.dec8,
        dec8_sm=args.dec8_sm, merged_vocab=args.merged_vocab,
        enc8=args.enc8, need_attention=args.attention,
        towers={k: frozen[k] for k in ("resnet", "resnet_cfg", "mtcnn",
                                       "facenet", "yolov3") if k in frozen},
        devices=devices)
    if args.warmup:
        w = service.warmup()
        print(f"warmed article widths {w['widths']} in {w['seconds']:.1f}s")
    if args.numerics_ab:
        ab = service.numerics_ab()
        agree = ", ".join(f"{k[:-len('_token_agreement')]} {v:.3f}"
                          for k, v in ab.items()
                          if k.endswith("_token_agreement"))
        print(f"numerics A/B token agreement: {agree} (active modes: "
              f"{ab['kv_cache_mode']}, {ab['gelu_mode']}; "
              f"{ab['seconds']:.1f}s)")
    print(f"serving on {args.host}:{args.port}"
          + (f" (data-parallel x{args.mesh_data})" if devices else "")
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
