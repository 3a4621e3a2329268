"""The quality loop through the port's command line (counterpart of
tools/quality_loop.py): preprocess -> train -> evaluate -> score on the
committed synthetic corpus (tests/fixtures/quality/), before and after.

  before: after --before-epochs epochs (default 1), greedy then beam:
          the captions are noise, CIDEr ~0
  after:  after the config's num_epochs, greedy and beam on the train
          split: the model has memorised the training captions
  re-score: `score` over the beam generations
  entities: the corpus gazetteer (entities.json) as the NER, caption
          reproduction (exact and normalised) and entity P/R
  lever A/Bs at trained margins, each against the beam decode above:
          ab_kv8 (--kv-cache int8, kernel D on the card against the fp
          cache), ab_fused_topk (--fused-topk, kernel E against the
          exact per-cluster top-k) and ab_fast_gelu (--gelu tanh, the
          frozen encoder's tanh GELU against erf)

Each finished phase (preprocess, before, train) is journaled to
<run_dir>/quality-phases.json; --resume skips journaled phases (train goes
on from the latest checkpoint with `train -r`; evaluation always re-runs).
The feature files (objects.jsonl, grids/) are written next to the
configured objects_jsonl when missing, by this package's write_features.

    python -m tell_tpu_torch.tools.quality_loop \\
        --expt expt/quality/overfit_flagship.yaml --out runs/q.json
    python -m tell_tpu_torch.tools.quality_loop ... --device cpu \\
        --expt expt/quality/overfit_small.yaml   # a small CPU run
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import sys
import time

from ..config_io import load_experiment
from ..evalm.entities import entity_precision_recall
from .gen_quality_corpus import FEATURES_SEED, read_articles, write_features


def gazetteer_ner(entities: dict):
    """text -> [(entity_text, label)] by longest-first word-boundary match
    (overlaps go to the longer span)."""
    names = sorted(entities, key=len, reverse=True)
    pats = [(n, re.compile(r"(?<!\w)" + re.escape(n) + r"(?!\w)"))
            for n in names]

    def ner(text: str) -> list[tuple[str, str]]:
        found, used = [], []
        for name, pat in pats:
            for m in pat.finditer(text):
                s, e = m.span()
                if any(s < ue and us < e for us, ue in used):
                    continue
                used.append((s, e))
                found.append((name, entities[name]))
        return found

    return ner


def _normalize(t: str) -> str:
    return re.sub(r"[^\w\s]", "", t).lower().split().__str__()


def reproduction_and_entities(gen_path: str, entities: dict) -> dict:
    ner = gazetteer_ner(entities)
    with open(gen_path, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    exact = sum(1 for r in rows if r["generation"] == r["caption"])
    norm = sum(1 for r in rows
               if _normalize(r["generation"]) == _normalize(r["caption"]))
    pr = entity_precision_recall(
        [[t for t, _ in ner(r["generation"])] for r in rows],
        [[t for t, _ in ner(r["caption"])] for r in rows])
    return {"n": len(rows),
            "caption_reproduction_exact": exact / max(len(rows), 1),
            "caption_reproduction_normalized": norm / max(len(rows), 1),
            "entity_precision": pr["precision"] * 100,
            "entity_recall": pr["recall"] * 100}


def run_command(argv: list[str], device: str) -> dict:
    """Run a subcommand of `python -m tell_tpu_torch.commands` in this
    process (train and evaluate on `device`); returns the last JSON object
    it printed."""
    from ..commands.__main__ import main
    if argv[0] in ("train", "evaluate"):
        argv = argv + ["--device", device]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{argv} -> rc {rc}\n{buf.getvalue()}")
    out = buf.getvalue()
    return json.loads(out[out.index("{"):]) if "{" in out else {}


def ensure_features(exp) -> None:
    """Write objects.jsonl and grids/ beside the configured objects_jsonl
    (images_dir must be its grids/) when either is missing."""
    d = exp.data
    if not d.objects_jsonl and not d.images_dir:
        return
    out = os.path.dirname(os.path.abspath(d.objects_jsonl or d.images_dir))
    if d.images_dir and os.path.abspath(d.images_dir) != os.path.join(
            out, "grids"):
        raise ValueError(f"images_dir {d.images_dir} is not the grids/ "
                         f"beside objects_jsonl {d.objects_jsonl}")
    if ((d.objects_jsonl and not os.path.exists(d.objects_jsonl))
            or (d.images_dir and not os.path.isdir(d.images_dir))):
        write_features(read_articles(d.articles_jsonl), out, FEATURES_SEED)


def _read_gens(path: str) -> list[str]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line)["generation"] for line in f]


def run(args) -> dict:
    def tnt(argv):
        return run_command(argv, args.device)

    def merged(extra: dict) -> list[str]:
        base = json.loads(args.overrides) if args.overrides else {}
        for k, v in extra.items():
            base.setdefault(k, {}).update(v)
        return ["-o", json.dumps(base)] if base else []

    exp = load_experiment(args.expt, args.overrides)
    ensure_features(exp)
    run_dir = exp.trainer.serialization_dir
    os.makedirs(run_dir, exist_ok=True)
    fixture_dir = os.path.dirname(os.path.abspath(exp.data.articles_jsonl))
    with open(os.path.join(fixture_dir, "entities.json"),
              encoding="utf-8") as f:
        entities = json.load(f)

    result = {"expt": args.expt,
              "corpus": {"articles_jsonl": exp.data.articles_jsonl,
                         "n_entities": len(entities)},
              "config": {"num_epochs": exp.trainer.num_epochs,
                         "before_epochs": args.before_epochs,
                         "lr": exp.trainer.lr, "beam": args.beam,
                         "device": args.device,
                         # METEOR's stem stage and the readability
                         # tokenizer use nltk where it is installed
                         "nltk": importlib.util.find_spec("nltk")
                         is not None}}
    gen_path = os.path.join(run_dir, "generations-train.jsonl")
    launches_path = os.path.join(run_dir, "launches.json")
    journal_path = os.path.join(run_dir, "quality-phases.json")
    journal: dict = {}
    if args.resume and os.path.exists(journal_path):
        with open(journal_path, encoding="utf-8") as jf:
            journal = json.load(jf)

    def save_phase(name: str, payload: dict) -> None:
        journal[name] = payload
        tmp = journal_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as jf:
            json.dump(journal, jf, indent=2)
        os.replace(tmp, journal_path)

    def evaluate(extra: list[str], keep_as: str) -> dict:
        m = tnt(["evaluate", args.expt, "-s", "train", "--report-launches",
                 launches_path] + extra + merged({}))
        m.update(reproduction_and_entities(gen_path, entities))
        with open(launches_path) as f:
            m["kernel_launches"] = json.load(f)
        shutil.copy(gen_path, os.path.join(run_dir, keep_as))
        return m

    beam = ["--beam", str(args.beam)]
    if "preprocess" not in journal:
        t0 = time.time()
        tnt(["preprocess", args.expt, "-s", "train"] + merged({}))
        n = tnt(["preprocess", args.expt, "-s", "valid"] + merged({}))
        save_phase("preprocess", {"examples": n.get("examples"),
                                  "seconds": round(time.time() - t0, 1)})
    result["corpus"]["n_examples"] = journal["preprocess"]["examples"]
    result["preprocess_seconds"] = journal["preprocess"]["seconds"]

    if "before" not in journal:
        t0 = time.time()
        tnt(["train", args.expt]
            + merged({"trainer": {"num_epochs": args.before_epochs,
                                  "checkpoint_every": 1}}))
        before = evaluate([], "generations-before.jsonl")
        before_beam = evaluate(beam, "generations-before-beam.jsonl")
        save_phase("before", {"metrics": before,
                              "metrics_beam": before_beam,
                              "seconds": round(time.time() - t0, 1)})
    result["before"] = journal["before"]["metrics"]
    result["before_beam"] = journal["before"]["metrics_beam"]
    result["before_seconds"] = journal["before"]["seconds"]

    if "train" not in journal:
        ckpt_dir = os.path.join(run_dir, "checkpoints")
        if not (os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir)):
            raise FileNotFoundError(
                f"train: no checkpoint in {ckpt_dir} to resume from (run "
                "without --resume, in a fresh run dir, to start over)")
        t0 = time.time()
        train_res = tnt(["train", args.expt, "-r"] + merged({}))
        save_phase("train", {"result": train_res,
                             "seconds": round(time.time() - t0, 1)})
    result["train"] = journal["train"]["result"]
    result["train_seconds"] = journal["train"]["seconds"]

    t0 = time.time()
    result["after_greedy"] = evaluate([], "generations-after-greedy.jsonl")
    beam_name = f"generations-after-beam{args.beam}.jsonl"
    result["after_beam"] = evaluate(beam, beam_name)
    result["score_rescore_beam"] = tnt(
        ["score", os.path.join(run_dir, beam_name)])
    result["evaluate_seconds"] = round(time.time() - t0, 1)

    # the decode levers at trained margins, each against the beam decode
    ref = _read_gens(os.path.join(run_dir, beam_name))
    for name, flags in (("kv8", ["--kv-cache", "int8"]),
                        ("fused_topk", ["--fused-topk"]),
                        ("fast_gelu", ["--gelu", "tanh"])):
        t0 = time.time()
        m = evaluate(beam + flags, f"generations-ab-{name}.jsonl")
        gens = _read_gens(gen_path)
        agree = sum(a == b for a, b in zip(ref, gens)) / max(len(ref), 1)
        result[f"ab_{name}"] = {
            "flags": flags,
            "caption_agreement_vs_default": round(agree, 4),
            "cider": m.get("cider"),
            "caption_reproduction_exact": m["caption_reproduction_exact"],
            "kv_cache_mode": m.get("kv_cache_mode"),
            "topk_mode": m.get("topk_mode"),
            "gelu_mode": m.get("gelu_mode"),
            "kernel_launches": m["kernel_launches"],
            "seconds": round(time.time() - t0, 1)}
    save_phase("after", {k: result[k] for k in (
        "config", "after_greedy", "after_beam", "score_rescore_beam",
        "evaluate_seconds", "ab_kv8", "ab_fused_topk", "ab_fast_gelu")})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--expt", default="expt/quality/overfit_flagship.yaml")
    ap.add_argument("--out", default=None,
                    help="the result JSON (default: <run_dir>/quality.json)")
    ap.add_argument("--before-epochs", type=int, default=1)
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--overrides", default=None,
                    help="JSON merged over the YAML for every command "
                    "(e.g. to redirect serialization_dir and shards_dir)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--resume", action="store_true",
                    help="skip the phases journaled in "
                    "<run_dir>/quality-phases.json")
    args = ap.parse_args(argv)
    t0 = time.time()
    result = run(args)
    result["wall_seconds"] = round(time.time() - t0, 1)
    exp = load_experiment(args.expt, args.overrides)
    out = args.out or os.path.join(exp.trainer.serialization_dir,
                                   "quality.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({
        "cider_before": result["before"].get("cider"),
        "cider_after_beam": result["after_beam"].get("cider"),
        "reproduction_after_beam":
            result["after_beam"]["caption_reproduction_exact"],
        "ab_kv8": result["ab_kv8"]["caption_agreement_vs_default"],
        "ab_fused_topk":
            result["ab_fused_topk"]["caption_agreement_vs_default"],
        "ab_fast_gelu":
            result["ab_fast_gelu"]["caption_agreement_vs_default"],
        "wall_seconds": result["wall_seconds"], "out": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
