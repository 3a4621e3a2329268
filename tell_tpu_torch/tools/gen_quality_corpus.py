"""The quality corpus's feature files (counterpart of the part of
tools/gen_quality_corpus.py that `--features-only` runs): per-image object
features (objects.jsonl) and 49 x 2048 image grids (grids/<hash>.npy) for
the committed tests/fixtures/quality/articles.jsonl, a pure function of
the seed and each image's hash, byte for byte the JAX tool's.

    python -m tell_tpu_torch.tools.gen_quality_corpus --out DIR \\
        [--articles tests/fixtures/quality/articles.jsonl] [--seed 7]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

FEATURES_SEED = 7   # tools/gen_quality_corpus.py's default --seed


def write_features(arts: list[dict], out: str, seed: int) -> None:
    """Per-hash object features and image grids, seeded by the hash's
    index (qh<i>), so every regeneration writes the same bytes."""
    os.makedirs(os.path.join(out, "grids"), exist_ok=True)
    with open(os.path.join(out, "objects.jsonl"), "w") as f:
        for a in arts:
            for s in a["parsed_section"]:
                if s["type"] != "caption":
                    continue
                h = s["hash"]
                r = np.random.default_rng(seed * 100003
                                          + int(h.removeprefix("qh")))
                feats = r.standard_normal((6, 2048)).astype(np.float32)
                f.write(json.dumps(
                    {"hash": h,
                     "object_features": np.round(feats, 3).tolist()}) + "\n")
                grid = r.standard_normal((49, 2048)).astype(np.float16)
                np.save(os.path.join(out, "grids", f"{h}.npy"), grid)


def read_articles(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="where objects.jsonl and grids/ go")
    ap.add_argument("--articles", default=None,
                    help="articles.jsonl (default: <out>/articles.jsonl)")
    ap.add_argument("--seed", type=int, default=FEATURES_SEED)
    args = ap.parse_args(argv)
    arts = read_articles(args.articles
                         or os.path.join(args.out, "articles.jsonl"))
    write_features(arts, args.out, args.seed)
    print(json.dumps({"articles": len(arts), "features": "regenerated"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
