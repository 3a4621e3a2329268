#!/usr/bin/env python
"""Convert what tell_tpu wrote with orbax into what tell_tpu_torch reads.

    python migrate/orbax_to_torch.py run SERIALIZATION_DIR [--out DIR]
    python migrate/orbax_to_torch.py towers TOWERS_DIR [--out DIR]

`run`: every numbered checkpoint (`ckpt-<tag>/`) and `best/` under
SERIALIZATION_DIR/checkpoints (or under SERIALIZATION_DIR itself when it
is a checkpoints directory), as tell_tpu/training/checkpoint.py writes
them, becomes the port's `state.pt` + `meta.json`
(tell_tpu_torch/training/checkpoint.py's layout): the params, and for a
numbered checkpoint the BertAdam state {"step", "m", "v"}, every dtype
kept (bf16 leaves too); meta.json carries step, epoch, batch_cursor,
best_metric and bad_epochs over (best/'s epoch and metric). Then `python
-m tell_tpu_torch.commands train CFG -r`, `evaluate`, `serve` and a
`warm_start` read the run.

`towers`: each tower directory tools/convert_towers.py saved (roberta,
resnet152, mtcnn, facenet, yolov3) becomes `<out>/<name>/state.pt`, the
tree tell_tpu_torch/tools/convert_towers.py writes for the same weights.
A `vit` tower is refused by name: the port has no ViT (ROADMAP queue 1
item 8, cut 4).

Without --out the files are written next to the orbax ones, which stay
(tell_tpu reads the directory as before). This script needs JAX and orbax
(orbax.checkpoint.PyTreeCheckpointer reads the trees, with no template) and
PyTorch, so it runs where tell_tpu runs: on a CPU box with the JAX
package's dependencies, not on the card's machine, which has no JAX. It
imports nothing of tell_tpu; the trees go through tell_tpu_torch.bridge.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TOWERS = ("roberta", "resnet152", "mtcnn", "facenet", "yolov3")
META_KEYS = ("step", "epoch", "batch_cursor", "best_metric", "bad_epochs",
             "metric")


def restore(path: str):
    """The orbax tree at `path`, untemplated, with numpy leaves."""
    import jax
    import orbax.checkpoint as ocp
    tree = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    from tell_tpu_torch.bridge import to_torch
    return to_torch(tree, "cpu")


def bert_adam(opt) -> dict:
    """tell_tpu's BertAdamState as an untemplated restore gives it (a dict
    of step/m/v, or a (step, m, v) list) -> the port's {"step", "m",
    "v"}."""
    from tell_tpu_torch.bridge import bert_adam_state
    if isinstance(opt, dict):
        if set(opt) != {"step", "m", "v"}:
            raise ValueError(f"an optimizer state with keys {sorted(opt)}: "
                             "not tell_tpu's BertAdamState (step, m, v)")
        opt = (opt["step"], opt["m"], opt["v"])
    if not isinstance(opt, (list, tuple)) or len(opt) != 3:
        raise ValueError("the optimizer state is not tell_tpu's "
                         "BertAdamState (step, m, v)")
    return bert_adam_state(tuple(opt), "cpu")._asdict()


def _save(state: dict, meta: dict, dst: str) -> str:
    """state.pt and meta.json in dst, each written to a temporary name and
    renamed into place."""
    import torch
    os.makedirs(dst, exist_ok=True)
    tmp = os.path.join(dst, f"state.pt.tmp-{os.getpid()}")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(dst, "state.pt"))
    with open(os.path.join(dst, f"meta.json.tmp-{os.getpid()}"), "w") as f:
        json.dump(meta, f)
    os.replace(os.path.join(dst, f"meta.json.tmp-{os.getpid()}"),
               os.path.join(dst, "meta.json"))
    return dst


def convert_checkpoint(src: str, dst: str) -> str:
    """One tell_tpu checkpoint directory (numbered or best/) -> the port's
    state.pt + meta.json in dst."""
    tree = restore(src)
    if "params" not in tree:
        raise ValueError(f"{src}: no params in the checkpoint (keys "
                         f"{sorted(tree)})")
    state = {"params": _torch(tree["params"])}
    if "opt" in tree:
        state["opt"] = bert_adam(tree["opt"])
    meta = {}
    meta_path = os.path.join(src, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = {k: v for k, v in json.load(f).items() if k in META_KEYS}
    return _save(state, meta, dst)


def _checkpoints_dir(src: str) -> str:
    inner = os.path.join(src, "checkpoints")
    return inner if os.path.isdir(inner) else src


def convert_run(src: str, out: str | None = None) -> list[str]:
    """Every ckpt-<tag>/ and best/ of a tell_tpu run; returns the
    directories written."""
    ckpts = _checkpoints_dir(src)
    dst_root = ckpts if out is None else (
        os.path.join(out, "checkpoints") if ckpts != src else out)
    names = sorted(n for n in os.listdir(ckpts)
                   if (n.startswith("ckpt-") and n[5:].isdigit())
                   or n == "best")
    if not names:
        raise FileNotFoundError(f"{ckpts}: no ckpt-<tag>/ or best/ "
                                "checkpoint of tell_tpu's")
    return [convert_checkpoint(os.path.join(ckpts, n),
                               os.path.join(dst_root, n)) for n in names]


def _yolov3(tree: dict) -> dict:
    """orbax gives the convs' int keys back as strings."""
    return {"convs": {int(k): v for k, v in tree["convs"].items()}}


def convert_towers(src: str, out: str | None = None) -> list[str]:
    """Each tower directory of tools/convert_towers.py's --out; returns the
    state.pt files written. A vit directory is refused by name."""
    import torch

    from tell_tpu_torch.config import NotPortedError
    if os.path.isdir(os.path.join(src, "vit")):
        raise NotPortedError(
            f"{os.path.join(src, 'vit')}: the port has no ViT tower "
            "(ROADMAP queue 1 item 8, cut 4); move it aside to convert the "
            "others")
    out = src if out is None else out
    written = []
    for name in TOWERS:
        path = os.path.join(src, name)
        if not os.path.isdir(path):
            continue
        tree = restore(path)
        if name == "yolov3":
            tree = _yolov3(tree)
        dst = os.path.join(out, name)
        os.makedirs(dst, exist_ok=True)
        tmp = os.path.join(dst, f"state.pt.tmp-{os.getpid()}")
        torch.save(_torch(tree), tmp)
        os.replace(tmp, os.path.join(dst, "state.pt"))
        written.append(os.path.join(dst, "state.pt"))
    if not written:
        raise FileNotFoundError(f"{src}: none of {', '.join(TOWERS)}")
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=["run", "towers"])
    ap.add_argument("src", help="a tell_tpu serialization dir (run) or "
                    "tools/convert_towers.py's --out (towers)")
    ap.add_argument("--out", default=None,
                    help="where to write (default: next to the orbax files)")
    args = ap.parse_args(argv)
    fn = convert_run if args.what == "run" else convert_towers
    for path in fn(args.src, args.out):
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
