"""`python -m tell_tpu_torch.commands towers verify <dir>`: the frozen
towers' conversion smoke path (counterpart of tell_tpu/commands/towers.py).

Each converted tower at <dir>/<name>/state.pt (python -m
tell_tpu_torch.tools.convert_towers, or migrate/orbax_to_torch.py towers)
is loaded through the port's loader onto `device`, tell_tpu's probe input
goes through it, and a row per tower gives its parameter count, the probe
outputs' shapes and an activation checksum (tell_tpu's `_checksum`: sha256
over each output's shape and its values rounded to 1e-3). The probes,
shapes and row schema (tower, status, params, outputs, checksum) are
tell_tpu's; the inputs are its jax.random draws, made in numpy
(commands/jax_random.py): ids equal, normals within 1e-6.

The two packages' checksums of one tower need not agree: a value within
fp32 noise of a rounding boundary flips the digest (RoBERTa's probe alone
has 409,600 outputs). Compare outputs by tolerance, not digests.

Without a checkpoint resnet152, roberta, vit and yolov3 fall back to
random init (the port's bridge.init_*, not JAX's numbers) and are marked
UNVERIFIED (random init); facenet and mtcnn report NO CHECKPOINT. A tree
that fails to load or probe is an ERROR row and the exit code is 1.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from . import jax_random

INIT_SEED = 0
# python -m tell_tpu_torch.tools.convert_towers' flag for each tower
CONVERT_FLAGS = {"resnet152": "--resnet", "roberta": "--roberta",
                 "facenet": "--facenet", "mtcnn": "--mtcnn PNET RNET ONET",
                 "yolov3": "--yolo-cfg CFG --yolo-weights W",
                 "vit": "--vit STATE_DICT.pt"}


def _checksum(*arrays) -> str:
    """tell_tpu's _checksum, unchanged."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.asarray(a, np.float64)
        h.update(str(a.shape).encode())
        # round so fp32 reassociation noise across backends doesn't flip
        # the digest; 1e-3 absolute is far below any real weight change
        h.update(np.round(a, 3).tobytes())
    return h.hexdigest()[:16]


def _param_count(tree) -> int:
    from ..bridge import tree_leaves
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree)
               if hasattr(x, "shape"))


def probe_inputs() -> dict:
    """tell_tpu's probe inputs (jax.random with PRNGKey(1)), numpy."""
    k = jax_random.prng_key(1)
    return {"resnet152": jax_random.normal(k, (1, 224, 224, 3)),
            "roberta": jax_random.randint(k, (1, 16), 4, 1000),
            "vit": jax_random.normal(k, (1, 224, 224, 3)),
            "facenet": jax_random.normal(k, (1, 160, 160, 3)),
            "pnet": jax_random.normal(k, (1, 12, 12, 3)),
            "rnet": jax_random.normal(k, (1, 24, 24, 3)),
            "onet": jax_random.normal(k, (1, 48, 48, 3)),
            "yolov3": jax_random.normal(k, (1, 128, 128, 3))}


def _load(dir_: str, name: str, device):
    """The raw tree at <dir>/<name>/state.pt on `device`, or None where
    the directory does not exist."""
    path = os.path.join(dir_, name)
    if not os.path.isdir(path):
        return None
    from ..models.backbones import load_state
    return load_state(path, device, CONVERT_FLAGS[name])


def _t(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _probe_resnet(tree, x, device):
    from ..bridge import init_resnet
    from ..models.backbones.resnet import (ResNetConfig, prepare_resnet,
                                           resnet_forward)
    cfg = ResNetConfig.resnet152()
    status = "CONVERTED"
    if tree is None:
        tree = init_resnet(torch.Generator().manual_seed(INIT_SEED), cfg)
        tree = _to(tree, device)
        status = "UNVERIFIED (random init)"
    p = prepare_resnet(tree)
    with torch.inference_mode():
        xx = _t(x["resnet152"], device)
        outs = {"grid": resnet_forward(p, cfg, xx, pool=False),
                "pooled": resnet_forward(p, cfg, xx, pool=True)}
    return status, tree, outs


def _probe_roberta(tree, x, device):
    from ..bridge import init_roberta
    from ..models.backbones.roberta import RobertaConfig, roberta_encode
    cfg = RobertaConfig.large()
    status = "CONVERTED"
    if tree is None:
        tree = _to(init_roberta(torch.Generator().manual_seed(INIT_SEED),
                                cfg), device)
        status = "UNVERIFIED (random init)"
    with torch.inference_mode():
        h = roberta_encode(tree, cfg, _t(x["roberta"], device).long(),
                           return_all_hiddens=True)
    return status, tree, {"hiddens": h}


def _probe_vit(tree, x, device):
    from ..bridge import init_vit
    from ..models.backbones.vit import ViTConfig, vit_encode
    cfg = ViTConfig()
    status = "CONVERTED"
    if tree is None:
        tree = _to(init_vit(torch.Generator().manual_seed(INIT_SEED), cfg),
                   device)
        status = "UNVERIFIED (random init)"
    with torch.inference_mode():
        out = vit_encode(tree, cfg, _t(x["vit"], device))
    return status, tree, {"features": out}


def _probe_yolov3(tree, x, device):
    from ..bridge import init_yolov3
    from ..models.backbones.yolov3 import (prepare_yolov3, yolov3_forward,
                                           yolov3_spp_module_defs)
    defs = yolov3_spp_module_defs()
    status = "CONVERTED"
    if tree is None:
        tree = _to(init_yolov3(torch.Generator().manual_seed(INIT_SEED),
                               defs), device)
        status = "UNVERIFIED (random init)"
    with torch.inference_mode():
        out = yolov3_forward(prepare_yolov3(tree), defs,
                             _t(x["yolov3"], device))
    return status, tree, {"preds": out}


def _probe_facenet(tree, x, device):
    from ..models.backbones.facenet import facenet_forward, prepare_facenet
    if tree is None:
        return "NO CHECKPOINT (converter-only tower)", None, {}
    with torch.inference_mode():
        emb = facenet_forward(prepare_facenet(tree), _t(x["facenet"], device))
    return "CONVERTED", tree, {"embedding": emb}


def _probe_mtcnn(tree, x, device):
    from ..models.backbones.mtcnn import (onet_forward, pnet_forward,
                                          prepare_mtcnn, rnet_forward)
    if tree is None:
        return "NO CHECKPOINT (converter-only tower)", None, {}
    p = prepare_mtcnn(tree)
    nchw = lambda a: _t(a, device).permute(0, 3, 1, 2).contiguous()  # noqa: E731
    with torch.inference_mode():
        outs = {"pnet": pnet_forward(p["pnet"], nchw(x["pnet"]))[0],
                "rnet": rnet_forward(p["rnet"], nchw(x["rnet"]))[0],
                "onet": onet_forward(p["onet"], nchw(x["onet"]))[0]}
    return "CONVERTED", tree, outs


def _to(tree, device):
    from ..bridge import tree_map
    return tree_map(lambda t: t.to(device), tree)


PROBES = {
    "resnet152": _probe_resnet,
    "roberta": _probe_roberta,
    "facenet": _probe_facenet,
    "mtcnn": _probe_mtcnn,
    "yolov3": _probe_yolov3,
    "vit": _probe_vit,
}


def probe_outputs(dir_: str, name: str, device="cpu") -> tuple:
    """(status, tree, {output: numpy array}) of one tower's probe."""
    status, tree, outs = PROBES[name](_load(dir_, name, device),
                                      probe_inputs(), device)
    return status, tree, {k: v.float().cpu().numpy() for k, v in outs.items()}


def rows(dir_: str, towers: list[str] | None = None, device="cpu"
         ) -> list[dict]:
    """tell_tpu's verify rows for the towers (default: all of PROBES)."""
    out = []
    for name in towers or list(PROBES):
        if name not in PROBES:
            out.append({"tower": name, "status": f"ERROR: no tower {name!r}"})
            continue
        try:
            status, tree, outs = probe_outputs(dir_, name, device)
        except Exception as e:  # a broken checkpoint should not stop others
            out.append({"tower": name, "status": f"ERROR: {e}"})
            continue
        row = {"tower": name, "status": status}
        if tree is not None:
            row["params"] = _param_count(tree)
            row["outputs"] = {k: list(v.shape) for k, v in outs.items()}
            row["checksum"] = _checksum(*outs.values())
        out.append(row)
    return out


def verify(dir_: str, towers: list[str] | None = None,
           as_json: bool = False, device="cuda") -> int:
    """Print the rows (a table, or JSON); 0 unless a row is an ERROR."""
    table = rows(dir_, towers, device)
    if as_json:
        print(json.dumps(table, indent=1))
    else:
        for r in table:
            pc = f"{r['params'] / 1e6:8.1f}M" if "params" in r else " " * 9
            shapes = " ".join(f"{k}{tuple(s)}"
                              for k, s in r.get("outputs", {}).items())
            print(f"{r['tower']:<10} {pc} {r.get('checksum', ''):<16} "
                  f"{r['status']}  {shapes}")
        if any("UNVERIFIED" in r["status"] or "NO CHECKPOINT" in r["status"]
               for r in table):
            print("\nNOTE: towers without a converted checkpoint are NOT "
                  "validated against pretrained weights. Convert with "
                  "python -m tell_tpu_torch.tools.convert_towers (or "
                  "migrate/orbax_to_torch.py towers for tell_tpu's), then "
                  "compare checksums with docs/towers.md.")
    return 0 if all("ERROR" not in r["status"] for r in table) else 1
