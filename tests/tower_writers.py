"""Foreign weight files written from a vision tower's tree, the inverses of
the port's converters: facenet-pytorch's InceptionResnetV1 and MTCNN
state dicts (convert_facenet, convert_mtcnn) and darknet's .cfg and
.weights (parse_darknet_cfg, load_darknet_weights).

The trees are tell_tpu's layout (HWIO convs, [in, out] dense weights), as
numpy arrays or CPU tensors. Imports neither JAX nor the JAX package, so
chip_smoke.py uses it too."""
import numpy as np
import torch

FACENET_BN_EPS = 1e-3
DARKNET_BN_EPS = 1e-5


def _oihw(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def facenet_pytorch_state(tree: dict, rng=None) -> dict:
    """facenet-pytorch's InceptionResnetV1 names for the tree: OIHW convs,
    last_linear [out, in]. Batch norm as weight = scale, bias, running mean
    0 and variance 1 - eps (convert_facenet folds it back within one
    rounding); with a numpy Generator `rng`, random weight, bias, mean and
    variance instead, drawn in that order for each batch norm."""
    sd = {}

    def bn(prefix, node):
        scale = np.asarray(node["scale"])
        if rng is None:
            parts = (scale, np.asarray(node["bias"]), np.zeros_like(scale),
                     np.full_like(scale, 1 - FACENET_BN_EPS))
        else:
            c = scale.shape[0]
            parts = [rng.uniform(0.5, 1.5, c), rng.normal(0, 0.1, c),
                     rng.normal(0, 0.1, c), rng.uniform(0.5, 2.0, c)]
        for name, v in zip(("weight", "bias", "running_mean",
                            "running_var"), parts):
            sd[f"{prefix}.{name}"] = np.asarray(v, np.float32)
        sd[prefix + ".num_batches_tracked"] = np.int64(0)

    def walk(prefix, node):
        if "conv" in node:
            sd[prefix + ".conv.weight"] = _oihw(node["conv"])
            bn(prefix + ".bn", node)
        elif "w" in node:
            sd[prefix + ".weight"] = _oihw(node["w"])
            sd[prefix + ".bias"] = np.asarray(node["b"])
        else:
            for k, v in node.items():
                walk(f"{prefix}.{k}", v)

    for k, v in tree.items():
        if k == "last_linear":
            sd["last_linear.weight"] = np.ascontiguousarray(np.asarray(v).T)
        elif k == "last_bn":
            bn("last_bn", v)
        elif isinstance(v, list):
            for i, block in enumerate(v):
                walk(f"{k}.{i}", block)
        else:
            walk(k, v)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def mtcnn_states(tree: dict) -> tuple[dict, dict, dict]:
    """facenet-pytorch's pnet, rnet and onet state dicts for the tree
    (OIHW convs, [out, in] dense weights, PReLU slopes as they are)."""
    sds = []
    for net in ("pnet", "rnet", "onet"):
        sd = {}
        for name, v in tree[net].items():
            if name.startswith("prelu"):
                sd[name + ".weight"] = np.asarray(v)
            elif name.startswith("conv"):
                sd[name + ".weight"] = _oihw(v[0])
                sd[name + ".bias"] = np.asarray(v[1])
            else:
                sd[name + ".weight"] = np.asarray(v[0]).T
                sd[name + ".bias"] = np.asarray(v[1])
        sds.append({k: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    return tuple(sds)


def darknet_cfg(defs, anchors) -> str:
    """The darknet .cfg text of the module defs."""
    lines = ["[net]", "width=416", "height=416", "channels=3"]
    anchor_text = ", ".join(f"{w},{h}" for w, h in anchors)
    for d in defs:
        lines.append(f"[{d['type']}]")
        if d["type"] == "convolutional":
            if d["bn"]:
                lines.append("batch_normalize=1")
            lines += [f"filters={d['filters']}", f"size={d['size']}",
                      f"stride={d['stride']}", "pad=1",
                      f"activation={d['activation']}"]
        elif d["type"] == "shortcut":
            lines += [f"from={d['from']}", "activation=linear"]
        elif d["type"] == "maxpool":
            lines += [f"size={d['size']}", f"stride={d['stride']}"]
        elif d["type"] == "route":
            lines.append("layers=" + ",".join(map(str, d["layers"])))
        elif d["type"] == "upsample":
            lines.append(f"stride={d['stride']}")
        elif d["type"] == "yolo":
            lines += ["mask=" + ",".join(map(str, d["mask"])),
                      f"anchors={anchor_text}", f"classes={d['classes']}",
                      "num=9"]
    return "\n".join(lines) + "\n"


def darknet_parts(tree: dict) -> list[np.ndarray]:
    """The tree's convs in .weights order: batch norm as beta = bias,
    gamma = scale, mean 0 and variance 1 - darknet's eps (else the conv
    bias), then the OIHW kernel."""
    parts = []
    for i in sorted(tree["convs"]):
        p = {k: np.asarray(v) for k, v in tree["convs"][i].items()}
        if "scale" in p:
            parts += [p["bias"], p["scale"], np.zeros_like(p["scale"]),
                      np.full_like(p["scale"], 1 - DARKNET_BN_EPS)]
        else:
            parts.append(p["b"])
        parts.append(p["w"].transpose(3, 2, 0, 1))
    return parts


def write_darknet_weights(path: str, parts, version=(0, 2, 5),
                          seen: int = 0) -> None:
    """A .weights file: the version, the "seen" count (int64 from version
    0.2, int32 before), then the parts as float32."""
    with open(path, "wb") as f:
        np.asarray(version, np.int32).tofile(f)
        np.asarray([seen], np.int64 if version[1] >= 2 else np.int32).tofile(f)
        np.concatenate([np.ravel(p) for p in parts]).astype(
            np.float32).tofile(f)
