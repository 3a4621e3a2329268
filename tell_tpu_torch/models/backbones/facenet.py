"""FaceNet face embedder, InceptionResnetV1, frozen (counterpart of
tell_tpu/models/backbones/facenet.py).

160 x 160 prewhitened face crops -> L2-normalised 512-d embeddings, the
`faces` context. The tree is tell_tpu's: HWIO convs with their frozen batch
norm folded into scale / bias (eps 1e-3), the residual blocks' plain 1x1
convs {"w", "b"}, `last_linear` [1792, 512] and the folded `last_bn`;
`convert_facenet` maps facenet-pytorch's state dict onto it with the same
numpy operations. `prepare_facenet` makes the forward's layout (OIHW
convs, [C, 1, 1] scale / bias) once, where the tower is loaded; the
forward runs cuDNN's convs on NCHW activations and pins fp32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import fp32_math, load_state


@dataclass(frozen=True)
class FaceNetConfig:
    repeats: tuple[int, int, int] = (5, 10, 5)  # Block35 / Block17 / Block8
    bn_eps: float = 1e-3
    embed_dim: int = 512


def _basic(p, x, stride=1, padding=(0, 0)):
    h = F.conv2d(x, p["conv"], stride=stride, padding=padding)
    return torch.relu(h * p["scale"] + p["bias"])


def _plain(p, x):
    return F.conv2d(x, p["w"], p["b"])


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)       # 3 x 3, stride 2, VALID


def _block35(p, x, scale=0.17):
    b0 = _basic(p["branch0"], x)
    b1 = _basic(p["branch1.1"], _basic(p["branch1.0"], x), padding=(1, 1))
    b2 = _basic(p["branch2.2"],
                _basic(p["branch2.1"], _basic(p["branch2.0"], x),
                       padding=(1, 1)), padding=(1, 1))
    out = _plain(p["conv2d"], torch.cat([b0, b1, b2], dim=1))
    return torch.relu(out * scale + x)


def _block17(p, x, scale=0.10):
    b0 = _basic(p["branch0"], x)
    b1 = _basic(p["branch1.0"], x)
    b1 = _basic(p["branch1.1"], b1, padding=(0, 3))   # 1x7
    b1 = _basic(p["branch1.2"], b1, padding=(3, 0))   # 7x1
    out = _plain(p["conv2d"], torch.cat([b0, b1], dim=1))
    return torch.relu(out * scale + x)


def _block8(p, x, scale=0.20, relu=True):
    b0 = _basic(p["branch0"], x)
    b1 = _basic(p["branch1.0"], x)
    b1 = _basic(p["branch1.1"], b1, padding=(0, 1))   # 1x3
    b1 = _basic(p["branch1.2"], b1, padding=(1, 0))   # 3x1
    out = _plain(p["conv2d"], torch.cat([b0, b1], dim=1)) * scale + x
    return torch.relu(out) if relu else out


def _mixed6a(p, x):
    b0 = _basic(p["branch0"], x, stride=2)
    b1 = _basic(p["branch1.0"], x)
    b1 = _basic(p["branch1.1"], b1, padding=(1, 1))
    b1 = _basic(p["branch1.2"], b1, stride=2)
    return torch.cat([b0, b1, _maxpool(x)], dim=1)


def _mixed7a(p, x):
    b0 = _basic(p["branch0.1"], _basic(p["branch0.0"], x), stride=2)
    b1 = _basic(p["branch1.1"], _basic(p["branch1.0"], x), stride=2)
    b2 = _basic(p["branch2.0"], x)
    b2 = _basic(p["branch2.1"], b2, padding=(1, 1))
    b2 = _basic(p["branch2.2"], b2, stride=2)
    return torch.cat([b0, b1, b2, _maxpool(x)], dim=1)


def facenet_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, 3] prewhitened crops -> [B, 512] L2-normalised.
    params: prepare_facenet's tree."""
    h = x.permute(0, 3, 1, 2).contiguous()
    with fp32_math():
        h = _basic(params["conv2d_1a"], h, stride=2)
        h = _basic(params["conv2d_2a"], h)
        h = _basic(params["conv2d_2b"], h, padding=(1, 1))
        h = _maxpool(h)
        h = _basic(params["conv2d_3b"], h)
        h = _basic(params["conv2d_4a"], h)
        h = _basic(params["conv2d_4b"], h, stride=2)
        for bp in params["repeat_1"]:
            h = _block35(bp, h)
        h = _mixed6a(params["mixed_6a"], h)
        for bp in params["repeat_2"]:
            h = _block17(bp, h)
        h = _mixed7a(params["mixed_7a"], h)
        for bp in params["repeat_3"]:
            h = _block8(bp, h)
        h = _block8(params["block8"], h, relu=False)
        h = h.mean(dim=(2, 3))          # adaptive average pool to 1 x 1
        h = h @ params["last_linear"]
    h = h * params["last_bn"]["scale"] + params["last_bn"]["bias"]
    norm = torch.sqrt(torch.sum(h * h, dim=-1, keepdim=True))
    return h / torch.clamp(norm, min=1e-12)


def _prepare(tree, key=None):
    if isinstance(tree, dict):
        return {k: _prepare(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_prepare(v) for v in tree]
    if key in ("conv", "w"):
        return tree.permute(3, 2, 0, 1).contiguous()
    if key in ("scale", "bias"):
        return tree.reshape(-1, 1, 1)
    return tree


def prepare_facenet(params: dict) -> dict:
    """tell_tpu's tree (torch leaves) in the forward's layout: conv weights
    OIHW, the folded batch norms' scale / bias [C, 1, 1]; the plain convs'
    bias, last_linear and last_bn as they are. Made once, where the tower
    is loaded."""
    out = _prepare({k: v for k, v in params.items() if k != "last_bn"})
    out["last_bn"] = dict(params["last_bn"])
    return out


def load_facenet(path: str, device) -> dict:
    """<path>/state.pt (convert_towers --facenet) on `device`, in the
    forward's layout."""
    return prepare_facenet(load_state(path, device, "--facenet"))


def convert_facenet(state_dict: dict, cfg: FaceNetConfig) -> dict:
    """facenet-pytorch's InceptionResnetV1 state dict -> tell_tpu's tree
    (numpy leaves), batch norm folded: scale = g / sqrt(var + eps), bias =
    beta - mean * scale."""
    def t(name):
        v = state_dict[name]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    def bn(prefix):
        g, b = t(prefix + ".weight"), t(prefix + ".bias")
        mean, var = t(prefix + ".running_mean"), t(prefix + ".running_var")
        scale = g / np.sqrt(var + cfg.bn_eps)
        return {"scale": scale, "bias": b - mean * scale}

    def basic(prefix):
        return {"conv": np.ascontiguousarray(
                    t(prefix + ".conv.weight").transpose(2, 3, 1, 0)),
                **bn(prefix + ".bn")}

    def plain(prefix):
        return {"w": np.ascontiguousarray(
                    t(prefix + ".weight").transpose(2, 3, 1, 0)),
                "b": t(prefix + ".bias")}

    def block(prefix, branches):
        p = {name: basic(f"{prefix}.{name}") for name in branches}
        p["conv2d"] = plain(prefix + ".conv2d")
        return p

    b35 = ("branch0", "branch1.0", "branch1.1",
           "branch2.0", "branch2.1", "branch2.2")
    b17 = ("branch0", "branch1.0", "branch1.1", "branch1.2")

    params = {name: basic(name) for name in
              ("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b",
               "conv2d_4a", "conv2d_4b")}
    params["repeat_1"] = [block(f"repeat_1.{i}", b35)
                          for i in range(cfg.repeats[0])]
    params["mixed_6a"] = {n: basic(f"mixed_6a.{n}") for n in
                          ("branch0", "branch1.0", "branch1.1", "branch1.2")}
    params["repeat_2"] = [block(f"repeat_2.{i}", b17)
                          for i in range(cfg.repeats[1])]
    params["mixed_7a"] = {n: basic(f"mixed_7a.{n}") for n in
                          ("branch0.0", "branch0.1", "branch1.0", "branch1.1",
                           "branch2.0", "branch2.1", "branch2.2")}
    params["repeat_3"] = [block(f"repeat_3.{i}", b17)
                          for i in range(cfg.repeats[2])]
    params["block8"] = block("block8", b17)
    params["last_linear"] = np.ascontiguousarray(t("last_linear.weight").T)
    params["last_bn"] = bn("last_bn")
    return params
