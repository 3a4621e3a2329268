"""ResNet image tower, frozen (counterpart of
tell_tpu/models/backbones/resnet.py).

`pool=False` gives the [B, 49, 2048] 7x7 grid that is the captioner's image
context; `pool=True` the average-pooled [B, 2048] vector. Input is NHWC
[B, H, W, 3], ImageNet-normalised (preprocess_image). The parameter tree is
tell_tpu's key for key: conv weights HWIO, frozen batch norm folded into
per-channel `scale` / `bias`; `convert_torchvision_resnet` maps a
torchvision state dict onto it with the same numpy operations, so the two
packages' trees are equal bit for bit.

The convs are cuDNN's (F.conv2d): tell_tpu runs them in XLA, outside any
Pallas kernel. They run on NCHW activations with OIHW weights, the layout
`prepare_resnet` makes once where the tower is loaded (load_tower);
resnet_forward takes only that layout. The forward pins fp32 itself
(fp32_math: the TF32 switches are off while it runs and restored after),
since PyTorch's default lets cuDNN use TF32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import fp32_math, load_state


@dataclass(frozen=True)
class ResNetConfig:
    block_counts: tuple[int, ...] = (3, 8, 36, 3)  # resnet152
    width: int = 64
    bn_eps: float = 1e-5

    @staticmethod
    def resnet152() -> "ResNetConfig":
        return ResNetConfig((3, 8, 36, 3))

    @staticmethod
    def resnet50() -> "ResNetConfig":
        return ResNetConfig((3, 4, 6, 3))

    @property
    def out_dim(self) -> int:
        return self.width * 8 * 4  # 2048 for width 64


def _prepare(tree):
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            return {k: v.reshape(-1, 1, 1) for k, v in tree.items()}
        return {k: _prepare(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_prepare(v) for v in tree]
    return tree.permute(3, 2, 0, 1).contiguous()


def prepare_resnet(params: dict) -> dict:
    """The HWIO tree (torch leaves) in the forward's layout: each conv
    weight OIHW, each scale / bias [C, 1, 1]. Made once, where the tower
    is loaded."""
    return _prepare(params)


def _conv(x, w, stride=1):
    # symmetric k//2 padding, as torchvision pads (XLA's "SAME" would pad
    # asymmetrically for even inputs under stride 2)
    return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)


def _bn(p, x):
    return x * p["scale"] + p["bias"]


def _bottleneck(bp: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """torchvision v1.5 bottleneck: the stride lives on the 3x3 conv."""
    identity = x
    h = torch.relu(_bn(bp["bn1"], _conv(x, bp["conv1"])))
    h = torch.relu(_bn(bp["bn2"], _conv(h, bp["conv2"], stride)))
    h = _bn(bp["bn3"], _conv(h, bp["conv3"]))
    if "down_conv" in bp:
        identity = _bn(bp["down_bn"], _conv(x, bp["down_conv"], stride))
    return torch.relu(h + identity)


def resnet_forward(params, cfg: ResNetConfig, x: torch.Tensor,
                   pool: bool = False) -> torch.Tensor:
    """x: [B, H, W, 3] -> grid [B, h*w, out_dim] or pooled [B, out_dim].
    params: prepare_resnet's tree."""
    w0 = params["stem"]["conv"]
    h = x.to(w0.dtype).permute(0, 3, 1, 2).contiguous()
    with fp32_math():
        h = torch.relu(_bn(params["stem"]["bn"], _conv(h, w0, stride=2)))
        h = F.max_pool2d(h, 3, 2, 1)       # 3x3, stride 2, -inf padding 1
        for s, stage in enumerate(params["stages"]):
            for b, block in enumerate(stage):
                h = _bottleneck(block, h, 2 if (s > 0 and b == 0) else 1)
    if pool:
        return h.mean(dim=(2, 3))
    B, C = h.shape[:2]
    return h.permute(0, 2, 3, 1).reshape(B, -1, C)


def image_grid(params, cfg: ResNetConfig, img224: np.ndarray) -> np.ndarray:
    """One centre-cropped photo, float [224, 224, 3] in 0..255 (numpy),
    -> its [49, out_dim] grid, computed on the weights' device (params:
    prepare_resnet's tree)."""
    device = params["stem"]["conv"].device
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(img224, np.float32))
        x = preprocess_image(x.to(device)[None] / 255.0)
        return resnet_forward(params, cfg, x)[0].float().cpu().numpy()


def load_tower(path: str, device) -> dict:
    """The HWIO tree at <path>/state.pt (as tools/convert_towers.py writes
    it) on `device`, in the forward's layout (prepare_resnet). A directory
    without one (a tell_tpu orbax tree) is refused."""
    return prepare_resnet(load_state(path, device, "--resnet"))


def preprocess_image(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB -> ImageNet-normalised (torchvision's Normalize)."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=img.dtype,
                        device=img.device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=img.dtype,
                       device=img.device)
    return (img - mean) / std


def convert_torchvision_resnet(state_dict: dict, cfg: ResNetConfig) -> dict:
    """torchvision state dict -> the HWIO tree (numpy leaves in the state
    dict's dtype), frozen batch norm folded: scale = g / sqrt(var + eps),
    bias = beta - mean * scale, the numpy operations of tell_tpu's
    converter."""
    def t(name):
        v = state_dict[name]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    def conv(name):
        return np.ascontiguousarray(t(name + ".weight").transpose(2, 3, 1, 0))

    def bn(name):
        g, b = t(name + ".weight"), t(name + ".bias")
        mean, var = t(name + ".running_mean"), t(name + ".running_var")
        scale = g / np.sqrt(var + cfg.bn_eps)
        return {"scale": scale, "bias": b - mean * scale}

    params = {"stem": {"conv": conv("conv1"), "bn": bn("bn1")}, "stages": []}
    for s, n_blocks in enumerate(cfg.block_counts):
        stage = []
        for bidx in range(n_blocks):
            pre = f"layer{s + 1}.{bidx}."
            block = {
                "conv1": conv(pre + "conv1"), "bn1": bn(pre + "bn1"),
                "conv2": conv(pre + "conv2"), "bn2": bn(pre + "bn2"),
                "conv3": conv(pre + "conv3"), "bn3": bn(pre + "bn3"),
            }
            if (pre + "downsample.0.weight") in state_dict:
                block["down_conv"] = conv(pre + "downsample.0")
                block["down_bn"] = bn(pre + "downsample.1")
            stage.append(block)
        params["stages"].append(stage)
    return params
