"""ViT-L/16 image tower, frozen (counterpart of
tell_tpu/models/backbones/vit.py: ViTConfig, patchify, vit_encode and
convert_hf_vit).

The modern family's image context: [B, 1 + (224/16)^2, 1024] tokens (CLS
and the 14x14 patch grid) in place of ResNet-152's 7x7 grid. Input is
NHWC [B, H, W, 3], already normalised. Pre-LN blocks, exact (erf) GELU,
LayerNorm eps 1e-12, statistics in fp32. patchify flattens each patch
(row, col, channel), the order convert_hf_vit gives the HF conv weight by
the permutation (2, 3, 1, 0). The attention is a plain fp32 matmul and
softmax, as in tell_tpu (an einsum there, not a Pallas kernel), and the
forward pins fp32 itself (fp32_math), as the ResNet tower does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import fp32_math, load_state


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    ln_eps: float = 1e-12

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return 1 + self.grid * self.grid

    @staticmethod
    def large() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def tiny() -> "ViTConfig":
        """Smoke-test tower; the feature dim stays 1024 so decoder
        configs built for ViT-L are unchanged."""
        return ViTConfig(image_size=32, patch_size=16, dim=1024,
                         num_layers=2, num_heads=16, ffn_dim=1024)


def _ln(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def _lin(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (torch.matmul(x, p["w"]).float() + p["b"]).to(x.dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] NHWC -> [B, (H/P)*(W/P), P*P*3], each patch flattened
    row-major with the channels minor."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def vit_encode(params: dict, cfg: ViTConfig, images: torch.Tensor
               ) -> torch.Tensor:
    """images [B, H, W, 3] (normalised) -> tokens [B, 1 + grid^2, D]."""
    with fp32_math():
        return _vit_encode(params, cfg, images)


def _vit_encode(params, cfg, images):
    B = images.shape[0]
    x = _lin(params["patch_embed"], patchify(images, cfg.patch_size))
    cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)[None]
    H = cfg.num_heads
    hd = cfg.dim // H
    S = x.shape[1]
    for lp in params["layers"]:
        h = _ln(lp["ln1"], x, cfg.ln_eps)
        q = _lin(lp["q"], h).reshape(B, S, H, hd).transpose(1, 2)
        k = _lin(lp["k"], h).reshape(B, S, H, hd).transpose(1, 2)
        v = _lin(lp["v"], h).reshape(B, S, H, hd).transpose(1, 2)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * (hd ** -0.5)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o = torch.matmul(probs, v).float().transpose(1, 2)
        x = x + _lin(lp["attn_out"], o.reshape(B, S, cfg.dim).to(x.dtype))
        h = _ln(lp["ln2"], x, cfg.ln_eps)
        h = F.gelu(_lin(lp["fc1"], h).float()).to(x.dtype)
        x = x + _lin(lp["fc2"], h)
    return _ln(params["final_ln"], x, cfg.ln_eps)


def load_vit(path: str, device) -> dict:
    """A converted ViT tower (towers/vit/state.pt, convert_towers --vit)
    on `device`."""
    return load_state(path, device, "--vit STATE_DICT.pt")


def convert_hf_vit(state_dict: dict, cfg: ViTConfig) -> dict:
    """A HuggingFace ViTModel (bare keys) or ViTForImageClassification
    (`vit.`-prefixed) state dict -> the tower's tree, numpy fp32, with
    tell_tpu's layout: dense weights [in, out], the patch conv
    [D, 3, P, P] as [P*P*3, D] in patchify's order."""
    def get(name):
        for key in (name, "vit." + name):
            if key in state_dict:
                t = state_dict[key]
                t = t.detach().cpu().float().numpy() \
                    if isinstance(t, torch.Tensor) else np.asarray(t)
                return np.asarray(t, np.float32)
        raise KeyError(name)

    def dense(name):
        return {"w": np.ascontiguousarray(get(name + ".weight").T),
                "b": get(name + ".bias")}

    def ln(name):
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias")}

    pw = get("embeddings.patch_embeddings.projection.weight")
    params = {
        "patch_embed": {
            "w": np.ascontiguousarray(
                pw.transpose(2, 3, 1, 0).reshape(-1, pw.shape[0])),
            "b": get("embeddings.patch_embeddings.projection.bias")},
        "cls_token": get("embeddings.cls_token").reshape(-1),
        "pos_embed": get("embeddings.position_embeddings")[0],
        "layers": [],
        "final_ln": ln("layernorm"),
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}."
        params["layers"].append({
            "ln1": ln(pre + "layernorm_before"),
            "q": dense(pre + "attention.attention.query"),
            "k": dense(pre + "attention.attention.key"),
            "v": dense(pre + "attention.attention.value"),
            "attn_out": dense(pre + "attention.output.dense"),
            "ln2": ln(pre + "layernorm_after"),
            "fc1": dense(pre + "intermediate.dense"),
            "fc2": dense(pre + "output.dense"),
        })
    return params
