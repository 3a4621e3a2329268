"""JAX's linear `scale_and_translate` and `resize` (antialias on), as the
detectors use them (counterpart of jax.image, which tell_tpu's MTCNN
pyramid and crop_and_resize call).

`F.interpolate(..., antialias=True)` is another function, so the weight
matrix is JAX's own (jax/_src/image/scale.py, compute_weight_mat): output
pixel i samples the input at ``(i + 0.5) * inv_scale - translation *
inv_scale - 0.5``; the triangle kernel is widened by ``max(inv_scale, 1)``;
each column is normalised to sum 1, and one whose weights sum to about 0
(|sum| <= 1000 fp32 eps) gives 0; a sample outside [-0.5, in - 0.5] gives
0. Everything is fp32, as under JAX's default 32-bit mode. An image is then
two matrix products, one per spatial axis, batched over the boxes of a
crop. Scales come from data: a degenerate box's 1e-6 gives finite weights,
never NaN or inf.
"""
from __future__ import annotations

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


def weight_matrix(in_size: int, out_size: int, scale: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """scale, translation: fp32 [...] -> the weights [..., in_size,
    out_size] (JAX's compute_weight_mat with the triangle kernel and
    antialias)."""
    dev = scale.device
    inv_scale = (1.0 / scale)[..., None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5) * inv_scale - translation[..., None] * inv_scale
                - 0.5)                                        # [..., out]
    pos = torch.arange(in_size, dtype=torch.float32, device=dev)[:, None]
    x = (sample_f[..., None, :] - pos).abs() / kernel_scale[..., None]
    w = torch.clamp(1.0 - x.abs(), min=0.0)                  # [..., in, out]
    total = w.sum(dim=-2, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros((), device=dev))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None, :], w, torch.zeros((), device=dev))


def scale_and_translate(image: torch.Tensor, out_h: int, out_w: int,
                        scale: torch.Tensor, translation: torch.Tensor
                        ) -> torch.Tensor:
    """image [H, W, C] fp32; scale, translation [B, 2] fp32 ((y, x) each,
    as jax.image.scale_and_translate's over spatial dims (0, 1)) -> [B,
    out_h, out_w, C]: the rows contracted first, then the columns, each
    a batched product over the boxes (a broadcast product would expand
    the column weights to [B, out_h, W, out_w]: 5 GB for 64 crops of 224
    from a 416 canvas)."""
    H, W, C = image.shape
    wy = weight_matrix(H, out_h, scale[:, 0], translation[:, 0])
    wx = weight_matrix(W, out_w, scale[:, 1], translation[:, 1])
    B = scale.shape[0]
    rows = wy.transpose(1, 2) @ image.reshape(H, W * C)      # [B, oh, W*C]
    rows = rows.reshape(B, out_h, W, C).transpose(2, 3)      # [B, oh, C, W]
    out = torch.bmm(rows.reshape(B, out_h * C, W), wx)      # [B, oh*C, ow]
    return out.reshape(B, out_h, C, out_w).transpose(2, 3)


def resize_linear(image: torch.Tensor, out_h: int, out_w: int
                  ) -> torch.Tensor:
    """jax.image.resize(image, (out_h, out_w, C), "linear",
    antialias=True) of an fp32 [H, W, C] image: an axis whose size stays
    is left as it is; the scale is out / in in double precision, then
    fp32, as JAX takes a Python float."""
    H, W, C = image.shape
    dev = image.device
    out = image
    if out_h != H:
        wy = weight_matrix(H, out_h, torch.tensor(out_h / H, device=dev),
                           torch.zeros((), device=dev))
        out = (wy.T @ out.reshape(H, -1)).reshape(out_h, W, C)
    if out_w != W:
        wx = weight_matrix(W, out_w, torch.tensor(out_w / W, device=dev),
                           torch.zeros((), device=dev))
        out = (out.transpose(1, 2) @ wx).transpose(1, 2)
    return out
