"""Dynamic and lightweight convolution (counterpart of
tell_tpu/ops/dynamic_conv.py): the teacher-forced full-sequence conv of
training (dynamic_conv, fused into kernel C where tell_tpu fuses it) and
the single decode step; the lightweight conv's fixed per-head kernel in
plain torch, as tell_tpu runs it in plain XLA.

The step reads a fixed-shape window of the last K-1 inputs [B, K-1, C]
(zeros at the start, as the reference's unfold zero-pads).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dropout
from .kernels.dynamic_conv import fused_dynamic_conv
from .linear import linear


def _conv_with_weights(x: torch.Tensor, w: torch.Tensor, kernel_size: int,
                       num_heads: int) -> torch.Tensor:
    """Causal per-head conv: out[b,t,h,:] = sum_k w[b,t,h,k] *
    x[b,t-K+1+k,h,:], zeros before t = 0. x: [B, T, C]; w: [B, T, H, K]
    already normalised / dropped out, in x's dtype."""
    B, T, C = x.shape
    K, H = kernel_size, num_heads
    xh = x.reshape(B, T, H, C // H)
    out = torch.zeros_like(xh)
    for k in range(K):
        shift = K - 1 - k            # tap k looks `shift` steps back
        if shift >= T:
            continue                 # entirely before t = 0: zeros
        xs = xh if shift == 0 else F.pad(xh[:, :T - shift],
                                         (0, 0, 0, 0, shift, 0))
        out = out + w[:, :, :, k:k + 1] * xs
    return out.reshape(B, T, C)


def _can_fuse(params: dict, query, weight_dropout: float,
              deterministic: bool, num_heads: int, C: int) -> bool:
    """tell_tpu's gate (ops/dynamic_conv.py:73-85) without its device
    half: self-predicted weights, no predictor bias, no conv bias, no
    active weight dropout (the kernel is deterministic), whole heads.
    Which of kernel C and its plain version runs is the device rule of
    ops/kernels/dispatch.py, applied inside fused_dynamic_conv. The TPU
    lane condition C % 128 == 0 becomes kernel C's own: whole heads of a
    multiple of 8 channels (it loads a head's channels in 16-byte
    pieces)."""
    return (query is None
            and "b" not in params["weight_linear"]
            and "conv_bias" not in params
            and (deterministic or weight_dropout == 0.0)
            and C % num_heads == 0 and (C // num_heads) % 8 == 0)


def dynamic_conv(params: dict, x: torch.Tensor, *, kernel_size: int,
                 num_heads: int, weight_softmax: bool = True,
                 weight_dropout: float = 0.0,
                 gen: torch.Generator | None = None,
                 deterministic: bool = True,
                 query: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence dynamic conv. x: [B, T, C] -> [B, T, C].

    Where _can_fuse holds, kernel C (fused_dynamic_conv) runs on the
    k-major predictor; the gradient of w_km flows back through the layout
    transpose to weight_linear.w. Otherwise (flagship training, with weight
    dropout) the unfused ops run, as tell_tpu runs its jnp path there: the
    tap weights are rounded to x's dtype before the FMA."""
    B, T, C = x.shape
    K, H = kernel_size, num_heads
    if _can_fuse(params, query, weight_dropout, deterministic, H, C):
        w = params["weight_linear"]["w"]                 # [C, H*K] h-major
        w_km = w.reshape(C, H, K).transpose(1, 2).reshape(C, K * H)
        return fused_dynamic_conv(x.contiguous(), w_km.to(x.dtype), K, H,
                                  weight_softmax)
    q = x if query is None else query
    w = linear(params["weight_linear"], q).reshape(B, T, H, K)
    if weight_softmax:
        w = torch.softmax(w.float(), dim=-1).to(x.dtype)
    w = dropout(w, weight_dropout, gen, deterministic)
    out = _conv_with_weights(x, w, K, H)
    if "conv_bias" in params:
        out = out + params["conv_bias"]
    return out


def init_conv_state(batch: int, conv_dim: int, kernel_size: int,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """Window of the last K-1 inputs, zero-initialised: [B, K-1, C]."""
    return torch.zeros(batch, max(kernel_size - 1, 0), conv_dim,
                       dtype=dtype, device=device)


def dynamic_conv_step(params: dict, x_t: torch.Tensor, state: torch.Tensor,
                      *, kernel_size: int, num_heads: int,
                      weight_softmax: bool = True,
                      row_gather: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x_t: [B, C], state: [B, K-1, C] -> (out [B, C],
    state'). row_gather [B]: beam parent indices applied to the state rows
    while the window is read (no separate reorder pass)."""
    B, C = x_t.shape
    K, H = kernel_size, num_heads
    R = C // H
    w = linear(params["weight_linear"], x_t).reshape(B, H, K)
    if weight_softmax:
        w = torch.softmax(w.float(), dim=-1).to(x_t.dtype)
    if row_gather is not None:
        state = state[row_gather]
    window = torch.cat([state, x_t[:, None, :]], dim=1)          # [B, K, C]
    wh = window.reshape(B, K, H, R)
    out = torch.einsum("bhk,bkhr->bhr", w, wh).reshape(B, C)
    if "conv_bias" in params:
        out = out + params["conv_bias"]
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# lightweight conv: the same convolution with a fixed learned per-head kernel
# ---------------------------------------------------------------------------

def init_lightweight_conv(generator: torch.Generator, kernel_size: int,
                          num_heads: int) -> dict:
    """tell_tpu's init_lightweight_conv (no conv bias): xavier uniform on
    [H, 1, K], drawn from `generator` on its device."""
    bound = (6.0 / (1 + kernel_size)) ** 0.5
    w = torch.rand((num_heads, kernel_size), generator=generator,
                   device=generator.device)
    return {"weight": w * (2 * bound) - bound}


def _lightweight_weights(params: dict, weight_softmax: bool
                         ) -> torch.Tensor:
    w = params["weight"]
    return torch.softmax(w.float(), dim=-1) if weight_softmax else w


def lightweight_conv(params: dict, x: torch.Tensor, *, kernel_size: int,
                     num_heads: int, weight_softmax: bool = True,
                     weight_dropout: float = 0.0,
                     gen: torch.Generator | None = None,
                     deterministic: bool = True) -> torch.Tensor:
    """Full-sequence lightweight conv. x: [B, T, C] -> [B, T, C]."""
    B, T, C = x.shape
    w = _lightweight_weights(params, weight_softmax).to(x.dtype)
    w = dropout(w, weight_dropout, gen, deterministic)
    wbt = w[None, None].expand(B, T, num_heads, kernel_size)
    out = _conv_with_weights(x, wbt, kernel_size, num_heads)
    if "conv_bias" in params:
        out = out + params["conv_bias"]
    return out


def lightweight_conv_step(params: dict, x_t: torch.Tensor,
                          state: torch.Tensor, *, kernel_size: int,
                          num_heads: int, weight_softmax: bool = True,
                          row_gather: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the lightweight conv (dynamic_conv_step's
    contract)."""
    B, C = x_t.shape
    K, H = kernel_size, num_heads
    w = _lightweight_weights(params, weight_softmax).to(x_t.dtype)
    if row_gather is not None:
        state = state[row_gather]
    window = torch.cat([state, x_t[:, None, :]], dim=1)          # [B, K, C]
    wh = window.reshape(B, K, H, C // H)
    out = torch.einsum("hk,bkhr->bhr", w, wh).reshape(B, C)
    if "conv_bias" in params:
        out = out + params["conv_bias"]
    return out, window[:, 1:, :]
