"""Kernel C: fused causal dynamic convolution, the teacher-forced conv of
every decoder layer.

Replaces tell_tpu/ops/kernels/dynamic_conv.py::fused_dynamic_conv
(_pallas_forward / _kernel, pallas_call at :83; custom VJP _fwd/_bwd at
:128-149) with tell_tpu_torch/csrc/dynamic_conv.cu.

Semantics (the JAX kernel's and its _reference's, :102-125): x [B, T, C],
w_km [C, K*H] k-major (column k*H + h is tap k of head h);
logits = x . w_km in fp32, softmax over each head's K taps (or the raw
logits when weight_softmax is False), out[t, c] = sum_k p[t, k, h(c)] *
x[t - K + 1 + k, c] with zeros before t = 0, accumulated in fp32 and
returned in x's dtype. The kernel computes the tap logits itself.

What bounds it on the H100: the tap-logit product, 2*B*T*C*K*H FLOPs, on
the fp32 CUDA cores; the design keeps the logits and probabilities on chip
and reads x once plus a halo (see the source's header).

Gradient: fused_dynamic_conv is a torch.autograd.Function whose forward is
the kernel and whose backward recomputes through dynamic_conv_plain under
autograd (the JAX _bwd scheme: tell_tpu has no backward kernel either).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import check_launch, load_library
from .dispatch import check_kernel_args, use_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_COLUMNS = 64   # K * heads-per-block, the kernel's kMaxNF
_TARGET_COLUMNS = 32


def dynamic_conv_plain(x: torch.Tensor, w_km: torch.Tensor,
                       kernel_size: int, num_heads: int,
                       weight_softmax: bool = True) -> torch.Tensor:
    """Plain PyTorch version (tell_tpu's _reference): fp32 logits, softmax
    and accumulation on x upcast to fp32; the tap weights are NOT rounded
    to x's dtype (the unfused ops/dynamic_conv.py path does round them)."""
    B, T, C = x.shape
    K, H = kernel_size, num_heads
    R = C // H
    x32 = x.float()
    w = torch.matmul(x32, w_km.float()).reshape(B, T, K, H)
    if weight_softmax:
        w = torch.softmax(w, dim=2)
    xh = x32.reshape(B, T, H, R)
    out = torch.zeros(B, T, H, R, dtype=torch.float32, device=x.device)
    for k in range(K):
        shift = K - 1 - k
        if shift >= T:
            continue
        xs = xh if shift == 0 else F.pad(xh[:, :T - shift],
                                         (0, 0, 0, 0, shift, 0))
        out = out + w[:, :, k, :, None] * xs
    return out.reshape(B, T, C).to(x.dtype)


def heads_per_block(kernel_size: int, num_heads: int) -> int:
    """Heads one block covers: the largest divisor of num_heads that keeps
    K * heads at most 32 tap-logit columns (K=3 -> 8 heads, K=31 -> 1 at
    the flagship's 16 heads), so every layer gives a block a few hundred
    logits to reduce and a grid of tens to hundreds of blocks."""
    best = 1
    for hb in range(1, num_heads + 1):
        if num_heads % hb == 0 and kernel_size * hb <= _TARGET_COLUMNS:
            best = hb
    return best


def _launch(x: torch.Tensor, w_km: torch.Tensor, kernel_size: int,
            num_heads: int, weight_softmax: bool) -> torch.Tensor:
    B, T, C = x.shape
    K, H = kernel_size, num_heads
    if C % H:
        raise ValueError(f"fused_dynamic_conv: C={C} is not a multiple of "
                         f"num_heads={H}")
    if K > _MAX_COLUMNS:
        raise ValueError(f"fused_dynamic_conv: kernel_size {K} > "
                         f"{_MAX_COLUMNS}")
    if w_km.shape != (C, K * H):
        raise ValueError(f"fused_dynamic_conv: w_km {tuple(w_km.shape)} is "
                         f"not {(C, K * H)}")
    check_kernel_args("fused_dynamic_conv", {"x": x, "w_km": w_km},
                      {"x": tuple(_DTYPE_CODE), "w_km": (x.dtype,)})
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        code = lib.tt_dynamic_conv(
            x.data_ptr(), w_km.data_ptr(), out.data_ptr(), B, T, C, H, K,
            heads_per_block(K, H), int(weight_softmax), _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    check_launch(lib, "fused_dynamic_conv", code)
    fused_dynamic_conv.launches += 1
    return out


class _FusedDynamicConv(torch.autograd.Function):
    """Forward: kernel C. Backward: autograd through dynamic_conv_plain on
    the saved (x, w_km), recomputed (the JAX _bwd, :141-146)."""

    @staticmethod
    def forward(ctx, x, w_km, kernel_size, num_heads, weight_softmax):
        ctx.save_for_backward(x, w_km)
        ctx.conv = (kernel_size, num_heads, weight_softmax)
        return _launch(x, w_km, kernel_size, num_heads, weight_softmax)

    @staticmethod
    def backward(ctx, grad):
        x, w_km = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            wr = w_km.detach().requires_grad_()
            out = dynamic_conv_plain(xr, wr, *ctx.conv)
            dx, dw = torch.autograd.grad(out, (xr, wr), grad)
        return dx, dw, None, None, None


def fused_dynamic_conv(x: torch.Tensor, w_km: torch.Tensor,
                       kernel_size: int, num_heads: int,
                       weight_softmax: bool = True) -> torch.Tensor:
    """Fused causal dynamic conv. x: [B, T, C] fp32 or bf16 contiguous;
    w_km: [C, K*H] k-major, x's dtype. CUDA tensors launch kernel C
    (counted in fused_dynamic_conv.launches; differentiable through
    _FusedDynamicConv); CPU tensors take dynamic_conv_plain."""
    if not use_kernel(x, w_km):
        return dynamic_conv_plain(x, w_km, kernel_size, num_heads,
                                  weight_softmax)
    return _FusedDynamicConv.apply(x, w_km, kernel_size, num_heads,
                                   weight_softmax)


fused_dynamic_conv.launches = 0
