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

What bounds it on the H100: the tap-logit product, 2*B*T*C*K*H operations,
which the kernel runs on the tensor cores (bf16 mma.sync, or 3xTF32 for
fp32) in tiles of TT time rows by K*HB columns (conv_tiling picks TT and
HB so that the grid has at least MIN_BLOCKS blocks), with each 128-byte
slot of C accumulated in fresh fragments; the logits and probabilities
stay on chip and x is read once plus a halo (see the source's header).
dynamic_conv_tiled models that schedule in PyTorch for the tests.

Gradient: fused_dynamic_conv is a torch.autograd.Function whose forward is
the kernel and whose backward recomputes through dynamic_conv_plain under
autograd (the JAX _bwd scheme: tell_tpu has no backward kernel either).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import tf32
from .build import check_launch, load_library
from .dispatch import check_kernel_args, use_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_COLUMNS = 32    # K * heads-per-block, padded to 8, 16 or 32 (kernel)
MIN_BLOCKS = 256    # conv_tiling's target grid: two blocks for most SMs
SLOT_BYTES = 128    # bytes of C per cp.async ring slot (csrc kSlotBytes)
WARPS = 8
K_STEPS = 4         # mma k-steps per slot


def dynamic_conv_plain(x: torch.Tensor, w_km: torch.Tensor,
                       kernel_size: int, num_heads: int,
                       weight_softmax: bool = True) -> torch.Tensor:
    """Plain PyTorch version (tell_tpu's _reference): fp32 logits, softmax
    and accumulation on x upcast to fp32; the tap weights are NOT rounded
    to x's dtype (the unfused ops/dynamic_conv.py path does round them)."""
    logits = torch.matmul(x.float(), w_km.float())
    return _taps(x, logits, kernel_size, num_heads, weight_softmax)


def _taps(x: torch.Tensor, logits: torch.Tensor, K: int, H: int,
          weight_softmax: bool) -> torch.Tensor:
    """The softmax over each head's K taps of logits [B, T, K*H] (k-major)
    and the causal K-tap sum over x, in fp32; returned in x's dtype."""
    B, T, C = x.shape
    R = C // H
    x32 = x.float()
    w = logits.reshape(B, T, K, H)
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


def padded_columns(kernel_size: int, hb: int) -> int:
    """A block's K * hb tap-logit columns padded to 8, 16 or 32 (n8 mma
    tiles, a power-of-two count of them)."""
    n = 8
    while n < kernel_size * hb:
        n *= 2
    return n


def conv_tiling(batch: int, time: int, kernel_size: int, num_heads: int
                ) -> tuple[int, int]:
    """(TT, HB): time rows and heads per block. The largest tile (TT = 32
    before 16, then the most heads whose K * HB columns fit MAX_COLUMNS)
    whose grid of ceil(T / TT) * (H / HB) * B blocks reaches MIN_BLOCKS;
    TT = 16 where T <= 16; else the most blocks, (16, 1). At the
    flagship's training shape (B=16, T=32, H=16) every layer takes (32,
    1), 256 blocks: a block's latency, not its work, sets the time, so two
    blocks an SM beat one block of twice the heads (PERF.md §6)."""
    heads = [hb for hb in range(num_heads, 0, -1)
             if num_heads % hb == 0 and kernel_size * hb <= MAX_COLUMNS]
    for tt in ((32, 16) if time > 16 else (16,)):
        for hb in heads:
            if -(-time // tt) * (num_heads // hb) * batch >= MIN_BLOCKS:
                return tt, hb
    return 16, 1


def dynamic_conv_tiled(x: torch.Tensor, w_km: torch.Tensor,
                       kernel_size: int, num_heads: int,
                       weight_softmax: bool = True,
                       tiling: tuple[int, int] | None = None
                       ) -> torch.Tensor:
    """Kernel C's schedule in PyTorch, for the tests: the tap logits as the
    kernel's mma fragments accumulate them (tf32.mma_accumulate: fp32 as
    3xTF32 m16n8k8, bf16 as m16n8k16), a fresh fragment per 128-byte slot
    of C added in fp32, with each logit tile's slot k-steps shared in turn
    by the WARPS / tiles warps (at most K_STEPS) of conv_tiling's tile and
    those warps' sums added in warp order; then _taps in fp32. x and w_km
    fp32 or bf16 (the bf16 route takes their values exactly). `tiling`
    (TT, HB) stands in for conv_tiling's pick at another batch, since no
    logit depends on the other rows of its tile."""
    B, T, C = x.shape
    K, H = kernel_size, num_heads
    TT, HB = tiling or conv_tiling(B, T, K, H)
    tiles = (TT // 16) * (padded_columns(K, HB) // 8)
    n_warps = min(WARPS // tiles, K_STEPS)
    a = x.float().reshape(B * T, C)
    b = w_km.float().T                                        # [K*H, C]
    if x.dtype == torch.bfloat16:
        pairs, k_step = ((a, b),), 16
    else:
        (ah, al), (bh, bl) = tf32.split(a), tf32.split(b)
        pairs, k_step = ((al, bh), (ah, bl), (ah, bh)), 8
    slot = SLOT_BYTES // x.element_size()
    step_of = (torch.arange(C) // k_step) % K_STEPS    # k-step in its slot
    logits = 0.0
    for j in range(n_warps):
        keep = (step_of % n_warps == j).float()
        logits = logits + tf32.mma_accumulate(
            [(p * keep, q * keep) for p, q in pairs], k_step, slot)
    return _taps(x, logits.reshape(B, T, K * H).to(x.device), K, H,
                 weight_softmax)


def _launch(x: torch.Tensor, w_km: torch.Tensor, kernel_size: int,
            num_heads: int, weight_softmax: bool) -> torch.Tensor:
    B, T, C = x.shape
    K, H = kernel_size, num_heads
    if C % H:
        raise ValueError(f"fused_dynamic_conv: C={C} is not a multiple of "
                         f"num_heads={H}")
    if K > MAX_COLUMNS:
        raise ValueError(f"fused_dynamic_conv: kernel_size {K} > "
                         f"{MAX_COLUMNS}")
    if w_km.shape != (C, K * H):
        raise ValueError(f"fused_dynamic_conv: w_km {tuple(w_km.shape)} is "
                         f"not {(C, K * H)}")
    check_kernel_args("fused_dynamic_conv", {"x": x, "w_km": w_km},
                      {"x": tuple(_DTYPE_CODE), "w_km": (x.dtype,)})
    if (C // H) % 8 or x.data_ptr() % 16:
        raise ValueError(f"fused_dynamic_conv: the kernel loads 16-byte "
                         f"pieces of x's rows and of a head's channels: "
                         f"C / num_heads = {C // H} must be a multiple of 8 "
                         "and x 16-byte aligned")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    TT, HB = conv_tiling(B, T, K, H)
    NFP = padded_columns(K, HB)
    w_blk = torch.empty((H // HB) * C * NFP, dtype=x.dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        code = lib.tt_dynamic_conv(
            x.data_ptr(), w_km.data_ptr(), w_blk.data_ptr(), out.data_ptr(),
            B, T, C, H, K, TT, HB, NFP, int(weight_softmax),
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
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
    w_km: [C, K*H] k-major, x's dtype. CUDA tensors launch kernel C,
    which takes K <= MAX_COLUMNS, C / num_heads a multiple of 8 and x on
    a 16-byte boundary, and raises ValueError otherwise
    (counted in fused_dynamic_conv.launches; differentiable through
    _FusedDynamicConv); CPU tensors take dynamic_conv_plain."""
    if not use_kernel(x, w_km):
        return dynamic_conv_plain(x, w_km, kernel_size, num_heads,
                                  weight_softmax)
    return _FusedDynamicConv.apply(x, w_km, kernel_size, num_heads,
                                   weight_softmax)


fused_dynamic_conv.launches = 0
