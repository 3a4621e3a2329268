"""Kernel G: the w8a8 dense layer, int8 x int8 -> int32 on the tensor cores.

Replaces no Pallas kernel: tell_tpu computes this product with
jnp.dot(xq, wq, preferred_element_type=int32) (tell_tpu/ops/quant.py:66,
int8_linear; tell_tpu/ops/adaptive.py's int8 softmax tables), which XLA
lowers to the TPU's int8 matrix unit. PyTorch has no public int8 GEMM:
torch._int_mm refuses M <= 16 rows and N not a multiple of 8, and a
dequantised fp matmul is not the int8 contraction. So
tell_tpu_torch/csrc/int8_linear.cu holds two launches: the per-row dynamic
activation quantisation (quantize_rows) and the int8 GEMM with its fp32
epilogue (int8_gemm). int8_linear is the two together.

The weight is stored [N, K] (each output channel's K values contiguous),
the layout mma.sync's .col operand reads as 32-bit words: ops/quant.py makes
it once, when it quantises the weight, so no call transposes.

The numerics are tell_tpu's as XLA compiles them inside its jitted
steps, where they run: the activation scale is max(amax, 1e-8) times the
fp32 reciprocal of 127 (XLA turns the division by the constant into that
product), the quotient x / scale a true division rounded half to even,
and the epilogue (float(acc) * sx) * sw + b with the last product and the
bias add fused into one rounding (XLA contracts them into an FMA; without
a bias, two rounded products). The int32 sums are exact, and the kernel
rounds each step as the plain version does, so on the same inputs the
int8 values and the outputs are equal bit for bit. The plain version
takes the exact integer product in float64 (every partial sum is an
integer below 2^53) and the FMA exactly (fma32).
"""
from __future__ import annotations

import math

import torch

from .build import check_launch, load_library
from .dispatch import check_kernel_args, use_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# fp32(1 / 127), correctly rounded: the constant XLA multiplies by where
# tell_tpu divides by 127 inside jit (csrc kInv127)
INV_127 = (torch.tensor(1.0) / torch.tensor(127.0)).item()


def int8_scale(amax: torch.Tensor, exact_div: bool = False) -> torch.Tensor:
    """The symmetric int8 scale of an absolute maximum: max(amax, 1e-8)
    times fp32(1/127), as tell_tpu computes it inside jit, or with
    exact_div the true division by 127, as it computes it eagerly (its
    frozen tower, quantised at load)."""
    m = amax.clamp_min(1e-8)
    return m / 127.0 if exact_div else m * INV_127


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """a * b + c for fp32 tensors, rounded once (an FMA): the product is
    exact in float64, the sum is rounded to float64 with its error kept
    (TwoSum), and where that rounding landed on a midpoint of two fp32
    values the error decides the side a single rounding would take."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, math.inf, -math.inf).float()
    other = torch.nextafter(r, toward)
    mid = (d != 0) & ((r.double() + other.double()) * 0.5 == s)
    return torch.where(mid & (err * d > 0), other, r)


def quantize_rows_plain(x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] -> (int8 [..., K], fp32 scales [..., 1]): per-row
    symmetric int8, scale = int8_scale(amax), q = round(x / scale) (a
    true division; torch.round, like jnp.round, rounds half to even)
    clipped to [-127, 127] (tell_tpu's quantize_act_int8)."""
    x32 = x.float()
    scale = int8_scale(x32.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_gemm_plain(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                    sw: torch.Tensor, b: torch.Tensor | None = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """xq [M, K] int8, sx [M, 1] fp32, wq [N, K] int8, sw [N] fp32, b [N]:
    (float(xq @ wq.T) * sx) * sw, with b added in the same rounding as the
    last product (fma32), in fp32, returned in out_dtype. The integer
    product is exact in float64."""
    acc = torch.matmul(xq.double(), wq.double().T).float()
    v = acc * sx
    out = v * sw if b is None else fma32(v, sw.expand_as(v),
                                         b.expand_as(v))
    return out.to(out_dtype)


def int8_linear_plain(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                      b: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., K] -> [..., N] in x's dtype: quantize_rows_plain, then
    int8_gemm_plain (tell_tpu's int8_linear)."""
    xq, sx = quantize_rows_plain(x.reshape(-1, x.shape[-1]))
    out = int8_gemm_plain(xq, sx, wq, sw, b, x.dtype)
    return out.reshape(*x.shape[:-1], wq.shape[0])


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] fp32 or bf16 -> (int8 [..., K], fp32 scales [..., 1]).
    CUDA tensors launch kernel G's quantisation (counted in
    quantize_rows.launches); CPU tensors take quantize_rows_plain."""
    if not use_kernel(x):
        return quantize_rows_plain(x)
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    check_kernel_args("quantize_rows", {"x": x2}, {"x": tuple(_DTYPE_CODE)})
    M = x2.shape[0]
    if M < 1 or K < 1:
        raise ValueError(f"quantize_rows: x {tuple(x.shape)} is empty")
    q = torch.empty(M, K, dtype=torch.int8, device=x.device)
    s = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        code = lib.tt_int8_quant_rows(
            x2.data_ptr(), q.data_ptr(), s.data_ptr(), M, K,
            _DTYPE_CODE[x2.dtype], torch.cuda.current_stream().cuda_stream)
    check_launch(lib, "quantize_rows", code)
    quantize_rows.launches += 1
    return (q.reshape(x.shape), s.reshape(*x.shape[:-1], 1))


def int8_gemm(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
              sw: torch.Tensor, b: torch.Tensor | None = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """xq [M, K] int8, sx [M, 1] fp32, wq [N, K] int8 (contiguous), sw [N]
    fp32, b [N] fp32 or None -> [M, N] in out_dtype (fp32 or bf16). CUDA
    tensors launch kernel G's GEMM (counted in int8_gemm.launches); it
    loads 16-byte pieces of a row, so it takes K a multiple of 16 and the
    operands on 16-byte boundaries, and raises ValueError otherwise. CPU
    tensors take int8_gemm_plain."""
    tensors = [xq, sx, wq, sw] + ([] if b is None else [b])
    if not use_kernel(*tensors):
        return int8_gemm_plain(xq, sx, wq, sw, b, out_dtype)
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8_gemm: xq {tuple(xq.shape)} and wq "
                         f"{tuple(wq.shape)} are not [M, K] and [N, K]")
    M, K = xq.shape
    N = wq.shape[0]
    if sx.numel() != M or sw.numel() != N or (b is not None
                                              and b.numel() != N):
        raise ValueError(f"int8_gemm: scales {tuple(sx.shape)}, "
                         f"{tuple(sw.shape)} do not match M={M}, N={N}")
    args = {"xq": xq, "wq": wq, "sx": sx, "sw": sw}
    dtypes = {"xq": (torch.int8,), "wq": (torch.int8,),
              "sx": (torch.float32,), "sw": (torch.float32,),
              "b": (torch.float32,)}
    if b is not None:
        args["b"] = b
    check_kernel_args("int8_gemm", args, dtypes)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"int8_gemm: out_dtype {out_dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    if M < 1 or K % 16:
        raise ValueError(f"int8_gemm: M={M}, K={K}: the kernel takes M >= 1 "
                         "and K a multiple of 16 (it loads 16-byte pieces "
                         "of a row)")
    for name in ("xq", "wq"):
        if args[name].data_ptr() % 16:
            raise ValueError(f"int8_gemm: {name} is not 16-byte aligned")
    out = torch.empty(M, N, dtype=out_dtype, device=xq.device)
    lib = load_library()
    with torch.cuda.device(xq.device):
        code = lib.tt_int8_gemm(
            xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), M, N, K,
            _DTYPE_CODE[out_dtype], torch.cuda.current_stream().cuda_stream)
    check_launch(lib, "int8_gemm", code)
    int8_gemm.launches += 1
    return out


def int8_linear(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                b: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., K] fp32 or bf16 -> [..., N] in x's dtype: kernel G's
    quantisation and GEMM on CUDA, int8_linear_plain on the CPU."""
    if not use_kernel(x, wq):
        return int8_linear_plain(x, wq, sw, b)
    xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    out = int8_gemm(xq, sx, wq, sw, b, x.dtype)
    return out.reshape(*x.shape[:-1], wq.shape[0])


quantize_rows.launches = 0
int8_gemm.launches = 0
