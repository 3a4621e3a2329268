"""Kernel G: the w8a8 dense layer, int8 x int8 -> int32 on the tensor cores.

Replaces no Pallas kernel: tell_tpu computes this product with
jnp.dot(xq, wq, preferred_element_type=int32) (tell_tpu/ops/quant.py:66,
int8_linear; tell_tpu/ops/adaptive.py's int8 softmax tables), which XLA
lowers to the TPU's int8 matrix unit. PyTorch has no public int8 GEMM:
torch._int_mm refuses M <= 16 rows and N not a multiple of 8, and a
dequantised fp matmul is not the int8 contraction. So
tell_tpu_torch/csrc/int8_linear.cu holds two launches: the per-row dynamic
activation quantisation (quantize_rows) and the int8 GEMM with its fp32
epilogue (int8_gemm). int8_linear is the two together, in one host call.

The GEMM has two routes, chosen by shape in plan_gemm: above SMALL_M rows,
wgmma on TMA-fed shared memory over a persistent grid (128 x 128 or, where
the card stays full, 128 x 256 tiles); at the decode's few
rows, mma.sync with the K axis split over a thread-block cluster so that
every SM reads the weight (int32 partials, summed exactly). Both read the
weight stored [N, K] (each output channel's K values contiguous), the
K-major operand both instructions take for int8: ops/quant.py makes it
once, when it quantises the weight, so no call transposes.

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

import functools
import math
from typing import NamedTuple

import torch

from .build import check_launch, load_library
from .dispatch import use_kernel

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


# plan_gemm's routes (csrc kRouteMma, kRouteWgmma, kRouteWgmmaWide)
ROUTE_MMA, ROUTE_WGMMA, ROUTE_WGMMA_WIDE = 0, 1, 2
SMALL_M = 64              # rows the mma route's one row tile holds
MMA_TILE = (64, 64)       # output rows x columns a block (mma route)
WGMMA_TILE = (128, 128)   # output rows x columns a tile (wgmma routes)
WGMMA_WIDE_TILE = (128, 256)
K_SLICE = 64              # bytes of K a ring slot (mma); a chunk's unit
MAX_SPLIT = 8             # blocks of a cluster: the portable limit
H100_SMS = 132


class GemmPlan(NamedTuple):
    """How kernel G's GEMM runs one shape. route: ROUTE_MMA or ROUTE_WGMMA;
    tile: output rows x columns a block computes at a time; split: blocks
    that share one output tile's K axis (one cluster); chunk: bytes of K
    each of them sums; grid: blocks launched; scratch: bytes int8_linear
    allocates beside its output (xq [M, K] int8, then sx [M] fp32 on a
    16-byte boundary)."""
    route: int
    tile: tuple[int, int]
    split: int
    chunk: int
    grid: int
    scratch: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=4096)
def plan_gemm(M: int, N: int, K: int, n_sm: int = H100_SMS) -> GemmPlan:
    """The GEMM's route, tile, split and grid for [M, K] x [N, K]^T on a
    card of n_sm SMs. Above SMALL_M rows, a wgmma route on a persistent
    grid of min(tiles, n_sm) blocks: 128 x 256 tiles where they still
    give every SM one (each operand byte read from L2 feeds twice the
    products of a 128 x 128 tile), else 128 x 128. At SMALL_M rows or
    fewer, where the weight's bytes bound the call, the mma route: one
    64-row tile, 64 columns a block, and K split over up to MAX_SPLIT
    blocks, the most (a power of two) that keeps at most two blocks an SM
    and gives every block at least two slices of K."""
    scratch = _align16(M * K) + 4 * M
    if M > SMALL_M:
        m_tiles = -(-M // WGMMA_TILE[0])
        wide = m_tiles * -(-N // WGMMA_WIDE_TILE[1])
        if wide >= n_sm:
            return GemmPlan(ROUTE_WGMMA_WIDE, WGMMA_WIDE_TILE, 1, K, n_sm,
                            scratch)
        tiles = m_tiles * -(-N // WGMMA_TILE[1])
        return GemmPlan(ROUTE_WGMMA, WGMMA_TILE, 1, K, min(tiles, n_sm),
                        scratch)
    n_tiles = -(-N // MMA_TILE[1])
    split = MAX_SPLIT
    while split > 1 and (n_tiles * split > 2 * n_sm
                         or split * 2 * K_SLICE > K):
        split //= 2
    chunk = -(-K // (split * K_SLICE)) * K_SLICE
    return GemmPlan(ROUTE_MMA, MMA_TILE, split, chunk, n_tiles * split,
                    scratch)


def gemm_work(plan: GemmPlan, M: int, N: int, K: int
              ) -> list[list[tuple[int, int, int, int, int, int]]]:
    """Each block's work under `plan`, in its order, as (m0, m1, n0, n1,
    k0, k1) boxes clipped to the matrix: a wgmma route's block b takes
    tiles b, b + grid, ... (row tile fastest), each over all of K; the
    mma route's block (x, y) takes column tile x over chunk y of K."""
    bm, bn = plan.tile
    if plan.route != ROUTE_MMA:
        m_tiles = -(-M // bm)
        tiles = m_tiles * -(-N // bn)
        return [[(t % m_tiles * bm, min(M, t % m_tiles * bm + bm),
                  t // m_tiles * bn, min(N, t // m_tiles * bn + bn), 0, K)
                 for t in range(b, tiles, plan.grid)]
                for b in range(plan.grid)]
    return [[(0, M, x * bn, min(N, x * bn + bn), min(K, y * plan.chunk),
              min(K, (y + 1) * plan.chunk))]
            for x in range(-(-N // bn)) for y in range(plan.split)]


def int8_gemm_tiled_plain(xq: torch.Tensor, sx: torch.Tensor,
                          wq: torch.Tensor, sw: torch.Tensor,
                          b: torch.Tensor | None = None,
                          out_dtype: torch.dtype = torch.float32,
                          n_sm: int = H100_SMS) -> torch.Tensor:
    """int8_gemm_plain computed as the kernel schedules it (tests only):
    plan_gemm's blocks, each box's int32 partial product (exact in
    float64), the partials of one output added in int32, then the same
    epilogue. Equal to int8_gemm_plain bit for bit: the int32 sums are
    exact in any order."""
    M, K = xq.shape
    N = wq.shape[0]
    acc = torch.zeros(M, N, dtype=torch.int32)
    for block in gemm_work(plan_gemm(M, N, K, n_sm), M, N, K):
        for m0, m1, n0, n1, k0, k1 in block:
            part = torch.matmul(xq[m0:m1, k0:k1].double(),
                                wq[n0:n1, k0:k1].double().T)
            acc[m0:m1, n0:n1] += part.to(torch.int32)
    v = acc.float() * sx
    out = v * sw if b is None else fma32(v, sw.expand_as(v), b.expand_as(v))
    return out.to(out_dtype)


def check_gemm_args(name: str, M: int, K: int, wq: torch.Tensor,
                    sw: torch.Tensor, b: torch.Tensor | None,
                    out_dtype: torch.dtype, *firsts: torch.Tensor) -> None:
    """What kernel G cannot survive, refused before a launch: the row
    operands `firsts` (xq and sx) contiguous, their dtypes the caller's to
    check; the weight int8 [N, K], contiguous and 16-byte
    aligned (TMA and cp.async read it in 16-byte pieces), K a multiple of
    16 and M >= 1; sw [N] and b [N] fp32 and contiguous; out_dtype fp32
    or bf16 (int8_linear's x dtype). Reads only metadata, so it runs on
    tensors anywhere."""
    if M < 1 or K < 16 or K % 16:
        raise ValueError(f"{name}: M={M}, K={K}: the kernel takes M >= 1 "
                         "and K a multiple of 16 (it loads 16-byte pieces "
                         "of a row)")
    if wq.dtype != torch.int8 or sw.dtype != torch.float32 or (
            b is not None and b.dtype != torch.float32):
        raise TypeError(f"{name}: wq, sw, b have dtypes {wq.dtype}, "
                        f"{sw.dtype}, {None if b is None else b.dtype}; the "
                        "kernel takes int8, fp32, fp32")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {out_dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    N = wq.shape[0]
    if wq.ndim != 2 or wq.shape[1] != K or sw.numel() != N or (
            b is not None and b.numel() != N):
        raise ValueError(f"{name}: wq {tuple(wq.shape)}, sw "
                         f"{tuple(sw.shape)} do not match K={K}")
    for t in (wq, sw, b, *firsts):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: an operand is not contiguous")
    if wq.data_ptr() % 16:
        raise ValueError(f"{name}: wq is not 16-byte aligned")


_SMS: dict[int, int] = {}


def _sm_count(index: int) -> int:
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def _raw_stream(index: int) -> int:
    """The current stream's handle on device `index`, without building a
    torch.cuda.Stream object (the host cost a small layer's call pays)."""
    return torch._C._cuda_getCurrentRawStream(index)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] fp32 or bf16 -> (int8 [..., K], fp32 scales [..., 1]).
    CUDA tensors launch kernel G's quantisation (counted in
    quantize_rows.launches); CPU tensors take quantize_rows_plain."""
    if not use_kernel(x):
        return quantize_rows_plain(x)
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_rows: x has dtype {x2.dtype}, the kernel "
                        f"takes {tuple(_DTYPE_CODE)}")
    M = x2.shape[0]
    if M < 1 or K < 1:
        raise ValueError(f"quantize_rows: x {tuple(x.shape)} is empty")
    q = torch.empty(M, K, dtype=torch.int8, device=x.device)
    s = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    lib = load_library()
    code = lib.tt_int8_quant_rows(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), M, K,
        _DTYPE_CODE[x2.dtype], x.device.index, _raw_stream(x.device.index))
    if code:
        check_launch(lib, "quantize_rows", code)
    quantize_rows.launches += 1
    return (q.reshape(x.shape), s.reshape(*x.shape[:-1], 1))


def int8_gemm(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
              sw: torch.Tensor, b: torch.Tensor | None = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """xq [M, K] int8, sx [M, 1] fp32, wq [N, K] int8 (contiguous), sw [N]
    fp32, b [N] fp32 or None -> [M, N] in out_dtype (fp32 or bf16). CUDA
    tensors launch kernel G's GEMM on plan_gemm's route (counted in
    int8_gemm.launches); check_gemm_args says what it refuses. CPU
    tensors take int8_gemm_plain."""
    tensors = [xq, sx, wq, sw] + ([] if b is None else [b])
    if not use_kernel(*tensors):
        return int8_gemm_plain(xq, sx, wq, sw, b, out_dtype)
    if xq.ndim != 2 or xq.dtype != torch.int8 or sx.dtype != torch.float32:
        raise TypeError(f"int8_gemm: xq {tuple(xq.shape)} {xq.dtype}, sx "
                        f"{sx.dtype}: the kernel takes int8 [M, K] and fp32")
    M, K = xq.shape
    check_gemm_args("int8_gemm", M, K, wq, sw, b, out_dtype, xq, sx)
    if sx.numel() != M:
        raise ValueError(f"int8_gemm: sx {tuple(sx.shape)} does not match "
                         f"M={M}")
    if xq.data_ptr() % 16:
        raise ValueError("int8_gemm: xq is not 16-byte aligned")
    N = wq.shape[0]
    dev = xq.device
    plan = plan_gemm(M, N, K, _sm_count(dev.index))
    out = torch.empty(M, N, dtype=out_dtype, device=dev)
    lib = load_library()
    code = lib.tt_int8_gemm(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), M, N, K,
        _DTYPE_CODE[out_dtype], plan.route, plan.split, plan.chunk,
        plan.grid, dev.index, _raw_stream(dev.index))
    if code:
        check_launch(lib, "int8_gemm", code)
    int8_gemm.launches += 1
    return out


def int8_linear(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                b: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., K] fp32 or bf16 -> [..., N] in x's dtype: on CUDA one host
    call launches kernel G's quantisation and GEMM back to back (counted
    in quantize_rows.launches and int8_gemm.launches), through one scratch
    allocation (GemmPlan.scratch); int8_linear_plain on the CPU."""
    if not use_kernel(x, wq, sw, *(() if b is None else (b,))):
        return int8_linear_plain(x, wq, sw, b)
    K = x.shape[-1]
    x2 = x if x.dim() == 2 else x.reshape(-1, K)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    M = x2.shape[0]
    check_gemm_args("int8_linear", M, K, wq, sw, b, x2.dtype)
    N = wq.shape[0]
    dev = x.device
    plan = plan_gemm(M, N, K, _sm_count(dev.index))
    scratch = torch.empty(plan.scratch, dtype=torch.uint8, device=dev)
    out = torch.empty(M, N, dtype=x2.dtype, device=dev)
    xq = scratch.data_ptr()
    lib = load_library()
    code = lib.tt_int8_linear(
        x2.data_ptr(), xq, xq + _align16(M * K), wq.data_ptr(),
        sw.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
        M, N, K, _DTYPE_CODE[x2.dtype], plan.route, plan.split, plan.chunk,
        plan.grid, dev.index, _raw_stream(dev.index))
    if code:
        check_launch(lib, "int8_linear", code)
    quantize_rows.launches += 1
    int8_gemm.launches += 1
    return out if x.dim() == 2 else out.reshape(*x.shape[:-1], N)


quantize_rows.launches = 0
int8_gemm.launches = 0
