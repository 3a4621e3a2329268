"""Kernel G's schedule (tell_tpu_torch/ops/kernels/int8_linear.py) on the
CPU: plan_gemm's route, tile, split, K chunk, grid and scratch at the
shapes chip_smoke.py's phase 3 holds the kernel to (INT8_CASES and
INT8_EDGE_CASES); every output element and every byte of K covered by
exactly one block's boxes (gemm_work); the kernel's schedule in plain
torch (int8_gemm_tiled_plain: int32 partials per box, added in int32)
equal to int8_gemm_plain bit for bit at the split counts the planner
picks; and what the wrappers refuse (check_gemm_args reads metadata only,
so CPU tensors reach it). int8_gemm_plain itself is held against tell_tpu
in tests/test_torch_quant.py.

Tests marked `cuda` run the kernel against the plain version at the same
shapes and skip without a card; this file imports no JAX, so on the card's
machine:

    python -m pytest --noconftest -q tests/test_torch_int8_linear_routes.py

Tolerance: none. The int32 sums are exact and the kernel rounds each step
as the plain version does, so every comparison is bit for bit.
"""
import numpy as np
import pytest
import torch

from tell_tpu_torch.ops.kernels.int8_linear import (
    MAX_SPLIT, ROUTE_MMA, ROUTE_WGMMA, ROUTE_WGMMA_WIDE, SMALL_M,
    check_gemm_args, gemm_work,
    int8_gemm, int8_gemm_plain, int8_gemm_tiled_plain, int8_linear,
    int8_linear_plain, plan_gemm, quantize_rows, quantize_rows_plain)

# (M, K, N): phase 3's INT8_CASES, then its INT8_EDGE_CASES
PHASE3 = [(2048, 1024, 1024), (2048, 1024, 4096), (2048, 4096, 1024),
          (40, 1024, 2048), (40, 1024, 1024), (40, 4096, 1024),
          (40, 1024, 4096), (40, 1024, 5000), (40, 1024, 15000),
          (40, 1024, 30265)]
EDGES = [(1, 1024, 1024), (8, 1024, 4096), (8, 1024, 30265),
         (17, 4096, 1024), (65, 1024, 2048), (129, 1024, 1024),
         (8192, 1024, 4096), (129, 16, 1000), (40, 48, 1000),
         (2048, 1024, 8), (129, 1024, 30265)]

# route, tile rows x columns, split, chunk, grid for each shape on 132 SMs
WG, WIDE, MMA = ((ROUTE_WGMMA, (128, 128)), (ROUTE_WGMMA_WIDE, (128, 256)),
                 (ROUTE_MMA, (64, 64)))
PLANS = {
    (2048, 1024, 1024): (*WG, 1, 1024, 128),
    (2048, 1024, 4096): (*WIDE, 1, 1024, 132),
    (2048, 4096, 1024): (*WG, 1, 4096, 128),
    (40, 1024, 2048): (*MMA, 8, 128, 256),
    (40, 1024, 1024): (*MMA, 8, 128, 128),
    (40, 4096, 1024): (*MMA, 8, 512, 128),
    (40, 1024, 4096): (*MMA, 4, 256, 256),
    (40, 1024, 5000): (*MMA, 2, 512, 158),
    (40, 1024, 15000): (*MMA, 1, 1024, 235),
    (40, 1024, 30265): (*MMA, 1, 1024, 473),
    (1, 1024, 1024): (*MMA, 8, 128, 128),
    (8, 1024, 4096): (*MMA, 4, 256, 256),
    (8, 1024, 30265): (*MMA, 1, 1024, 473),
    (17, 4096, 1024): (*MMA, 8, 512, 128),
    (65, 1024, 2048): (*WG, 1, 1024, 16),
    (129, 1024, 1024): (*WG, 1, 1024, 16),
    (8192, 1024, 4096): (*WIDE, 1, 1024, 132),
    (129, 16, 1000): (*WG, 1, 16, 16),
    (40, 48, 1000): (*MMA, 1, 64, 16),
    (2048, 1024, 8): (*WG, 1, 1024, 16),
    (129, 1024, 30265): (*WIDE, 1, 1024, 132),
}


def _ids(shapes):
    return [f"M{m}-K{k}-N{n}" for m, k, n in shapes]


@pytest.mark.parametrize("M,K,N", PHASE3 + EDGES, ids=_ids(PHASE3 + EDGES))
def test_plan_at_phase3_shapes(M, K, N):
    """The route by rows (wgmma above SMALL_M, its 256-column tiles where
    they still fill the 132 SMs), the tile, split, chunk and grid each
    shape takes, and the scratch: xq's M*K bytes rounded up to 16, then
    sx's 4 bytes a row."""
    plan = plan_gemm(M, N, K)
    assert (plan.route, plan.tile, plan.split, plan.chunk,
            plan.grid) == PLANS[(M, K, N)]
    assert (plan.route == ROUTE_MMA) == (M <= SMALL_M)
    if plan.route != ROUTE_MMA:
        tiles = -(-M // 128) * -(-N // 256)
        assert (plan.route == ROUTE_WGMMA_WIDE) == (tiles >= 132)
    assert plan.scratch == -(-M * K // 16) * 16 + 4 * M
    if plan.route == ROUTE_MMA:
        # a split's chunk is whole 64-byte slices, at least two of them
        # where K is split; the chunks reach K and no split is empty
        assert plan.chunk % 64 == 0 and plan.split <= MAX_SPLIT
        assert plan.chunk * plan.split >= K > plan.chunk * (plan.split - 1)
        assert plan.split == 1 or plan.chunk >= 128


@pytest.mark.parametrize("M,K,N", PHASE3 + EDGES, ids=_ids(PHASE3 + EDGES))
def test_every_output_and_k_byte_is_covered_once(M, K, N):
    """gemm_work's boxes lie inside the matrix, none is empty, and over
    all blocks each output element gets exactly K bytes of its sum: every
    row, column and K edge falls in some tile, and no two boxes sum the
    same piece."""
    plan = plan_gemm(M, N, K)
    blocks = gemm_work(plan, M, N, K)
    assert len(blocks) == plan.grid
    cov = torch.zeros(M, N, dtype=torch.int32)
    for block in blocks:
        for m0, m1, n0, n1, k0, k1 in block:
            assert 0 <= m0 < m1 <= M and 0 <= n0 < n1 <= N
            assert 0 <= k0 < k1 <= K
            cov[m0:m1, n0:n1] += k1 - k0
    assert int(cov.min()) == K and int(cov.max()) == K
    if plan.route != ROUTE_MMA:       # the persistent grid: no idle block
        assert all(blocks) and plan.grid <= 132


# shapes small enough for exact integer products on the CPU, at every
# split count the planner picks (8, 4, 2, 1) and on every route
EMULATED = [(1, 1024, 64), (8, 1024, 200), (17, 512, 130), (40, 256, 72),
            (40, 48, 1000), (40, 1024, 8), (64, 4096, 96), (65, 16, 8),
            (129, 160, 300), (200, 1024, 129), (129, 48, 16900)]


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8))
    sx = torch.from_numpy(rng.uniform(1e-3, 2e-2, (M, 1)).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(1e-3, 2e-2, N).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    return xq, sx, wq, sw, b


def test_emulated_shapes_take_every_split_count_and_both_routes():
    plans = [plan_gemm(M, N, K) for M, K, N in EMULATED]
    assert {p.split for p in plans if p.route == ROUTE_MMA} == {1, 2, 4, 8}
    assert {p.route for p in plans} == {ROUTE_MMA, ROUTE_WGMMA,
                                        ROUTE_WGMMA_WIDE}


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("M,K,N", EMULATED, ids=_ids(EMULATED))
def test_tiled_schedule_equals_plain_bit_for_bit(M, K, N, bias):
    """The kernel's schedule (int32 partial per box, partials of a split K
    added in int32) gives int8_gemm_plain's outputs bit for bit, fp32 and
    bf16 out; extreme int8 values make the partials large."""
    xq, sx, wq, sw, b = _operands(M, K, N, M * 7 + N)
    xq[0] = 127
    wq[0] = -127
    b = b if bias else None
    for dtype in (torch.float32, torch.bfloat16):
        out = int8_gemm_tiled_plain(xq, sx, wq, sw, b, dtype)
        ref = int8_gemm_plain(xq, sx, wq, sw, b, dtype)
        assert out.dtype == dtype
        assert torch.equal(out, ref)


def test_int32_partials_reach_the_exact_sum_at_the_largest_k():
    """At K=4096 all-127 rows the sum is 127^2 * 4096 = 66064384: exact in
    int32 however the K axis is split, and equal to the float64 product."""
    M, K, N = 40, 4096, 64
    xq = torch.full((M, K), 127, dtype=torch.int8)
    wq = torch.full((N, K), -127, dtype=torch.int8)
    ones_m, ones_n = torch.ones(M, 1), torch.ones(N)
    assert plan_gemm(M, N, K).split == MAX_SPLIT
    out = int8_gemm_tiled_plain(xq, ones_m, wq, ones_n)
    assert torch.equal(out, torch.full((M, N), -127.0 ** 2 * K))


def _args(M=40, K=1024, N=64):
    return (M, K, torch.zeros(N, K, dtype=torch.int8),
            torch.ones(N), torch.zeros(N), torch.float32)


@pytest.mark.parametrize("case,error", [
    ("k_not_16", ValueError), ("k_below_16", ValueError),
    ("no_rows", ValueError), ("misaligned_weight", ValueError),
    ("strided_weight", ValueError), ("int32_weight", TypeError),
    ("fp64_scales", TypeError), ("bf16_bias", TypeError),
    ("fp16_out", TypeError), ("scales_short", ValueError),
    ("weight_k_mismatch", ValueError), ("strided_row_operand", ValueError),
])
def test_check_gemm_args_refuses(case, error):
    """What kernel G cannot survive is refused before any launch, and
    check_gemm_args sees it on CPU tensors (only metadata is read)."""
    M, K, wq, sw, b, out = _args()
    firsts = ()
    if case == "k_not_16":
        K, wq = 24, torch.zeros(64, 24, dtype=torch.int8)
    elif case == "k_below_16":
        K, wq = 8, torch.zeros(64, 8, dtype=torch.int8)
    elif case == "no_rows":
        M = 0
    elif case == "misaligned_weight":
        flat = torch.zeros(64 * K + 16, dtype=torch.int8)
        off = next(i for i in range(1, 16) if (flat.data_ptr() + i) % 16)
        wq = flat[off:off + 64 * K].view(64, K)
    elif case == "strided_weight":
        wq = torch.zeros(64, 2 * K, dtype=torch.int8)[:, :K]
    elif case == "int32_weight":
        wq = wq.int()
    elif case == "fp64_scales":
        sw = sw.double()
    elif case == "bf16_bias":
        b = b.bfloat16()
    elif case == "fp16_out":
        out = torch.float16
    elif case == "scales_short":
        sw = sw[:63]
    elif case == "weight_k_mismatch":
        wq = torch.zeros(64, 2 * K, dtype=torch.int8)
    elif case == "strided_row_operand":
        firsts = (torch.zeros(M, 2 * K, dtype=torch.int8)[:, :K],)
    with pytest.raises(error):
        check_gemm_args("int8_gemm", M, K, wq, sw, b, out, *firsts)


def test_check_gemm_args_takes_what_the_kernel_takes():
    """K=16 and 48, bf16 out, no bias, N=8 and 30265: accepted."""
    for M, K, N in [(1, 16, 8), (40, 48, 30265), (2048, 1024, 1024)]:
        wq = torch.zeros(N, K, dtype=torch.int8)
        for out in (torch.float32, torch.bfloat16):
            check_gemm_args("int8_linear", M, K, wq, torch.ones(N), None,
                            out)


def test_cpu_tensors_take_the_plain_version():
    """The device alone decides: CPU tensors never reach the kernel, and
    the launch counters stay where they were."""
    xq, sx, wq, sw, b = _operands(8, 64, 24, 0)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 4, 64)).astype(np.float32))
    counts = (quantize_rows.launches, int8_gemm.launches)
    assert torch.equal(int8_gemm(xq, sx, wq, sw, b),
                       int8_gemm_plain(xq, sx, wq, sw, b))
    assert torch.equal(int8_linear(x, wq, sw, b),
                       int8_linear_plain(x, wq, sw, b))
    assert (quantize_rows.launches, int8_gemm.launches) == counts


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", EMULATED + EDGES[:6],
                         ids=_ids(EMULATED + EDGES[:6]))
def test_kernel_equals_plain_bit_for_bit(card, M, K, N):
    """Kernel G on both routes and every split count: the quant, the GEMM
    (fp32 and bf16 out) and the one-call layer (fp32 and bf16 x) equal
    their plain versions bit for bit; one int8_linear adds one launch to
    each counter."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g).to(card)
    _, _, wq, sw, b = (t.to(card) for t in _operands(M, K, N, 3))
    xq, sx = quantize_rows(x)
    pq, ps = quantize_rows_plain(x)
    assert torch.equal(xq, pq) and torch.equal(sx, ps)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(int8_gemm(xq, sx, wq, sw, b, dtype),
                           int8_gemm_plain(xq, sx, wq, sw, b, dtype))
        xd = x.to(dtype)
        before = (quantize_rows.launches, int8_gemm.launches)
        out = int8_linear(xd, wq, sw, None)
        assert (quantize_rows.launches - before[0],
                int8_gemm.launches - before[1]) == (1, 1)
        assert torch.equal(out, int8_linear_plain(xd, wq, sw, None))


@pytest.mark.cuda
def test_wrappers_raise_on_the_card(card):
    """A CUDA tensor launches the kernel or the wrapper raises: K not a
    multiple of 16, a misaligned weight, an fp16 x."""
    x = torch.randn(4, 24, device=card)
    with pytest.raises(ValueError):
        int8_linear(x, torch.zeros(8, 24, dtype=torch.int8, device=card),
                    torch.ones(8, device=card))
    flat = torch.zeros(8 * 32 + 16, dtype=torch.int8, device=card)
    with pytest.raises(ValueError):
        int8_linear(torch.randn(4, 32, device=card),
                    flat[1:1 + 8 * 32].view(8, 32),
                    torch.ones(8, device=card))
    with pytest.raises(TypeError):
        int8_linear(torch.randn(4, 32, device=card).half(),
                    torch.zeros(8, 32, dtype=torch.int8, device=card),
                    torch.ones(8, device=card))
