"""Kernel E: streamed logits + exact top-k + logsumexp.

Replaces tell_tpu/ops/kernels/topk_logits.py::topk_logits (pallas_call at
:126) with tell_tpu_torch/csrc/topk_logits.cu. The adaptive softmax's
decode top-k calls it once per cluster when asked to (ops/adaptive.py,
fused=True).

What bounds it on the H100: reading the table (V*D elements) at small N,
the 2*N*V*D operations at large N. The design takes two passes, because
Hopper has no sequential grid to carry a running top-k across vocabulary
tiles: a grid of (row tile x CHUNK-entry vocabulary chunk) blocks streams
the chunk's table rows and the tile's x rows through a cp.async ring,
computes the logits tile and writes each row's chunk top-k and (max, sum
of exp); a merge kernel reduces those per row. The [N, V] logits never
reach device memory. The chunk and the order of a row's sums are set by V
and D alone, so a row's results are the same bits among any N rows;
topk_logits_tiled models the schedule in PyTorch for the tests. See the
source's header for the design.
"""
from __future__ import annotations

import collections

import torch

from ..common import top_k
from .build import check_launch, load_library
from .dispatch import check_kernel_args, use_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 8
CHUNK = 128  # vocabulary entries per pass-1 block (csrc kChunk)


def topk_logits_plain(x: torch.Tensor, table: torch.Tensor, k: int,
                      zero_row: int = -1
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (tell_tpu's reference_topk_logits): fp32
    logits x @ table.T, their logsumexp, and the top-k with the lower id
    first on ties. zero_row >= 0 sets that vocabulary entry's logit to 0
    (the adaptive softmax's pinned padding row)."""
    logits = x.float() @ table.float().T
    if 0 <= zero_row < table.shape[0]:
        logits[:, zero_row] = 0.0
    vals, ids = top_k(logits, k)
    return vals, ids.to(torch.int32), torch.logsumexp(logits, dim=-1)


def topk_logits_tiled(x: torch.Tensor, table: torch.Tensor, k: int,
                      zero_row: int = -1
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel E's schedule in plain PyTorch, for the tests: per CHUNK-entry
    vocabulary chunk the fp32 logits (zero_row's pinned to 0), their (max,
    sum of exp) and top-k with the lower id first on ties; then the merge:
    the k best candidates in (value desc, id asc) order, and lse = M + log
    sum_c s_c exp(m_c - M) with M the largest chunk max."""
    xf = x.float()
    cand_v, cand_i, ms, ss = [], [], [], []
    for v0 in range(0, table.shape[0], CHUNK):
        logits = xf @ table[v0:v0 + CHUNK].float().T
        if v0 <= zero_row < v0 + logits.shape[1]:
            logits[:, zero_row - v0] = 0.0
        m = logits.amax(-1)
        ms.append(m)
        ss.append(torch.exp(logits - m[:, None]).sum(-1))
        vals, ids = top_k(logits, min(k, logits.shape[1]))
        cand_v.append(vals)
        cand_i.append(ids + v0)
    # the candidates come in id order within a chunk's ties and chunk order
    # across them, so a stable sort by value gives (value desc, id asc)
    vals, pos = top_k(torch.cat(cand_v, dim=1), k)
    ids = torch.cat(cand_i, dim=1).gather(1, pos)
    m, s = torch.stack(ms, 1), torch.stack(ss, 1)
    big = m.amax(1)
    lse = big + torch.log((s * torch.exp(m - big[:, None])).sum(1))
    return vals, ids.to(torch.int32), lse


def topk_logits(x: torch.Tensor, table: torch.Tensor, k: int,
                zero_row: int = -1
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [N, D], table: [V, D] (same dtype, fp32 or bf16), 1 <= k <= 8.
    Returns (top-k logits [N, k] fp32 descending, their ids [N, k] int32,
    logsumexp [N] fp32). CUDA tensors launch kernel E (counted in
    topk_logits.launches, and by k in .ks[k]); the kernel loads 16-byte pieces, so it takes D a
    multiple of 8 and x and table on 16-byte boundaries, and raises
    ValueError otherwise. CPU tensors take topk_logits_plain."""
    if not use_kernel(x, table):
        return topk_logits_plain(x, table, k, zero_row)
    if x.ndim != 2 or table.ndim != 2 or x.shape[1] != table.shape[1]:
        raise ValueError(f"topk_logits: x {tuple(x.shape)} and table "
                         f"{tuple(table.shape)} are not [N, D] and [V, D]")
    N, D = x.shape
    V = table.shape[0]
    if not 1 <= k <= min(MAX_K, V):
        raise ValueError(f"topk_logits: k={k} outside [1, min({MAX_K}, "
                         f"V={V})]")
    if N < 1:
        raise ValueError("topk_logits: x has no rows")
    check_kernel_args("topk_logits", {"x": x, "table": table},
                      {"x": tuple(_DTYPE_CODE), "table": (x.dtype,)})
    if D % 8:
        raise ValueError(f"topk_logits: D={D} is not a multiple of 8 (the "
                         "kernel loads 16-byte pieces of a row)")
    for name, t in (("x", x), ("table", table)):
        if t.data_ptr() % 16:
            raise ValueError(f"topk_logits: {name} is not 16-byte aligned "
                             "(the kernel loads 16-byte pieces of a row)")
    C = -(-V // CHUNK)
    f32 = dict(dtype=torch.float32, device=x.device)
    i32 = dict(dtype=torch.int32, device=x.device)
    pv, pi = torch.empty(N, C, k, **f32), torch.empty(N, C, k, **i32)
    pm, ps = torch.empty(N, C, **f32), torch.empty(N, C, **f32)
    vals, ids = torch.empty(N, k, **f32), torch.empty(N, k, **i32)
    lse = torch.empty(N, **f32)
    lib = load_library()
    with torch.cuda.device(x.device):
        code = lib.tt_topk_logits(
            x.data_ptr(), table.data_ptr(), pv.data_ptr(), pi.data_ptr(),
            pm.data_ptr(), ps.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            lse.data_ptr(), N, V, D, k, zero_row if 0 <= zero_row < V else -1,
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    check_launch(lib, "topk_logits", code)
    topk_logits.launches += 1
    topk_logits.ks[k] += 1
    return vals, ids, lse


topk_logits.launches = 0
topk_logits.ks = collections.Counter()
