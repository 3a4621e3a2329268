"""Adaptive input embeddings and adaptive softmax (counterpart of
tell_tpu/ops/adaptive.py: band_ranges, adaptive_embed, merged_embed_table,
_head_logits, _tail_logits, _xent, adaptive_softmax_loss with dense tails
or tail-capacity compaction, adaptive_log_probs, merged_decode_table,
quantize_softmax_tables and the exact path of adaptive_top_k with its
vocab_table= and quant_sm= routes).

Weights are tied as in the JAX package: the softmax reads the embedding's
band tables. Every band's row `padding_idx` is pinned to zero: in the
embedding by zeroing the row (which also zeroes its gradient), in the
softmax by multiplying the logits with a 0/1 column mask, so the padding
column's logit is exactly 0 (not -inf), as in JAX (adaptive.py:187-207).
adaptive_top_k(fused=True) is tell_tpu's TELL_TPU_TOPK route through
kernel E (_adaptive_top_k_fused); vocab_table= (merged_decode_table, its
TELL_TPU_MERGED_VOCAB) takes every cluster's logits from one fp32 matmul,
and quant_sm= (quantize_softmax_tables, its TELL_TPU_DEC8_SM) the head's
and tails' from int8 tables through kernel G. Approximate top-k is a TPU
lowering and is not ported.
"""
from __future__ import annotations

import torch

from ..parallel.comm import ONE_RANK, ModelAxis
from .common import dropout, top_k
from .kernels.int8_linear import int8_gemm
from .kernels.topk_logits import MAX_K, topk_logits
from .linear import linear
from .quant import quantize_act_int8, quantize_weight_int8


def band_ranges(cutoffs: tuple[int, ...]) -> list[tuple[int, int]]:
    """[(lo, hi)] for each band given full cutoffs ending at vocab_size."""
    out = []
    prev = 0
    for c in cutoffs:
        out.append((prev, c))
        prev = c
    return out


def _pinned_table(table: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """The band table with row padding_idx zeroed when the band has it
    (index_fill: the pinned row also gets a zero gradient)."""
    if not 0 <= padding_idx < table.shape[0]:
        return table
    return table.index_fill(0, torch.tensor([padding_idx],
                                            device=table.device), 0)


def adaptive_embed(params: dict, ids: torch.Tensor, cutoffs: tuple[int, ...],
                   output_dim: int, padding_idx: int = 0,
                   scale_embeds: bool = True, tp: ModelAxis = ONE_RANK
                   ) -> torch.Tensor:
    """ids: int tensor of any shape -> [..., output_dim] in the params'
    dtype; each band's rows are gathered, projected and summed in fp32.
    A band whose rows the rules shard over tp (tensor parallelism) looks
    up this rank's rows, the others' zero, summed over "model"."""
    out_dtype = params["bands"][0]["proj"].dtype
    ids = ids.long()
    result = torch.zeros(ids.shape + (output_dim,), dtype=torch.float32,
                         device=ids.device)
    for i, (lo, hi) in enumerate(band_ranges(cutoffs)):
        band = params["bands"][i]
        rows = band["embed"].shape[0]
        sharded = tp.split(f"/embed/bands/{i}/embed",
                           (hi - lo, band["embed"].shape[1]))
        pad = padding_idx
        if sharded:
            lo += tp.index * rows
            hi = lo + rows
            pad -= tp.index * rows
        table = _pinned_table(band["embed"], pad)
        e = table[(ids - lo).clamp(0, hi - lo - 1)]
        in_band = ((ids >= lo) & (ids < hi))[..., None]
        e = torch.where(in_band, e, torch.zeros((), dtype=e.dtype,
                                                device=e.device))
        if sharded:
            e = tp.reduce(e)
        result = result + torch.matmul(e, band["proj"]).float()
    if scale_embeds:
        result = result * (output_dim ** 0.5)
    return result.to(out_dtype)


def merged_embed_table(params: dict, cutoffs: tuple[int, ...],
                       output_dim: int, padding_idx: int = 0,
                       scale_embeds: bool = True) -> torch.Tensor:
    """[V, output_dim] dense table equal to the adaptive embedding row by
    row: decode gathers one row per token instead of the banded
    gather + projection chain."""
    rows = []
    for i, (lo, hi) in enumerate(band_ranges(cutoffs)):
        band = params["bands"][i]
        table = _pinned_table(band["embed"], padding_idx)
        rows.append(torch.matmul(table, band["proj"]).float())
    full = torch.cat(rows, dim=0)
    if scale_embeds:
        full = full * (output_dim ** 0.5)
    return full.to(params["bands"][0]["proj"].dtype)


def whole_bands(params: dict, cutoffs: tuple[int, ...],
                tp: ModelAxis = ONE_RANK) -> dict:
    """The embedding with every band's table whole, for the tied softmax,
    which every rank then computes alike: a band whose rows the rules
    shard over tp is gathered (its gradient back to the shard)."""
    bands = [{**band, "embed": tp.whole(
        band["embed"], 0, tp.split(f"/embed/bands/{i}/embed",
                                   (hi - lo, band["embed"].shape[1])))}
             for i, (band, (lo, hi)) in enumerate(zip(params["bands"],
                                                      band_ranges(cutoffs)))]
    return {**params, "bands": bands}


def _pad_col_mask(n: int, padding_idx: int, device) -> torch.Tensor | None:
    """[n] fp32 ones with a 0 at padding_idx: multiplying the logits by it
    equals zeroing the table's padding row before the matmul."""
    if not 0 <= padding_idx < n:
        return None
    m = torch.ones(n, dtype=torch.float32, device=device)
    m[padding_idx] = 0.0
    return m


def _head_logits(sm: dict, emb: dict, x: torch.Tensor,
                 padding_idx: int = 0) -> torch.Tensor:
    """[N, cutoff0 + n_tails]: band-0 word logits ++ tail-cluster logits."""
    table = emb["bands"][0]["embed"]
    word = torch.matmul(x, table.T).float()
    m = _pad_col_mask(table.shape[0], padding_idx, x.device)
    if m is not None:
        word = word * m
    cls = linear(sm["class_proj"], x)
    return torch.cat([word, cls.to(word.dtype)], dim=-1)


def _tail_logits(sm: dict, emb: dict, x: torch.Tensor, i: int,
                 padding_idx: int = 0, drop_rate: float = 0.0,
                 gen: torch.Generator | None = None,
                 deterministic: bool = True) -> torch.Tensor:
    """Tail cluster i (band i+1) logits for rows x: [N, band_size]."""
    h = linear(sm["tail_projs"][i], x)
    h = dropout(h, drop_rate, gen, deterministic)
    table = emb["bands"][i + 1]["embed"]
    out = torch.matmul(h, table.T).float()
    m = _pad_col_mask(table.shape[0], padding_idx, x.device)
    return out if m is None else out * m


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy in fp32. targets: [N] int64."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = torch.gather(logits, -1, targets[:, None])[:, 0]
    return lse - picked.float()


def adaptive_softmax_loss(sm: dict, emb: dict, x: torch.Tensor,
                          targets: torch.Tensor, cutoffs: tuple[int, ...],
                          pad_id: int = 1, padding_idx: int = 0,
                          tail_capacity: tuple[int, ...] | None = None,
                          drop_rate: float = 0.0,
                          gen: torch.Generator | None = None,
                          deterministic: bool = True, tail_group=None
                          ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Summed cross entropy over the head and the tail clusters.
    x: [N, D] decoder outputs, targets: [N] token ids. Returns (loss_sum,
    sample_size = non-pad token count, {"tail_dropped": overflow rows}).

    tail_capacity: static per-tail row budgets. In-band rows are compacted
    to the front with a stable argsort and gathered, so the tail matmul
    runs on `cap` rows instead of N; rows past the budget keep only their
    head loss and are counted in tail_dropped (tell_tpu's compaction,
    adaptive.py:271-284). None: dense tails over every row.
    tail_group: the data-parallel ranks whose rows, in rank order, are the
    global batch (None: this call holds all of it); tail_capacity is then
    the global batch's budget, and a rank's in-band rows are taken while
    the ranks before it have not used it up, as one rank takes the first
    `cap` in-band rows of the whole batch."""
    ranges = band_ranges(cutoffs)
    c0 = ranges[0][1]
    targets = targets.long()
    not_pad = targets != pad_id
    x = dropout(x, drop_rate, gen, deterministic)
    # head: targets in tail band i are remapped to class slot c0 + i
    head_t = targets
    for i, (lo, hi) in enumerate(ranges[1:]):
        head_t = torch.where((targets >= lo) & (targets < hi), c0 + i,
                             head_t)
    head_ce = _xent(_head_logits(sm, emb, x, padding_idx), head_t)
    loss = (head_ce * not_pad).sum()
    n_dropped = torch.zeros((), dtype=torch.long, device=x.device)
    for i, (lo, hi) in enumerate(ranges[1:]):
        in_band = (targets >= lo) & (targets < hi) & not_pad
        if tail_capacity is None:
            tl = _tail_logits(sm, emb, x, i, padding_idx, drop_rate, gen,
                              deterministic)
            ce = _xent(tl, (targets - lo).clamp(0, hi - lo - 1))
            loss = loss + (ce * in_band).sum()
            continue
        cap = tail_capacity[i]
        idx = torch.argsort((~in_band).int(), stable=True)[:cap]
        valid = in_band[idx]
        if tail_group is not None:
            from ..parallel.comm import all_gather, rank
            counts = all_gather(in_band.sum(), tail_group)
            before = counts[:rank(tail_group)].sum()
            valid = valid & (before + torch.arange(
                len(idx), device=x.device) < cap)
        tl = _tail_logits(sm, emb, x[idx], i, padding_idx, drop_rate, gen,
                          deterministic)
        ce = _xent(tl, (targets[idx] - lo).clamp(0, hi - lo - 1))
        loss = loss + (ce * valid).sum()
        n_dropped = n_dropped + in_band.sum() - valid.sum()
    return loss, not_pad.sum(), {"tail_dropped": n_dropped}


def adaptive_log_probs(sm: dict, emb: dict, x: torch.Tensor,
                       cutoffs: tuple[int, ...],
                       padding_idx: int = 0) -> torch.Tensor:
    """Full-vocabulary log-probs [N, V] fp32 (tell_tpu's
    adaptive_log_probs): head log-softmax for band 0, and for tail i the
    tail's log-softmax plus the head's log-prob of cluster i."""
    ranges = band_ranges(cutoffs)
    c0 = ranges[0][1]
    head = torch.log_softmax(_head_logits(sm, emb, x, padding_idx).float(),
                             dim=-1)
    parts = [head[:, :c0]]
    for i in range(len(ranges) - 1):
        tl = torch.log_softmax(
            _tail_logits(sm, emb, x, i, padding_idx).float(), dim=-1)
        parts.append(tl + head[:, c0 + i, None])
    return torch.cat(parts, dim=-1)


def _fp32_table_math():
    """The tables' collapsed tail products P_i @ T_i^T in full fp32 on the
    card, TF32 off whatever the global switch says: TF32 would move the
    values the int8 tables round to (models/backbones' pin)."""
    from ..models.backbones import fp32_math
    return fp32_math()


def _pad_cols(padding_idx: int, c0: int, ranges) -> list[int]:
    """Each block's padding column in the merged table's layout: band 0's
    words, the class logits, then each tail band."""
    cols = [padding_idx] if 0 <= padding_idx < c0 else []
    off = c0 + len(ranges) - 1
    for lo, hi in ranges[1:]:
        if 0 <= padding_idx < hi - lo:
            cols.append(off + padding_idx)
        off += hi - lo
    return cols


def merged_decode_table(sm: dict, emb: dict, cutoffs: tuple[int, ...],
                        padding_idx: int = 0) -> torch.Tensor:
    """One fp32 [D, c0 + n_tails + sum(tail bands)] table for the decode's
    top-k (tell_tpu's merged_decode_table): band 0's words ++ the class
    logits ++ each tail band. Tail i's chain (x @ P_i) @ T_i^T collapses to
    x @ (P_i @ T_i^T), exact up to float reassociation (no bias in the
    chain); each block's padding column is zeroed as _pad_col_mask does.
    Built once a decode call, and kept fp32 whatever the compute dtype."""
    ranges = band_ranges(cutoffs)
    c0 = ranges[0][1]
    with _fp32_table_math():
        blocks = [emb["bands"][0]["embed"].T.float(),
                  sm["class_proj"]["w"].float()]
        for i in range(len(ranges) - 1):
            blocks.append(torch.matmul(sm["tail_projs"][i]["w"].float(),
                                       emb["bands"][i + 1]["embed"].float().T))
    w = torch.cat(blocks, dim=1)
    cols = _pad_cols(padding_idx, c0, ranges)
    if cols:
        w[:, cols] = 0.0
    return w


def quantize_softmax_tables(sm: dict, emb: dict, cutoffs: tuple[int, ...],
                            padding_idx: int = 0) -> dict:
    """int8 decode softmax tables, built once a decode call (tell_tpu's
    quantize_softmax_tables), in the split chain's layout: "head" band 0's
    table^T and each of "tails" its collapsed P_i @ T_i^T, each a
    quantize_weight_int8 dict ({"q8": int8 [band, D], "scale": fp32
    [band]}) whose padding column is zeroed through its scale (0 times any
    sum is 0); "class_w" the fp32 class projection [D, n_tails] (too small
    to quantise)."""
    ranges = band_ranges(cutoffs)

    def q(table_t):
        w = quantize_weight_int8(table_t)
        if 0 <= padding_idx < table_t.shape[1]:
            w["scale"][padding_idx] = 0.0
        return w

    head = q(emb["bands"][0]["embed"].T.float())
    tails = []
    for i in range(len(ranges) - 1):
        with _fp32_table_math():
            t = torch.matmul(sm["tail_projs"][i]["w"].float(),
                             emb["bands"][i + 1]["embed"].float().T)
        tails.append(q(t))
    return {"head": head, "tails": tails,
            "class_w": sm["class_proj"]["w"].float()}


def adaptive_top_k(sm: dict, emb: dict, x: torch.Tensor,
                   cutoffs: tuple[int, ...], k: int, padding_idx: int = 0,
                   fused: bool = False,
                   vocab_table: torch.Tensor | None = None,
                   quant_sm: dict | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of the full factored distribution without building the
    [N, V] log-probs: per-cluster top-k on raw logits, each shifted by its
    cluster's log-normaliser and prior, then a top-k over the candidates.
    fused (k <= 8, as in JAX) streams each cluster through kernel E
    instead, so not even one cluster's logits reach device memory.

    vocab_table (merged_decode_table): every cluster's logits from one
    [N, D] x [D, V + n_tails] fp32 matmul, the head and tail blocks its
    slices; the table bakes in its build's padding_idx. quant_sm
    (quantize_softmax_tables): one activation quant of x, then the head's
    and each tail's logits through kernel G's int8 GEMM, the class logits
    in fp32. As in tell_tpu, the merged table wins over the int8 tables,
    and either one turns the fused route off. Returns (log_probs [N, k]
    fp32, token_ids [N, k] int64)."""
    ranges = band_ranges(cutoffs)
    # tell_tpu also requires N * 2048 * 4 bytes < 8 MiB, a TPU VMEM bound
    # on its tile of logits (adaptive.py:440-443); kernel E's partials live
    # in device memory, so the port drops that condition.
    if fused and k <= MAX_K and vocab_table is None and quant_sm is None:
        return _adaptive_top_k_fused(sm, emb, x, ranges, k, padding_idx)
    c0 = ranges[0][1]
    n_tails = len(ranges) - 1
    xq = sx = logits_all = None
    if vocab_table is not None:
        logits_all = torch.matmul(x.float(), vocab_table)
        head_logits = logits_all[:, :c0 + n_tails]
        tail_off = c0 + n_tails
    elif quant_sm is not None:
        xq, sx = quantize_act_int8(x)
        word = int8_gemm(xq, sx, quant_sm["head"]["q8"],
                         quant_sm["head"]["scale"])
        cls = torch.matmul(x.float(), quant_sm["class_w"])
        head_logits = torch.cat([word, cls], dim=-1)
    else:
        head_logits = _head_logits(sm, emb, x, padding_idx).float()
    head_lse = torch.logsumexp(head_logits, dim=-1)
    vals, ids = torch.topk(head_logits[:, :c0], k, dim=-1)
    all_vals = [vals - head_lse[:, None]]
    all_ids = [ids]
    for i, (lo, hi) in enumerate(ranges[1:]):
        if logits_all is not None:
            tl = logits_all[:, tail_off:tail_off + hi - lo]
            tail_off += hi - lo
        elif xq is not None:
            t8 = quant_sm["tails"][i]
            tl = int8_gemm(xq, sx, t8["q8"], t8["scale"])
        else:
            tl = _tail_logits(sm, emb, x, i, padding_idx).float()
        lse = torch.logsumexp(tl, dim=-1)
        tv, ti = torch.topk(tl, min(k, hi - lo), dim=-1)
        prior = head_logits[:, c0 + i] - head_lse
        all_vals.append(tv - lse[:, None] + prior[:, None])
        all_ids.append(ti + lo)
    cat_vals = torch.cat(all_vals, dim=-1)
    cat_ids = torch.cat(all_ids, dim=-1)
    final_vals, pos = top_k(cat_vals, k)
    return final_vals, torch.gather(cat_ids, -1, pos)


def _adaptive_top_k_fused(sm: dict, emb: dict, x: torch.Tensor, ranges,
                          k: int, padding_idx: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """tell_tpu's _adaptive_top_k_fused: per cluster, kernel E's streamed
    logits + top-k + logsumexp (topk_logits_plain on the CPU). The head's
    tail-cluster logits are a small [N, n_tails] matmul that folds into the
    head normaliser with one logaddexp. Each band's padding row is zeroed by
    index inside the kernel (zero_row) rather than in a copy of the table."""
    c0 = ranges[0][1]
    table0 = emb["bands"][0]["embed"].to(x.dtype)
    wv, wi, lse_w = topk_logits(x.contiguous(), table0.contiguous(), k,
                                zero_row=padding_idx)
    cls = linear(sm["class_proj"], x).float()             # [N, n_tails]
    head_lse = torch.logaddexp(lse_w, torch.logsumexp(cls, dim=-1))
    all_vals = [wv - head_lse[:, None]]
    all_ids = [wi.long()]
    for i, (lo, hi) in enumerate(ranges[1:]):
        h = linear(sm["tail_projs"][i], x)
        table = emb["bands"][i + 1]["embed"].to(h.dtype)
        tv, ti, lse_t = topk_logits(h.contiguous(), table.contiguous(),
                                    min(k, hi - lo), zero_row=padding_idx)
        prior = cls[:, i] - head_lse
        all_vals.append(tv - lse_t[:, None] + prior[:, None])
        all_ids.append(ti.long() + lo)
    cat_vals = torch.cat(all_vals, dim=-1)
    cat_ids = torch.cat(all_ids, dim=-1)
    final_vals, pos = top_k(cat_vals, k)
    return final_vals, torch.gather(cat_ids, -1, pos)
