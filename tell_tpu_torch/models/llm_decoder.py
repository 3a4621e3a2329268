"""The modern captioning LM (counterpart of tell_tpu/models/
llm_decoder.py): rms_norm, rope_cos_sin, apply_rope, the blocks of the
full-sequence path and of the decode step, llm_forward, llm_xent,
llm_loss, llm_loss_e2e, _build_contexts, modern_encode_contexts,
init_llm_decode_state, llm_decoder_step, tied_log_probs, tied_top_k,
llm_generate and llm_beam_search, and the pipelined forward and loss
(stack_llm_layers, llm_pp_sharding, llm_forward_pp, llm_loss_pp over
parallel/pipeline.py). LLMConfig is in config.py and init_llm_decoder in
bridge.py.

    x = x + o(self_attn(rms(x)))             causal, RoPE, GQA, K/V cache
    x = x + context_fc(concat_m cross_attn_m(rms(x)))    four contexts
    x = x + ffn(rms(x))                      SwiGLU, or top-k MoE
    log p = log_softmax(rms(x) @ tok_embed^T)          tied, full vocab

* RoPE is half-split (rotate the first half of each head against its
  second), cos and sin in fp32 from the positions.
* GQA: query head h reads K/V head h // (H / KV); the step groups the
  queries [R, KV, H/KV, hd] against the [R, T, KV, hd] cache, which is
  that mapping without copying K/V.
* The self-K/V cache is [R, gen_len + 1, KV, hd], masked by arange(T) <=
  step. `step` is a scalar tensor in generate and beam search, and one
  position per row in the engine. tell_tpu's dynamic_update_slice clamps
  a position past T - 1; the port writes with index_copy_ / indexing,
  which raise there (a device-side assert on CUDA), and the setup refuses
  a gen_len past max_target_positions before decoding.
* The cross block is the flagship's stacked core
  (decoder.stacked_attention_core: kernel A over an fp cache, kernel D
  over an int8/int4 one) with no per-branch residual or LayerNorm; the
  branches are concatenated in context order into context_fc.
* The MoE runs at capacity_factor = moe_experts while decoding, so no
  row is dropped and a caption does not depend on its batch-mates.
* The head is an exact fp32 top-k over all vocab_size logits with
  logsumexp; ties go to the lower id, as lax.top_k's.
* The article context is RoBERTa's final hidden state (no layer sum):
  kernel B runs in its encode.
* Training runs the layers over the whole caption: causal self-attention
  with RoPE from arange(T) and the K/V heads repeated for GQA (no key-pad
  mask, as tell_tpu's), the contexts' plain cross-attention, the MoE at
  moe_capacity_factor with the caption's pads taking no slot. The loss
  streams the tied head over the vocabulary in loss_vocab_chunk columns
  with an online logsumexp, so the [N, V] logits are never built in the
  forward (autograd keeps each chunk's for the backward, as lax.scan's
  residuals are). Dropout draws from fold_in generators laid out as
  tell_tpu's fold_in keys: one stream per call site.
* Under tensor parallelism (the `tp` argument, a parallel/comm.py
  ModelAxis of more than one rank; ONE_RANK, the default, shards
  nothing and is the one-rank forward) a rank
  runs its query and K/V heads with o's rows, SwiGLU's w1/w3 columns
  and w2 rows, the cross-attention split as the flagship's, its
  tok_embed rows in a masked lookup summed over "model", and llm_xent
  vocabulary-parallel; the MoE runs its experts (ops/moe.py). With a
  data-parallel group the MoE routes over the global batch.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..bridge import tree_leaves_with_path
from ..config import LLMConfig
from ..ops.common import dropout, fold_in, top_k
from ..ops.linear import linear
from ..ops.moe import moe_ffn
from ..parallel.comm import ONE_RANK, ModelAxis, SumOverRanks, all_reduce
from .backbones.resnet import resnet_forward
from .backbones.roberta import roberta_encode_windowed
from .backbones.vit import vit_encode
from .beam import beam_search_core
from .captioner import mask_nan_embeds
from .decoder import (attn_segment_bounds, precompute_context_kv_cat,
                      row_parallel_linear, split_attn_segments,
                      stacked_attention_core, tp_attend, tp_context_kv,
                      tp_cross_attention)


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r * p["scale"]).to(x.dtype)


@functools.lru_cache(maxsize=8)
def _inv_freq(head_dim: int, theta: float, device: torch.device
              ) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] int -> cos, sin [..., head_dim // 2] fp32."""
    ang = positions.float()[..., None] * _inv_freq(head_dim, theta,
                                                   positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., T, H, hd]; cos, sin [..., T, hd // 2] (broadcast over H)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def _step_positions(cfg: LLMConfig, step: torch.Tensor, T: int) -> dict:
    """What every layer's self-attention step shares: RoPE's cos and sin
    at the step (a scalar, or [R] per row), and the cache rows it may
    read (arange(T) <= step)."""
    per_row = step.ndim == 1
    cos, sin = rope_cos_sin(step[:, None] if per_row else step.reshape(1),
                            cfg.head_dim, cfg.rope_theta)
    cols = torch.arange(T, device=step.device)
    valid = ((cols[None] <= step[:, None])[:, None, None] if per_row
             else cols <= step)
    return {"step": step, "per_row": per_row, "cos": cos, "sin": sin,
            "valid": valid}


def _self_attn_step(sp: dict, cfg: LLMConfig, x: torch.Tensor, cache: dict,
                    pos: dict, row_gather: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict]:
    """One token's causal self-attention against the cache. x [R, E];
    cache {k, v: [R, T, KV, hd]}, read through row_gather [R] (beam
    parents) where given; pos: _step_positions' dict. Without row_gather
    the new position is written into the cache in place (no caller reads
    the state it passed in again); with it, into the fresh gathered
    cache."""
    R, E = x.shape
    H, hd, KV = cfg.num_heads, cfg.head_dim, cfg.kv_heads
    step = pos["step"]
    q = linear(sp["q"], x).reshape(R, 1, H, hd)
    k = linear(sp["k"], x).reshape(R, 1, KV, hd)
    v = linear(sp["v"], x).reshape(R, KV, hd)
    q = apply_rope(q, pos["cos"], pos["sin"])[:, 0]             # [R, H, hd]
    k = apply_rope(k, pos["cos"], pos["sin"])[:, 0]             # [R, KV, hd]
    ck, cv = cache["k"], cache["v"]
    if row_gather is not None:
        ck, cv = ck[row_gather], cv[row_gather]
    if pos["per_row"]:
        rows = torch.arange(R, device=x.device)
        ck[rows, step] = k.to(ck.dtype)
        cv[rows, step] = v.to(cv.dtype)
    else:
        ck.index_copy_(1, step.reshape(1), k[:, None].to(ck.dtype))
        cv.index_copy_(1, step.reshape(1), v[:, None].to(cv.dtype))
    valid = pos["valid"]
    qg = q.reshape(R, KV, H // KV, hd)
    scores = torch.einsum("rkgd,rtkd->rkgt", qg.float(), ck.float()) \
        * (hd ** -0.5)
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("rkgt,rtkd->rkgd", probs.float(), cv.float())
    return linear(sp["o"], o.to(x.dtype).reshape(R, E)), {"k": ck, "v": cv}


def _cross_block_step(lp: dict, cfg: LLMConfig, x: torch.Tensor, cat: dict,
                      B: int, need_weights: bool
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The contexts' stacked attention (kernel A or D), the branches
    concatenated in context order, context_fc; no per-branch residual or
    LayerNorm. x [R, E] -> (out [R, E], probs [B, M, G, S] or None)."""
    R, E = x.shape
    out, probs = stacked_attention_core(cfg.num_heads, x.reshape(B, R // B, E),
                                        cat, need_weights)
    return linear(lp["context_fc"], out.transpose(1, 2).reshape(R, -1)), \
        probs


def _ffn(lp: dict, cfg: LLMConfig, x: torch.Tensor, no_drop: bool = False,
         token_mask: torch.Tensor | None = None, group=None,
         tp: ModelAxis = ONE_RANK) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense SwiGLU or the MoE (cfg.moe_experts) -> (out, MoE aux loss, 0
    when dense). no_drop (decoding) raises the capacity so that no row is
    dropped; token_mask keeps pads from taking expert capacity; group: the
    data-parallel ranks the MoE routes over. Under tensor parallelism w1
    and w3 are column shards and w2 row shards (summed over "model"), and
    the MoE's experts are this rank's (ops/moe.py)."""
    if cfg.moe_experts:
        shape = x.shape
        cf = float(cfg.moe_experts) if no_drop else cfg.moe_capacity_factor
        out, aux = moe_ffn(lp, x.reshape(-1, shape[-1]), top_k=cfg.moe_top_k,
                           capacity_factor=cf,
                           token_mask=(None if token_mask is None
                                       else token_mask.reshape(-1)),
                           group=group, tp=tp)
        return out.reshape(shape), aux
    zero = torch.zeros((), device=x.device)
    if tp.split("/ffn/w1/w", (cfg.dim, cfg.ffn_dim)):
        x = tp.enter(x)
        h = F.silu(linear(lp["w1"], x).float()).to(x.dtype)
        return row_parallel_linear(lp["w2"], h * linear(lp["w3"], x),
                                   tp), zero
    h = F.silu(linear(lp["w1"], x).float()).to(x.dtype)
    return linear(lp["w2"], h * linear(lp["w3"], x)), zero


# ---------------------------------------------------------------------------
# teacher-forced forward and loss (training)
# ---------------------------------------------------------------------------

def _self_attn_full(sp: dict, cfg: LLMConfig, x: torch.Tensor,
                    gen: torch.Generator | None = None,
                    deterministic: bool = True, tp: ModelAxis = ONE_RANK
                    ) -> torch.Tensor:
    """Causal self-attention over the whole sequence. x [B, T, E]. The K/V
    heads are repeated to the query heads (query head h reads K/V head
    h // (H / KV), as the decode step's grouping); fp32 scores, dropout
    on the probabilities."""
    B, T, E = x.shape
    H, hd, KV = cfg.num_heads, cfg.head_dim, cfg.kv_heads
    sp, x, H, KV, shard = _tp_self_attn(sp, cfg, x, tp)
    q = linear(sp["q"], x).reshape(B, T, H, hd)
    k = linear(sp["k"], x).reshape(B, T, KV, hd)
    v = linear(sp["v"], x).reshape(B, T, KV, hd)
    cos, sin = rope_cos_sin(torch.arange(T, device=x.device), hd,
                            cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
        * (hd ** -0.5)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    probs = dropout(probs, cfg.attention_dropout, gen, deterministic,
                    shard=shard)
    o = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
    o = o.to(x.dtype).reshape(B, T, H * hd)
    if shard is not None:
        return row_parallel_linear(sp["o"], o, tp)
    return linear(sp["o"], o)


def _tp_self_attn(sp: dict, cfg: LLMConfig, x: torch.Tensor,
                  tp: ModelAxis):
    """(params, input, query heads, K/V heads, dropout shard) of this
    rank's self-attention: its query and K/V heads' columns and o's rows
    where the rules shard the projections and the K/V heads divide over
    "model" (GQA keeps each query head with its K/V head); otherwise
    every leaf whole (a shard gathered) and no shard."""
    E = x.shape[-1]
    H, hd, KV = cfg.num_heads, cfg.head_dim, cfg.kv_heads
    q_split = tp.split("/self_attn/q/w", (E, H * hd))
    kv_split = tp.split("/self_attn/k/w", (E, KV * hd))
    if q_split and kv_split and KV % tp.size == 0:
        return (sp, tp.enter(x), H // tp.size, KV // tp.size,
                tp.shard(2))
    # o's rows divide as q's columns do
    whole = {n: {**sp[n], "w": tp.whole(sp[n]["w"], 0 if n == "o" else 1,
                                        kv_split if n in ("k", "v")
                                        else q_split)}
             for n in ("q", "k", "v", "o")}
    return whole, x, H, KV, None


def _cross_block_full(lp: dict, cfg: LLMConfig, x: torch.Tensor,
                      contexts: dict, gen: torch.Generator | None = None,
                      deterministic: bool = True, tp: ModelAxis = ONE_RANK
                      ) -> torch.Tensor:
    """Each context's plain cross-attention over the whole sequence (its
    own dropout stream, fold_in(gen, j)), split as the flagship's under
    tp, the branches concatenated in context order into context_fc. x
    [B, T, E]."""
    branches = []
    for j, spec in enumerate(cfg.contexts):
        a = tp_cross_attention(lp["attn"][spec.name], cfg.num_heads, tp)
        k, v, kmask = tp_context_kv(a, *contexts[spec.name], tp)
        branches.append(tp_attend(a, x, k, v, kmask, cfg, fold_in(gen, j),
                                  deterministic, tp))
    return linear(lp["context_fc"], torch.cat(branches, dim=-1))


def _layer_full(lp: dict, cfg: LLMConfig, x: torch.Tensor, contexts: dict,
                gen: torch.Generator | None = None,
                deterministic: bool = True,
                token_mask: torch.Tensor | None = None, group=None,
                tp: ModelAxis = ONE_RANK
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer over the whole sequence -> (x, the MoE aux loss, 0 when
    dense). token_mask [B, T] (True = not pad) keeps pads out of the MoE's
    capacity and statistics; group: the data-parallel ranks the MoE
    routes over; tp: the "model" axis."""
    h = rms_norm(lp["attn_norm"], x, cfg.rms_eps)
    x = x + dropout(_self_attn_full(lp["self_attn"], cfg, h,
                                    fold_in(gen, 9), deterministic, tp),
                    cfg.dropout, gen, deterministic)
    h = rms_norm(lp["cross_norm"], x, cfg.rms_eps)
    out = _cross_block_full(lp, cfg, h, contexts, fold_in(gen, 10),
                            deterministic, tp)
    x = x + dropout(out, cfg.dropout, fold_in(gen, 1), deterministic)
    h = rms_norm(lp["ffn_norm"], x, cfg.rms_eps)
    f, moe_aux = _ffn(lp["ffn"], cfg, h, token_mask=token_mask, group=group,
                      tp=tp)
    x = x + dropout(f, cfg.dropout, fold_in(gen, 2), deterministic)
    return x, moe_aux


def llm_forward(params: dict, cfg: LLMConfig, ids: torch.Tensor,
                contexts: dict, gen: torch.Generator | None = None,
                deterministic: bool = True, group=None,
                tp: ModelAxis = ONE_RANK
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Teacher-forced forward. ids [B, T] -> (features [B, T, E], each
    layer's MoE aux loss). group: the data-parallel ranks the MoE routes
    over (None: this call's batch alone); tp: the "model" axis."""
    x = _embed_tokens(params["tok_embed"], ids.long(), cfg.vocab_size, tp)
    x = dropout(x, cfg.dropout, fold_in(gen, 0), deterministic)
    token_mask = ids != cfg.pad_id
    aux = []
    for i, lp in enumerate(params["layers"]):
        x, a = _layer_full(lp, cfg, x, contexts, fold_in(gen, 1 + i),
                           deterministic, token_mask, group, tp)
        aux.append(a)
    return rms_norm(params["final_norm"], x, cfg.rms_eps), aux


def _vocab_first_row(table: torch.Tensor, V: int, tp: ModelAxis
                     ) -> int | None:
    """This rank's first row where the rules shard the tied table's V
    vocabulary rows over tp, else None (the table whole)."""
    if not tp.split("/tok_embed", (V, table.shape[1])):
        return None
    return tp.index * table.shape[0]


def _embed_tokens(table: torch.Tensor, ids: torch.Tensor, V: int,
                  tp: ModelAxis = ONE_RANK) -> torch.Tensor:
    """The tied table's rows of ids; over a vocabulary shard, this rank's
    rows looked up, the others' zero, summed over "model"."""
    lo = _vocab_first_row(table, V, tp)
    if lo is None:
        return F.embedding(ids, table)
    rows = table.shape[0]
    e = F.embedding((ids - lo).clamp(0, rows - 1), table)
    here = ((ids >= lo) & (ids < lo + rows))[..., None]
    return tp.reduce(torch.where(here, e, torch.zeros((), dtype=e.dtype,
                                                      device=e.device)))


def llm_xent(params: dict, cfg: LLMConfig, feats: torch.Tensor,
             targets: torch.Tensor, tp: ModelAxis = ONE_RANK
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tied-head cross entropy over vocabulary chunks. feats [N, E],
    targets [N] -> (the summed loss in nats over non-pad targets, their
    count). Each chunk of loss_vocab_chunk rows of the table updates a
    running max and sum of exponentials, and the chunk that holds a
    target gives its logit. tell_tpu pads the table to whole chunks and
    masks the pad columns to -inf; the port's last chunk is the table's
    ragged rest, which is the same sum. Over a vocabulary shard (tensor
    parallelism) each rank runs its rows' chunks, and the ranks' maxima,
    rescaled sums and target logits meet over "model" (vocabulary-
    parallel: no rank builds another's logits)."""
    N = feats.shape[0]
    V = cfg.vocab_size
    C = min(cfg.loss_vocab_chunk, V)
    lo = _vocab_first_row(params["tok_embed"], V, tp)
    if lo is not None:
        feats = tp.enter(feats)
    table = params["tok_embed"].to(feats.dtype)
    f32 = feats.float()
    m = torch.full((N,), float("-inf"), device=feats.device)
    s = torch.zeros(N, device=feats.device)
    tgt = torch.zeros(N, device=feats.device)
    for base in range(0, table.shape[0], C):
        logits = f32 @ table[base:base + C].float().T          # [N, <= C]
        new_m = torch.maximum(m, logits.max(dim=-1).values)
        s = s * torch.exp(m - new_m) + torch.exp(
            logits - new_m[:, None]).sum(dim=-1)
        m = new_m
        col = targets.long() - (lo or 0) - base
        here = (col >= 0) & (col < logits.shape[1])
        picked = logits.gather(1, col.clamp(0, logits.shape[1] - 1)[:, None])
        tgt = tgt + torch.where(here, picked[:, 0], 0.0)
    if lo is None:
        nll = m + torch.log(s) - tgt
    else:
        top = all_reduce(m.detach(), tp.group, op=torch.distributed
                         .ReduceOp.MAX)
        parts = tp.reduce(torch.stack([s * torch.exp(m - top), tgt]))
        nll = top + torch.log(parts[0]) - parts[1]
    keep = targets != cfg.pad_id
    return torch.where(keep, nll, 0.0).sum(), keep.sum()


def llm_loss(params: dict, cfg: LLMConfig, batch: dict,
             gen: torch.Generator | None = None, deterministic: bool = True,
             group=None, tp: ModelAxis = ONE_RANK
             ) -> tuple[torch.Tensor, dict]:
    """Mean per-token loss in BITS over batch["caption_ids"] [B, T]
    (right-shifted targets, pads excluded), plus moe_aux_coef x the
    layers' mean MoE aux loss when moe_experts is set. Returns (loss,
    {"sample_size", and "moe_aux" with the MoE}). group: the data-parallel
    ranks. The dense loss has no batch-wide budget, so it reads nothing of
    them. The MoE routes over the global batch (ops/moe.py), and its loss
    is the global batch's on every rank: the token sums meet over the
    group, and aux["global_loss"] tells the train step that the ranks'
    gradients add (train_step.py). tp: the "model" axis the params' shards
    lie over."""
    contexts = _build_contexts(params, cfg, batch)
    ids = batch["caption_ids"]
    moe_group = group if cfg.moe_experts else None
    feats, layer_aux = llm_forward(params, cfg, ids[:, :-1], contexts, gen,
                                   deterministic, moe_group, tp)
    B, T, E = feats.shape
    loss_sum, size = llm_xent(params, cfg, feats.reshape(B * T, E),
                              ids[:, 1:].reshape(-1), tp)
    aux = {}
    if moe_group is not None:
        tot = SumOverRanks.apply(torch.stack([loss_sum, size.float()]),
                                 moe_group)
        loss_sum, size = tot[0], tot[1].detach().round().long()
        aux["global_loss"] = True
    size = size.clamp_min(1)
    loss = loss_sum / math.log(2.0) / size
    aux["sample_size"] = size
    if cfg.moe_experts:
        moe_aux = sum(layer_aux) / len(layer_aux)
        aux["moe_aux"] = moe_aux
        loss = loss + cfg.moe_aux_coef * moe_aux
    return loss, aux


def _build_contexts(params: dict, cfg: LLMConfig, batch: dict) -> dict:
    """{name: (features, pad mask)} as the flagship's build_contexts, with
    no article layer sum: the model reads the tower's final hidden state
    (batch["article"])."""
    contexts = {}
    names = {c.name for c in cfg.contexts}
    if "image" in names:
        grid = batch["image_grid"]
        contexts["image"] = (grid, torch.zeros(grid.shape[:2],
                                               dtype=torch.bool,
                                               device=grid.device))
    if "article" in names:
        contexts["article"] = (batch["article"], batch["article_mask"])
    if "faces" in names:
        contexts["faces"] = mask_nan_embeds(batch["face_embeds"])
    if "obj" in names:
        contexts["obj"] = mask_nan_embeds(batch["obj_embeds"])
    return contexts


def modern_encode_contexts(frozen: dict, cfg: LLMConfig, batch: dict
                           ) -> dict:
    """The frozen towers a batch needs: the article's final RoBERTa hidden
    state for context_ids (windowed past the position table; kernel B on
    the card), and for an `image` [B, H, W, 3] without an image_grid the
    ViT's tokens (frozen["vit"], frozen["vit_cfg"]) or, without a ViT, the
    ResNet grid, as tell_tpu. No gradient reaches a tower."""
    out = dict(batch)
    if "context_ids" in batch and "article" not in batch:
        rcfg = frozen["roberta_cfg"]
        with torch.no_grad():
            out["article"] = roberta_encode_windowed(
                frozen["roberta"], rcfg, batch["context_ids"],
                return_all_hiddens=False)
        out["article_mask"] = batch["context_ids"] == rcfg.pad_id
    if "image" in batch and "image_grid" not in batch:
        with torch.no_grad():
            if "vit" in frozen:
                out["image_grid"] = vit_encode(frozen["vit"],
                                               frozen["vit_cfg"],
                                               batch["image"])
            else:
                out["image_grid"] = resnet_forward(
                    frozen["resnet"], frozen["resnet_cfg"], batch["image"])
    return out


def llm_loss_e2e(params: dict, frozen: dict, cfg: LLMConfig, batch: dict,
                 gen: torch.Generator | None = None,
                 deterministic: bool = True, group=None,
                 tp: ModelAxis = ONE_RANK) -> tuple[torch.Tensor, dict]:
    """llm_loss with the frozen towers' encode first (kernel B in the
    article's)."""
    return llm_loss(params, cfg, modern_encode_contexts(frozen, cfg, batch),
                    gen, deterministic, group, tp)


# ---------------------------------------------------------------------------
# Pipeline parallelism (a pipe group of ranks, one stage each)
# ---------------------------------------------------------------------------

def stack_llm_layers(params: dict, n_stages: int) -> dict:
    """params["layers"] [L dicts] -> one tree with leading [n_stages, L/P]
    dims (parallel/pipeline.py's stage layout); the embedding and the
    final norm stay as they are."""
    from ..parallel.pipeline import stack_stages
    return {**params, "layers": stack_stages(params["layers"], n_stages)}


def llm_pp_sharding(stacked: dict) -> dict:
    """{path: spec} of stack_llm_layers' tree, the axis each dim rides as
    tell_tpu's llm_pp_sharding gives them: the layer stack's stage dim on
    "pipe" (rank s of the pipe group computes stage s's layers), the rest
    replicated ()."""
    return {path: ("pipe",) + (None,) * (a.ndim - 1)
            if path.startswith("layers/") else ()
            for path, a in tree_leaves_with_path(stacked)}


def llm_forward_pp(stacked: dict, cfg: LLMConfig, ids: torch.Tensor,
                   contexts: dict, group, n_micro: int, data_group=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward with the layer stack pipelined over `group`
    (deterministic, as tell_tpu's): rank s of the group computes stage
    s's layers of stack_llm_layers' tree. Returns (features, the MoE aux
    summed over every layer and microbatch: zero when dense); the MoE's
    capacity and aux are per microbatch (the GShard per-shard
    convention). With data_group, ids and contexts are the whole batch
    and the features are this rank's rows of each microbatch."""
    from ..parallel.pipeline import pipeline_apply
    x = F.embedding(ids.long(), stacked["tok_embed"])
    token_mask = ids != cfg.pad_id

    def layer_fn(lp, h, extras):
        ctx_mb, mask_mb = extras[-1]
        return _layer_full(lp, cfg, h, ctx_mb, token_mask=mask_mb)

    x, aux = pipeline_apply(stacked["layers"], layer_fn, x, group, n_micro,
                            batched=(contexts, token_mask),
                            data_group=data_group, layer_aux=True)
    return rms_norm(stacked["final_norm"], x, cfg.rms_eps), aux


def llm_loss_pp(stacked: dict, cfg: LLMConfig, batch: dict, group,
                n_micro: int, data_group=None) -> tuple[torch.Tensor, dict]:
    """Pipeline-parallel llm_loss (deterministic): differentiable end to
    end: each rank's gradients land on its stage's slice of the layer
    stack (and are zero on the other stages' slices), tok_embed's and the
    final norm's are whole on every rank. With
    data_group (dp x pp) the loss sum and the token count are summed over
    it, so the loss is the global batch's, and each rank's gradients are
    its part (the caller sums them over data_group). With the MoE, the
    aux is the mean over layers and microbatches of per-microbatch terms,
    an estimator of, not equal to, llm_loss's full-batch aux (tell_tpu's
    llm_loss_pp's convention)."""
    from ..parallel.comm import SumOverRanks, all_reduce
    contexts = _build_contexts(stacked, cfg, batch)
    ids = batch["caption_ids"]
    inputs, targets = ids[:, :-1], ids[:, 1:]
    feats, moe_aux_sum = llm_forward_pp(stacked, cfg, inputs, contexts,
                                        group, n_micro, data_group)
    if data_group is not None:
        from ..parallel.comm import rank, world_size
        n_d, d = world_size(data_group), rank(data_group)
        B = targets.shape[0]
        mb = B // n_micro
        k = mb // n_d
        targets = targets.reshape(n_micro, mb, -1)[:, d * k:(d + 1) * k]
    N = feats.shape[0] * feats.shape[1]
    loss_sum, size = llm_xent(stacked, cfg, feats.reshape(N, -1),
                              targets.reshape(-1))
    if data_group is not None:
        loss_sum = SumOverRanks.apply(loss_sum, data_group)
        size = all_reduce(size, data_group)
    size = size.clamp_min(1)
    loss = loss_sum / math.log(2.0) / size
    aux = {"sample_size": size}
    if cfg.moe_experts:
        moe_aux = moe_aux_sum / (cfg.num_layers * n_micro)
        aux["moe_aux"] = moe_aux
        loss = loss + cfg.moe_aux_coef * moe_aux
    return loss, aux


def init_llm_decode_state(params: dict, cfg: LLMConfig, contexts: dict,
                          batch: int, beam: int = 1,
                          dtype: torch.dtype = torch.float32,
                          kv_cache: str = "fp") -> dict:
    """Per-layer self-K/V caches [batch * beam, gen_len + 1, KV, hd], the
    contexts' stacked K/V in the flagship's layout and numerics
    (decoder.precompute_context_kv_cat), and the step."""
    device = next(iter(contexts.values()))[0].device
    R, T = batch * beam, cfg.gen_len + 1
    shape = (R, T, cfg.kv_heads, cfg.head_dim)
    return {
        "self_kv": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
                    for _ in range(cfg.num_layers)],
        "kv": precompute_context_kv_cat(params, cfg, contexts, beam=beam,
                                        kv_cache=kv_cache),
        "step": torch.zeros((), dtype=torch.long, device=device),
    }


def llm_decoder_step(params: dict, cfg: LLMConfig, tokens: torch.Tensor,
                     state: dict, need_weights: bool = False,
                     row_gather: torch.Tensor | None = None):
    """One decode step. tokens [R] -> (features [R, E], state', per-layer
    head-averaged maps [B, M, G, S] where need_weights, else Nones).
    row_gather [R]: the beam parents, applied to the self-K/V caches as
    the step reads them."""
    B = state["kv"][0]["mask"].shape[0]
    dtype = state["self_kv"][0]["k"].dtype
    x = params["tok_embed"][tokens].to(dtype)
    pos = _step_positions(cfg, state["step"],
                          state["self_kv"][0]["k"].shape[1])
    new_self, attns = [], []
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(lp["attn_norm"], x, cfg.rms_eps)
        o, cache = _self_attn_step(lp["self_attn"], cfg, h,
                                   state["self_kv"][i], pos, row_gather)
        new_self.append(cache)
        x = x + o
        h = rms_norm(lp["cross_norm"], x, cfg.rms_eps)
        o, probs = _cross_block_step(lp, cfg, h, state["kv"][i], B,
                                     need_weights)
        x = x + o
        h = rms_norm(lp["ffn_norm"], x, cfg.rms_eps)
        x = x + _ffn(lp["ffn"], cfg, h, no_drop=True)[0]
        attns.append(probs)
    feats = rms_norm(params["final_norm"], x, cfg.rms_eps)
    return feats, {**state, "self_kv": new_self,
                   "step": state["step"] + 1}, attns


def _logits(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """feats [..., E] against the tied table in feats' dtype, fp32 out."""
    return feats.float() @ params["tok_embed"].to(feats.dtype).float().T


def tied_log_probs(params: dict, cfg: LLMConfig, feats: torch.Tensor
                   ) -> torch.Tensor:
    """Full-vocabulary log-probs [..., V] fp32 from features [..., E]."""
    return torch.log_softmax(_logits(params, feats), dim=-1)


def tied_top_k(params: dict, cfg: LLMConfig, feats: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k next-token log-probs [R, k] and ids [R, k] from step
    features [R, E]. Ties go to the lower id (lax.top_k's order):
    torch.max returns the first maximum, and k > 1 takes the port's
    stable-sort top_k over the row."""
    logits = _logits(params, feats)
    lse = torch.logsumexp(logits, dim=-1)
    if k == 1:
        vals, ids = logits.max(dim=-1, keepdim=True)
    else:
        vals, ids = top_k(logits, k)
    return vals - lse[:, None], ids


def _llm_setup(params: dict, cfg: LLMConfig, batch: dict, beam: int = 1,
               kv_cache: str = "fp"):
    if cfg.gen_len > cfg.max_target_positions:
        raise ValueError(f"{cfg.gen_len} decode steps exceed "
                         f"max_target_positions {cfg.max_target_positions}")
    contexts = _build_contexts(params, cfg, batch)
    feat0 = next(iter(contexts.values()))[0]
    B = feat0.shape[0]
    state = init_llm_decode_state(params, cfg, contexts, B, beam=beam,
                                  dtype=feat0.dtype, kv_cache=kv_cache)
    return B, feat0.device, state, contexts


def llm_generate(params: dict, cfg: LLMConfig, batch: dict,
                 early_stop: bool = True, need_weights: bool = False,
                 kv_cache: str = "fp") -> dict:
    """Greedy generation: {token_ids [B, gen_len + 1] with the seed <s>,
    log_probs [B, gen_len], finished [B]}, and with need_weights "attns":
    per layer {context: [gen_len, B, 1, S_m]} head-averaged maps (the
    plain attention; every step runs, as tell_tpu's scan). early_stop
    ends the loop once every row has emitted EOS (the result is the
    same). A `row_live` bool vector marks filler rows, finished from step
    0. kv_cache: the contexts' K/V numerics ("fp", "int8", "int4")."""
    B, device, state, contexts = _llm_setup(params, cfg, batch,
                                            kv_cache=kv_cache)
    tokens = torch.full((B,), cfg.bos_id, dtype=torch.long, device=device)
    finished = (~batch["row_live"] if "row_live" in batch
                else torch.zeros(B, dtype=torch.bool, device=device))
    toks = torch.full((cfg.gen_len, B), cfg.pad_id, dtype=torch.long,
                      device=device)
    lps = torch.zeros(cfg.gen_len, B, device=device)
    maps = []
    for t in range(cfg.gen_len):
        if early_stop and not need_weights and bool(finished.all()):
            break
        feats, state, attns = llm_decoder_step(params, cfg, tokens, state,
                                               need_weights)
        if need_weights:
            maps.append(attns)
        lp, ids = tied_top_k(params, cfg, feats, 1)
        sampled = ids[:, 0]
        tokens = torch.where(finished, cfg.pad_id, sampled)
        lps[t] = torch.where(finished, 0.0, lp[:, 0])
        toks[t] = tokens
        finished = finished | (sampled == cfg.eos_id)
    seed = torch.full((B, 1), cfg.bos_id, dtype=torch.long, device=device)
    out = {"token_ids": torch.cat([seed, toks.T], dim=1),
           "log_probs": lps.T, "finished": finished}
    if need_weights:
        bounds = attn_segment_bounds(cfg, contexts)
        out["attns"] = [split_attn_segments(bounds, torch.stack(layer))
                        for layer in zip(*maps)]
    return out


def llm_beam_search(params: dict, cfg: LLMConfig, batch: dict,
                    beam_size: int = 5, length_penalty: float = 0.0,
                    early_stop: bool = True, kv_cache: str = "fp") -> dict:
    """Beam decode through models/beam.py's beam_search_core: the step
    reads the self-K/V caches through the previous step's parents
    (tell_tpu reorders them after each step; the same caches either
    way). Returns {token_ids [B, K, gen_len + 1] best first, scores,
    finished}."""
    K = beam_size
    B, device, state, _ = _llm_setup(params, cfg, batch, beam=K,
                                     kv_cache=kv_cache)

    def step_fn(tokens, dyn, row_gather):
        feats, new_state, _ = llm_decoder_step(params, cfg, tokens, dyn,
                                               row_gather=row_gather)
        lp, ids = tied_top_k(params, cfg, feats, K)
        return lp, ids, new_state

    finished0 = ~batch["row_live"] if "row_live" in batch else None
    return beam_search_core(step_fn, state, B, K, cfg.gen_len, cfg.bos_id,
                            cfg.eos_id, cfg.pad_id, device, length_penalty,
                            early_stop, finished0)

