"""The LSTM caption decoder of expts 1 and 3 (counterpart of
tell_tpu/models/lstm_decoder.py: _lstm_cell, _attention, _lstm_step,
init_lstm_state, lstm_decoder_forward, lstm_decoder_loss,
lstm_captioner_loss and lstm_generate). init_lstm_decoder and
init_lstm_captioner are in bridge.py.

An input-feeding stack of LSTM cells with learned initial h and c,
dot-product attention over the image and the article from the last
cell's h, tanh output fusion and attn_proj, then the tied adaptive
softmax of the conv decoder:

    [x_t; feed] -> cell_0 -> drop -> ... -> cell_L-1 = h
    out = attn_proj(drop([attend(image, h); attend(article, h)]))
    feed = out

* A cell's four gates come from one fused product, [x; h] against W_ih
  and W_hh, in fp32 (tell_tpu's preferred_element_type), with h and c cast
  back to the input dtype every step: under compute_dtype bfloat16 (expt
  3) the cell state lives in bf16, as in tell_tpu.
* tell_tpu's lax.scan over the caption is a Python loop here. The cells'
  weights and the contexts' features are cast to fp32 once per sequence,
  not once per step (the same products; autograd then keeps one copy).
* Dropout draws from fold_in generators laid out as tell_tpu's keys: the
  embedding's fold_in(gen, 0), step t's fold_in(gen, t), within it cell
  i's fold_in(., i) and the fused output's fold_in(., 99).
* lstm_generate embeds step t's token at position t, decodes greedily at
  sampling_topk 1 (the adaptive softmax's exact top-k, or kernel E with
  fused_topk) and samples among the top k otherwise; finished rows emit
  <pad> at log-prob 0. need_weights adds tell_tpu's maps: {"image",
  "article"} each [gen_len, B, S].
"""
from __future__ import annotations

import math

import torch

from ..config import CaptionerConfig, DecoderConfig
from ..ops.adaptive import (adaptive_softmax_loss, adaptive_top_k,
                            whole_bands)
from ..ops.common import dropout, fold_in
from ..ops.linear import gehring_linear
from ..parallel.comm import ONE_RANK, ModelAxis
from .captioner import build_contexts, sample_top_k
from .decoder import embed_tokens


def _lstm_cell(p: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One cell: gates i, f, g, o of x @ W_ih + b_ih + h @ W_hh + b_hh in
    fp32; (h', c') in x's dtype."""
    gates = (x.float() @ p["w_ih"].float() + p["b_ih"].float()
             + h.float() @ p["w_hh"].float() + p["b_hh"].float())
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(x.dtype), c_new.to(x.dtype)


def _attention(p: dict, query: torch.Tensor, source: torch.Tensor,
               padding_mask: torch.Tensor, dtype: torch.dtype
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dot-product attention of query [B, H] over source [B, S, D] (fp32;
    dtype is the features' own) with padding_mask [B, S] True = pad:
    tanh(output_proj([context; query])) and the probabilities [B, S] in
    dtype."""
    x = gehring_linear(p["input_proj"], query)
    scores = torch.einsum("bd,bsd->bs", x.float(), source)
    scores = scores.masked_fill(padding_mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    ctx = torch.einsum("bs,bsd->bd", probs.float(), source).to(query.dtype)
    out = torch.tanh(gehring_linear(p["output_proj"],
                                    torch.cat([ctx, query], dim=-1)))
    return out, probs


def _prepare(lp: dict, contexts: dict) -> tuple[dict, dict]:
    """The cells with fp32 weights and {name: (fp32 features, pad mask,
    their dtype)}: the per-sequence casts of the step's products."""
    cells = [{k: v.float() for k, v in c.items()} for c in lp["cells"]]
    ctx = {name: (f.float(), m, f.dtype)
           for name, (f, m) in contexts.items()}
    return {**lp, "cells": cells}, ctx


def _lstm_step(lp: dict, cfg: DecoderConfig, x_t: torch.Tensor,
               state: tuple, contexts: dict,
               gen: torch.Generator | None = None,
               deterministic: bool = True):
    """One step -> (features [B, H], state', {"image", "article"} maps).
    contexts: _prepare's."""
    hs, cs, feed = state
    rnn_input = torch.cat([x_t, feed], dim=-1)
    new_hs, new_cs = [], []
    for i, cell in enumerate(lp["cells"]):
        h, c = _lstm_cell(cell, rnn_input, hs[i], cs[i])
        rnn_input = dropout(h, cfg.dropout, fold_in(gen, i), deterministic)
        new_hs.append(h)
        new_cs.append(c)
    img, img_attn = _attention(lp["image_attn"], h, *contexts["image"])
    art, art_attn = _attention(lp["article_attn"], h, *contexts["article"])
    out = dropout(torch.cat([img, art], dim=-1), cfg.dropout,
                  fold_in(gen, 99), deterministic)
    out = gehring_linear(lp["attn_proj"], out)
    return out, (new_hs, new_cs, out), {"image": img_attn,
                                        "article": art_attn}


def init_lstm_state(params: dict, batch: int,
                    dtype: torch.dtype = torch.float32) -> tuple:
    """(h per layer, c per layer, the input feed) for `batch` rows."""
    lp = params["lstm"]
    hs = [h.expand(batch, -1).to(dtype) for h in lp["h0"]]
    cs = [c.expand(batch, -1).to(dtype) for c in lp["c0"]]
    feed = torch.zeros(batch, lp["h0"][0].shape[-1], dtype=dtype,
                       device=lp["h0"][0].device)
    return hs, cs, feed


def lstm_decoder_forward(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
                         contexts: dict, gen: torch.Generator | None = None,
                         deterministic: bool = True,
                         tp: ModelAxis = ONE_RANK) -> torch.Tensor:
    """Teacher-forced forward: ids [B, T] -> features [B, T, E]. tp: the
    "model" axis the embedding's bands may be shards over (the LSTM's
    other leaves are replicated)."""
    x = embed_tokens(params, cfg, ids, fold_in(gen, 0), deterministic,
                     tp=tp)
    state = init_lstm_state(params, ids.shape[0], x.dtype)
    lp, ctx = _prepare(params["lstm"], contexts)
    outs = []
    for t in range(ids.shape[1]):
        out, state, _ = _lstm_step(lp, cfg, x[:, t], state, ctx,
                                   fold_in(gen, t), deterministic)
        outs.append(out)
    return torch.stack(outs, dim=1)


def lstm_decoder_loss(params: dict, cfg: DecoderConfig,
                      caption_ids: torch.Tensor, contexts: dict,
                      gen: torch.Generator | None = None,
                      deterministic: bool = True, tp: ModelAxis = ONE_RANK):
    """The adaptive-softmax loss on right-shifted targets -> (loss_sum in
    nats, sample_size, aux)."""
    feats = lstm_decoder_forward(params, cfg, caption_ids[:, :-1], contexts,
                                 gen, deterministic, tp)
    B, T, E = feats.shape
    return adaptive_softmax_loss(
        params["adaptive_softmax"], whole_bands(params["embed"],
                                                cfg.full_cutoffs, tp),
        feats.reshape(B * T, E), caption_ids[:, 1:].reshape(-1),
        cfg.full_cutoffs, pad_id=cfg.pad_id,
        padding_idx=cfg.embed_padding_idx)


def lstm_captioner_loss(params: dict, cfg: CaptionerConfig, batch: dict,
                        gen: torch.Generator | None = None,
                        deterministic: bool = True, group=None,
                        tp: ModelAxis = ONE_RANK
                        ) -> tuple[torch.Tensor, dict]:
    """Mean per-token loss in BITS over the image and article contexts
    (build_contexts: the article layer-mixed where weigh_bert). Returns
    (loss, {"sample_size", "tail_dropped"}). group: the data-parallel
    ranks; the loss has no batch-wide budget, so it reads nothing of
    them. tp: the "model" axis."""
    contexts = build_contexts(params, cfg, batch)
    loss_sum, size, aux = lstm_decoder_loss(
        params["decoder"], cfg.decoder, batch["caption_ids"], contexts, gen,
        deterministic, tp)
    size = size.clamp_min(1)
    return loss_sum / math.log(2.0) / size, {"sample_size": size, **aux}


def lstm_generate(params: dict, cfg: CaptionerConfig, batch: dict,
                  gen: torch.Generator | None = None,
                  need_weights: bool = False, fused_topk: bool = False,
                  kv_cache: str = "fp") -> dict:
    """Greedy generation at sampling_topk 1, else a draw among the top k
    from `gen` (default: seed 0 on the batch's device) at sampling_temp,
    the untempered log-prob reported. Returns {token_ids [B, gen_len + 1]
    with the seed <s>, log_probs [B, gen_len], finished [B]}, and with
    need_weights "attns": {"image", "article"} maps [gen_len, B, S] (every
    step runs, as tell_tpu's scan does); without them the loop ends once
    every row has finished (the result is the same). A `row_live` bool
    vector marks filler rows, finished from step 0. fused_topk streams the
    adaptive softmax's clusters through kernel E. kv_cache is the other
    families' lever, taken for the adapters' common call: the LSTM keeps
    no K/V cache (ModelAdapter.check_levers refuses all but "fp")."""
    dcfg = cfg.decoder
    if cfg.gen_len > dcfg.max_target_positions:
        raise ValueError(f"{cfg.gen_len} decode steps exceed "
                         f"max_target_positions {dcfg.max_target_positions}")
    contexts = build_contexts(params, cfg, batch)
    feat0 = next(iter(contexts.values()))[0]
    B, device = feat0.shape[0], feat0.device
    dec = params["decoder"]
    state = init_lstm_state(dec, B, feat0.dtype)
    lp, ctx = _prepare(dec["lstm"], contexts)
    k = cfg.sampling_topk
    if k > 1 and gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.full((B,), dcfg.bos_id, dtype=torch.long, device=device)
    finished = (~batch["row_live"] if "row_live" in batch
                else torch.zeros(B, dtype=torch.bool, device=device))
    toks = torch.full((cfg.gen_len, B), dcfg.pad_id, dtype=torch.long,
                      device=device)
    lps = torch.zeros(cfg.gen_len, B, device=device)
    maps = []
    for t in range(cfg.gen_len):
        if not need_weights and bool(finished.all()):
            break
        x = embed_tokens(dec, dcfg, tokens[:, None], start_pos=t)[:, 0]
        feats, state, attns = _lstm_step(lp, dcfg, x, state, ctx)
        if need_weights:
            maps.append(attns)
        top_lp, top_idx = adaptive_top_k(
            dec["adaptive_softmax"], dec["embed"], feats, dcfg.full_cutoffs,
            k, padding_idx=dcfg.embed_padding_idx, fused=fused_topk)
        if k == 1:
            choice = torch.zeros(B, dtype=torch.long, device=device)
        else:
            choice = sample_top_k(top_lp, cfg.sampling_temp, gen)
        sampled = top_idx.gather(1, choice[:, None])[:, 0]
        sel_lp = top_lp.gather(1, choice[:, None])[:, 0]
        tokens = torch.where(finished, dcfg.pad_id, sampled)
        lps[t] = torch.where(finished, 0.0, sel_lp)
        toks[t] = tokens
        finished = finished | (sampled == dcfg.eos_id)
    seed = torch.full((B, 1), dcfg.bos_id, dtype=torch.long, device=device)
    out = {"token_ids": torch.cat([seed, toks.T], dim=1),
           "log_probs": lps.T, "finished": finished}
    if need_weights:
        out["attns"] = {name: torch.stack([m[name] for m in maps])
                        for name in ("image", "article")}
    return out
