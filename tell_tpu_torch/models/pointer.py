"""The pointer/copy captioners of expts a1-a3 (counterpart of
tell_tpu/models/pointer.py: PointerConfig, warm_start_from_captioner,
_copy_article, _copy_target_probs, pointer_loss with its two copy losses,
and pointer_generate). init_pointer is in bridge.py.

The base is the faces captioner (image, article and faces contexts),
warm-started from a trained one; on top of it:

* an entity-presence head: strict-causal gated self-attention over the
  decoder's features and a 2-way classifier (ops/self_attention.py);
* a copy head: attention over the article, mixed with a second learned
  25-layer weight vector `bert_weight_2` where weigh_bert;
* the copy probability of a target token is the attention mass on the
  proper-noun article positions holding it, a masked sum over an
  (ids equal AND proper) match: static shapes, no unique() or scatter;
* per-entity means over the static entity indices 1..MAX_COPY_ENTITIES
  (an index above it counts in no mean, as in tell_tpu).

The loss is (entity + copy) / ln 2. The generation loss is reported, on
the decoder's features detached, and is not optimised; a batch with no
entity token gives 0; a copy target of probability 0 contributes 0, not
-inf. Nothing in the loss reads a tensor back to the host: v2's count of
distinct ids is tell_tpu's sort-and-diff. Dropout generators follow
tell_tpu's keys: fold_in(gen, 0) for the decoder, fold_in(gen, 2) for
the copy attention.

pointer_generate decodes greedily (or samples among the top k) through
the port's decoder_step, so kernel A attends on the card (kernel D under
kv_cache int8/int4, kernel E under fused_topk); the entity head decides
at each step whether to copy, and a copy emits the proper context token
of the highest copy mass unless that mass is < 1e-6 or the token was
copied already. The heads' products are matmuls and einsums: tell_tpu
has no Pallas kernel there.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..config import CaptionerConfig
from ..ops.adaptive import adaptive_softmax_loss, whole_bands
from ..ops.common import fold_in
from ..ops.linear import gehring_linear
from ..ops.self_attention import (copy_attention_keys,
                                  copy_attention_scores, self_attention)
from ..parallel.comm import (ONE_RANK, ModelAxis, SumOverRanks, all_gather,
                             all_reduce)
from .captioner import (_decode_setup, build_contexts, sample_top_k,
                        weighted_layer_sum)
from .decoder import (decode_vocab_table, decoder_forward, decoder_step,
                      decoder_top_k)

MAX_COPY_ENTITIES = 24  # static bound on distinct entities per caption
LN2 = math.log(2.0)


@dataclasses.dataclass(frozen=True)
class PointerConfig:
    """transformer_pointer(_2)'s hyper-parameters: the base captioner, the
    copy loss (1 = transformer_pointer, 2 = transformer_pointer_2) and the
    dropout inside the copy attention."""
    captioner: CaptionerConfig
    copy_loss_version: int = 1
    attn_dropout: float = 0.1


def warm_start_from_captioner(pointer_params: dict, captioner_params: dict
                              ) -> dict:
    """A trained captioner's params as the pointer's base; the heads keep
    theirs."""
    return {**pointer_params, "captioner": captioner_params}


def _copy_article(params: dict, cfg: PointerConfig, batch: dict
                  ) -> torch.Tensor:
    """The copy head's article features: the hidden layers mixed by
    softmax(bert_weight_2) where weigh_bert, else the final hidden
    state."""
    if cfg.captioner.weigh_bert and "article_hiddens" in batch:
        return weighted_layer_sum({"bert_weight": params["bert_weight_2"]},
                                  batch["article_hiddens"])
    return batch["article"]


def _copy_target_probs(copy_attn: torch.Tensor, context_ids: torch.Tensor,
                       proper: torch.Tensor, target_ids: torch.Tensor
                       ) -> torch.Tensor:
    """p[b, l]: the attention mass on proper source positions whose token
    equals target_ids[b, l]. copy_attn [B, L, S] -> [B, L]."""
    match = context_ids[:, None, :] == target_ids[:, :, None]   # [B, L, S]
    match = match & proper[:, None, :]
    return (copy_attn * match).sum(dim=-1)


def _per_entity_mean_sum(values: torch.Tensor, cap_masks: torch.Tensor,
                         group=None) -> torch.Tensor:
    """The sum over entity indices i in 1..MAX_COPY_ENTITIES of the mean
    of `values` [B, L] over the caption tokens of entity i (an index
    without tokens adds 0). group: the data-parallel ranks, whose sums
    and counts meet before the division (the global batch's means)."""
    idx = torch.arange(1, MAX_COPY_ENTITIES + 1, device=values.device)
    m = cap_masks[..., None] == idx                             # [B, L, N]
    cnt = m.sum(dim=(0, 1))
    tot = torch.where(m, values[..., None], 0.0).sum(dim=(0, 1))
    if group is not None:
        both = SumOverRanks.apply(torch.stack([tot, cnt.to(tot.dtype)]),
                                  group)
        tot, cnt = both[0], both[1].detach().round().long()
    return torch.where(cnt > 0, tot / cnt.clamp_min(1), 0.0).sum()


def _count_unique(ids: torch.Tensor) -> torch.Tensor:
    """The number of distinct values of a 1-D int tensor (sort and diff:
    static shapes, no host sync)."""
    s = torch.sort(ids).values
    return 1 + (s[1:] != s[:-1]).sum()


def _copy_loss_v2(scores: torch.Tensor, batch: dict, targets: torch.Tensor,
                  lp_tgt: torch.Tensor, cap_masks: torch.Tensor, group=None
                  ) -> torch.Tensor:
    """transformer_pointer_2's cross entropy over the reduced vocabulary,
    as tell_tpu computes it: the stitched log-prob vector is taken as
    logits (log p_v where p_v > 0, 0 elsewhere), so the normaliser is the
    copy mass plus the number of the batch's distinct ids (context and
    targets) that are not a proper token of the row."""
    context_ids = batch["context_ids"].long()
    proper = batch["proper_masks"] >= 1
    B = scores.shape[0]
    ids = torch.cat([context_ids.reshape(-1), targets.long().reshape(-1)])
    if group is not None:          # the global batch's distinct ids
        ids = all_gather(ids, group).reshape(-1)
    U = _count_unique(ids)
    # distinct proper tokens per row: non-proper pushed to a sentinel
    sentinel = 1 << 30
    srt = torch.sort(torch.where(proper, context_ids, sentinel),
                     dim=1).values
    firsts = torch.cat([torch.ones(B, 1, dtype=torch.bool,
                                   device=srt.device),
                        srt[:, 1:] != srt[:, :-1]], dim=1)
    distinct = (firsts & (srt != sentinel)).sum(dim=1)          # [B]
    mass = scores.sum(dim=-1)                                   # [B, L]
    Z = mass + (U - distinct)[:, None].to(mass.dtype)
    ce = -(lp_tgt - torch.log(Z.clamp_min(1e-30)))
    return _per_entity_mean_sum(ce, cap_masks, group)


def pointer_loss(params: dict, cfg: PointerConfig, batch: dict,
                 gen: torch.Generator | None = None,
                 deterministic: bool = True, group=None,
                 tp: ModelAxis = ONE_RANK) -> tuple[torch.Tensor, dict]:
    """The captioner's batch plus context_ids [B, S], proper_masks [B, S]
    (an entity index at proper-noun positions, 0 elsewhere, -1 at pads)
    and caption_copy_masks [B, T] (the same for the caption). Returns
    (loss = (entity + copy) / ln 2, {gen_loss, entity_loss,
    copy_loss}). group: the data-parallel ranks, each holding its rows of
    the batch: every mean is then the global batch's (its sums and counts
    meet over the group before the division), has_entities is the global
    batch's, and aux["global_loss"] tells the train step that the ranks'
    gradients add. tp: the "model" axis of the captioner's shards (the
    pointer heads are replicated)."""
    cap = cfg.captioner
    dcfg = cap.decoder
    contexts = build_contexts(params["captioner"], cap, batch)
    caption_ids = batch["caption_ids"]
    inputs, targets = caption_ids[:, :-1], caption_ids[:, 1:]
    X = decoder_forward(params["captioner"]["decoder"], dcfg, inputs,
                        contexts, fold_in(gen, 0), deterministic, tp)
    B, L, E = X.shape

    # the generation loss: reported, not optimised
    dec = params["captioner"]["decoder"]
    with torch.no_grad():
        gen_sum, gen_size, _ = adaptive_softmax_loss(
            dec["adaptive_softmax"], whole_bands(dec["embed"],
                                                 dcfg.full_cutoffs, tp),
            X.detach().reshape(B * L, E), targets.reshape(-1),
            dcfg.full_cutoffs, pad_id=dcfg.pad_id,
            padding_idx=dcfg.embed_padding_idx)
        if group is not None:
            gen_sum, gen_size = all_reduce(torch.stack(
                [gen_sum.float(), gen_size.float()]), group)
        gen_loss = gen_sum / gen_size.clamp_min(1) / LN2

    cap_masks = batch["caption_copy_masks"][:, 1:]          # the targets'
    has_entities = (cap_masks >= 1).any()
    if group is not None:
        has_entities = all_reduce(has_entities.float(), group) > 0

    # the entity-presence loss
    x_entity = self_attention(params["entity_attn"], X,
                              num_heads=dcfg.num_heads)
    ent_logits = gehring_linear(params["entity_fc"], x_entity)  # [B, L, 2]
    ent_targets = cap_masks.clamp(-1, 1).long()
    valid = ent_targets >= 0
    ent_lp = torch.log_softmax(ent_logits.float(), dim=-1)
    picked = ent_lp.gather(-1, ent_targets.clamp_min(0)[..., None])[..., 0]
    ent = torch.stack([-torch.where(valid, picked, 0.0).sum(),
                       valid.sum().to(picked.dtype)])
    if group is not None:
        ent = SumOverRanks.apply(ent, group)
    entity_loss = ent[0] / ent[1].detach().clamp_min(1)

    # the copy loss
    keys = copy_attention_keys(params["copy_attn"],
                               _copy_article(params, cfg, batch))
    scores = copy_attention_scores(
        params["copy_attn"], X, keys, batch.get("article_mask"),
        num_heads=dcfg.num_heads, drop_rate=cfg.attn_dropout,
        gen=fold_in(gen, 2), deterministic=deterministic)[:, :, :-2]
    proper = batch["proper_masks"] >= 1
    scores = scores * proper[:, None, :]
    p_tgt = _copy_target_probs(scores, batch["context_ids"], proper, targets)
    lp_tgt = torch.where(p_tgt > 0, torch.log(p_tgt.clamp_min(1e-30)), 0.0)
    if cfg.copy_loss_version == 1:
        copy_loss = _per_entity_mean_sum(-lp_tgt, cap_masks, group)
    else:
        copy_loss = _copy_loss_v2(scores, batch, targets, lp_tgt, cap_masks,
                                  group)

    zero = torch.zeros((), device=X.device)
    loss = torch.where(has_entities, (entity_loss + copy_loss) / LN2, zero)
    aux = {
        "gen_loss": gen_loss,
        "entity_loss": torch.where(has_entities, entity_loss, zero) / LN2,
        "copy_loss": torch.where(has_entities, copy_loss, zero) / LN2,
    }
    if group is not None:
        aux["global_loss"] = True
    return loss, aux


def pointer_generate(params: dict, cfg: PointerConfig, batch: dict,
                     gen: torch.Generator | None = None,
                     kv_cache: str = "fp", fused_topk: bool = False,
                     merged_vocab: bool = False) -> dict:
    """Generation with the copy mechanism: at each step the entity head
    decides should-copy; a copy emits the proper context token with the
    highest copy mass (its mass summed over every proper position holding
    that token) unless the mass is < 1e-6 or the token was already
    copied; otherwise the generator's token (greedy at sampling_topk 1,
    else a draw among the top k from `gen` at sampling_temp, default seed
    0 on the batch's device). kv_cache ("fp", "int8", "int4") and
    fused_topk are the decode numerics levers of init_decode_state and
    decoder_top_k; merged_vocab the merged fp32 softmax table
    (decode_vocab_table, built once here), the only table lever tell_tpu's
    pointer decode reads.

    Returns {token_ids [B, gen_len + 1] with the seed <s>, log_probs
    [B, gen_len] (of the token emitted: the copy mass's log on a copy
    step), should_copy [B, gen_len], copy_probs [B, gen_len] (0 off copy
    steps), finished [B]}. A `row_live` bool vector marks filler rows,
    finished from step 0; the loop ends once every row has finished
    (later steps would emit <pad> at log-prob 0 and copy nothing, the
    buffers' prefill, so the result is the same)."""
    cap = cfg.captioner
    dcfg = cap.decoder
    B, device, state, contexts = _decode_setup(params["captioner"], cap,
                                               batch, kv_cache=kv_cache)
    dtype = next(iter(contexts.values()))[0].dtype
    G, E = cap.gen_len, dcfg.embed_dim
    k = cap.sampling_topk
    if k > 1 and gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    context_ids = batch["context_ids"].long()
    proper = batch["proper_masks"] >= 1
    keys = copy_attention_keys(params["copy_attn"],
                               _copy_article(params, cfg, batch))
    pad_mask = batch.get("article_mask")
    # same-token match over proper positions, [B, S, S], in the scores'
    # fp32 (tell_tpu's einsum promotes the bool match the same way)
    match = ((context_ids[:, None, :] == context_ids[:, :, None])
             & proper[:, None, :] & proper[:, :, None]).float()

    tokens = torch.full((B,), dcfg.bos_id, dtype=torch.long, device=device)
    finished = (~batch["row_live"] if "row_live" in batch
                else torch.zeros(B, dtype=torch.bool, device=device))
    hist = torch.zeros(B, G, E, dtype=dtype, device=device)
    copied = torch.full((B, G), -1, dtype=torch.long, device=device)
    toks = torch.full((G, B), dcfg.pad_id, dtype=torch.long, device=device)
    lps = torch.zeros(G, B, device=device)
    copies = torch.zeros(G, B, dtype=torch.bool, device=device)
    cprobs = torch.zeros(G, B, device=device)
    steps = torch.arange(G, device=device)
    dec = params["captioner"]["decoder"]
    vocab_table = decode_vocab_table(dec, dcfg) if merged_vocab else None
    for t in range(G):
        if bool(finished.all()):
            break
        feats, state = decoder_step(dec, dcfg, tokens, state)   # [B, E]
        hist[:, t] = feats.to(dtype)
        x_ent = self_attention(params["entity_attn"], feats[:, None, :],
                               num_heads=dcfg.num_heads, q_offset=t,
                               kv=hist, kv_valid=(steps <= t)[None, :])
        ent_logits = gehring_linear(params["entity_fc"], x_ent[:, 0])
        should_copy = torch.argmax(ent_logits, dim=-1) == 1

        scores = copy_attention_scores(
            params["copy_attn"], feats[:, None, :], keys, pad_mask,
            num_heads=dcfg.num_heads)[:, 0, :-2]                # [B, S]
        scores = scores * proper
        mass = torch.einsum("bs,bts->bt", scores, match)        # [B, S]
        best = torch.argmax(mass, dim=-1)
        copy_prob = mass.gather(1, best[:, None])[:, 0]
        copy_id = context_ids.gather(1, best[:, None])[:, 0]
        has_copied = (copied == copy_id[:, None]).any(dim=-1)
        should_copy = should_copy & ~(copy_prob < 1e-6) & ~has_copied

        top_lp, top_idx = decoder_top_k(dec, dcfg, feats, k, fused_topk,
                                        vocab_table)
        if k == 1:
            choice = torch.zeros(B, dtype=torch.long, device=device)
        else:
            choice = sample_top_k(top_lp, cap.sampling_temp, gen)
        gen_id = top_idx.gather(1, choice[:, None])[:, 0]
        sel_lp = top_lp.gather(1, choice[:, None])[:, 0]
        tok = torch.where(should_copy, copy_id, gen_id)
        tok = torch.where(finished, dcfg.pad_id, tok)
        should_copy = should_copy & ~finished
        copied[:, t] = torch.where(should_copy, copy_id, -1)
        lp_emit = torch.where(should_copy,
                              torch.log(copy_prob.clamp_min(1e-9)), sel_lp)
        toks[t] = tok
        lps[t] = torch.where(finished, 0.0, lp_emit)
        copies[t] = should_copy
        cprobs[t] = torch.where(should_copy, copy_prob, 0.0)
        finished = finished | (tok == dcfg.eos_id)
        tokens = tok
    seed = torch.full((B, 1), dcfg.bos_id, dtype=torch.long, device=device)
    return {"token_ids": torch.cat([seed, toks.T], dim=1),
            "log_probs": lps.T, "should_copy": copies.T,
            "copy_probs": cprobs.T, "finished": finished}
