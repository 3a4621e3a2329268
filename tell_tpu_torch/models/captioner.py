"""Task model: multi-context news captioner (counterpart of
tell_tpu/models/captioner.py: weighted_layer_sum, mask_nan_embeds,
build_contexts, encode_contexts (article branch), captioner_loss,
captioner_loss_e2e, generate and predict_forced).

The JAX scan / while_loop become Python loops over a fixed-shape step.
`Captioner` owns the param tree as an nn.Module; its methods call the
plain functions.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..bridge import ParamTree
from ..config import CaptionerConfig
from .backbones.roberta import roberta_encode_windowed
from .decoder import (decoder_loss, decoder_step, decoder_top_k,
                      init_decode_state)


def weighted_layer_sum(params: dict, hiddens: torch.Tensor) -> torch.Tensor:
    """hiddens: [B, S, L, D] -> [B, S, D], mixed by softmax(bert_weight)."""
    w = torch.softmax(params["bert_weight"].float(), dim=0)
    return torch.einsum("bsld,l->bsd", hiddens, w.to(hiddens.dtype))


def mask_nan_embeds(embeds: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """NaN rows mark absent faces/objects: zero them, return the pad mask."""
    mask = torch.isnan(embeds).any(dim=-1)
    return embeds.masked_fill(mask[..., None], 0.0), mask


def build_contexts(params: dict, cfg: CaptionerConfig, batch: dict) -> dict:
    """The decoder's {name: (features, pad mask)} from encoder features.

    batch keys: image_grid [B, 49, 2048]; article [B, S, D] or
    article_hiddens [B, S, L, D] (weigh_bert); article_mask [B, S]
    True = pad; face_embeds [B, F, 512] and obj_embeds [B, O, 2048] with
    NaN rows for absent entries."""
    contexts = {}
    names = {c.name for c in cfg.decoder.contexts}
    if "image" in names:
        grid = batch["image_grid"]
        contexts["image"] = (grid, torch.zeros(grid.shape[:2],
                                               dtype=torch.bool,
                                               device=grid.device))
    if "article" in names:
        if cfg.weigh_bert and "article_hiddens" in batch:
            art = weighted_layer_sum(params, batch["article_hiddens"])
        else:
            art = batch["article"]
        contexts["article"] = (art, batch["article_mask"])
    if "faces" in names:
        contexts["faces"] = mask_nan_embeds(batch["face_embeds"])
    if "obj" in names:
        contexts["obj"] = mask_nan_embeds(batch["obj_embeds"])
    return contexts


def encode_contexts(frozen: dict, cfg: CaptionerConfig, batch: dict) -> dict:
    """Run the RoBERTa article encode for a batch that carries context_ids
    (frozen = {"roberta": params, "roberta_cfg": RobertaConfig}). No
    gradient reaches the tower: it is frozen (tell_tpu stops gradients
    here, captioner.py:104-107), and kernel B has no backward. Image grids
    come in precomputed: the vision towers are not ported yet."""
    out = dict(batch)
    if ("context_ids" in batch and "article_hiddens" not in batch
            and "article" not in batch):
        rcfg = frozen["roberta_cfg"]
        with torch.no_grad():
            hiddens = roberta_encode_windowed(
                frozen["roberta"], rcfg, batch["context_ids"],
                return_all_hiddens=cfg.weigh_bert)
        out["article_hiddens" if cfg.weigh_bert else "article"] = hiddens
        out["article_mask"] = batch["context_ids"] == rcfg.pad_id
    return out


def captioner_loss(params: dict, cfg: CaptionerConfig, batch: dict,
                   gen: torch.Generator | None = None,
                   deterministic: bool = True) -> tuple[torch.Tensor, dict]:
    """Mean per-token loss in BITS (loss_sum / ln 2 / non-pad tokens).
    batch["caption_ids"]: [B, T]. Returns (loss, {"sample_size",
    "tail_dropped"})."""
    contexts = build_contexts(params, cfg, batch)
    loss_sum, size, aux = decoder_loss(params["decoder"], cfg.decoder,
                                       batch["caption_ids"], contexts, gen,
                                       deterministic)
    size = size.clamp_min(1)
    return loss_sum / math.log(2.0) / size, {"sample_size": size, **aux}


def captioner_loss_e2e(params: dict, frozen: dict, cfg: CaptionerConfig,
                       batch: dict, gen: torch.Generator | None = None,
                       deterministic: bool = True
                       ) -> tuple[torch.Tensor, dict]:
    """The loss including the frozen RoBERTa encode (the full objective)."""
    return captioner_loss(params, cfg, encode_contexts(frozen, cfg, batch),
                          gen, deterministic)


def _decode_setup(params: dict, cfg: CaptionerConfig, batch: dict,
                  beam: int = 1, steps: int | None = None,
                  kv_cache: str = "fp"):
    """Contexts and the decode state for `steps` (default gen_len) steps.
    Raises where the positional table would run out: JAX's jnp.take
    quietly fills NaN there, and the port's lookup would fail mid-decode
    (an index error on the CPU, a device-side assert on CUDA)."""
    steps = cfg.gen_len if steps is None else steps
    if steps > cfg.decoder.max_target_positions:
        raise ValueError(f"{steps} decode steps exceed max_target_positions "
                         f"{cfg.decoder.max_target_positions}")
    contexts = build_contexts(params, cfg, batch)
    feat0 = next(iter(contexts.values()))[0]
    B = feat0.shape[0]
    state = init_decode_state(params["decoder"], cfg.decoder, contexts, B,
                              beam=beam, dtype=feat0.dtype,
                              kv_cache=kv_cache)
    return B, feat0.device, state


def generate(params: dict, cfg: CaptionerConfig, batch: dict,
             early_stop: bool = True, kv_cache: str = "fp",
             fused_topk: bool = False) -> dict:
    """Greedy generation (sampling_topk == 1, every shipped config).
    kv_cache ("fp", "int8", "int4") and fused_topk are the decode numerics
    levers of decoder.init_decode_state and decoder.decoder_top_k.

    Returns {token_ids [B, gen_len+1] incl. the seed <s>, log_probs
    [B, gen_len], finished [B]}. early_stop ends the loop once every row
    has emitted EOS; later steps would emit <pad> at log-prob 0, which is
    the buffers' prefill, so the result is the same. A `row_live` bool
    vector in the batch marks filler rows, which start finished."""
    if cfg.sampling_topk != 1:
        raise NotImplementedError("top-k sampling is not ported; the port "
                                  "decodes greedily (sampling_topk=1)")
    dcfg = cfg.decoder
    B, device, state = _decode_setup(params, cfg, batch, kv_cache=kv_cache)
    tokens = torch.full((B,), dcfg.bos_id, dtype=torch.long, device=device)
    if "row_live" in batch:
        finished = ~batch["row_live"]
    else:
        finished = torch.zeros(B, dtype=torch.bool, device=device)
    toks = torch.full((cfg.gen_len, B), dcfg.pad_id, dtype=torch.long,
                      device=device)
    lps = torch.zeros(cfg.gen_len, B, device=device)
    for t in range(cfg.gen_len):
        if early_stop and bool(finished.all()):
            break
        feats, state = decoder_step(params["decoder"], dcfg, tokens, state)
        top_lp, top_idx = decoder_top_k(params["decoder"], dcfg, feats, 1,
                                        fused_topk)
        sampled = top_idx[:, 0]
        tokens = torch.where(finished, dcfg.pad_id, sampled)
        lps[t] = torch.where(finished, 0.0, top_lp[:, 0])
        toks[t] = tokens
        finished = finished | (sampled == dcfg.eos_id)
    seed = torch.full((B, 1), dcfg.bos_id, dtype=torch.long, device=device)
    return {"token_ids": torch.cat([seed, toks.T], dim=1),
            "log_probs": lps.T, "finished": finished}


def predict_forced(params: dict, cfg: CaptionerConfig, batch: dict,
                   token_ids: torch.Tensor, with_log_probs: bool = False,
                   kv_cache: str = "fp", fused_topk: bool = False):
    """Teacher-forced next-token argmax for a KNOWN sequence: feeds
    token_ids[:, t] through the incremental decode path and records each
    step's top-1 without letting it steer the next step (the numerics-gate
    primitive: no greedy cascade). token_ids: [B, T+1] incl. the seed.
    Returns [B, T] predictions; with_log_probs also their log-probs."""
    dcfg = cfg.decoder
    _, _, state = _decode_setup(params, cfg, batch,
                                steps=token_ids.shape[1] - 1,
                                kv_cache=kv_cache)
    preds, lps = [], []
    for t in range(token_ids.shape[1] - 1):
        feats, state = decoder_step(params["decoder"], dcfg,
                                    token_ids[:, t], state)
        lp, idx = decoder_top_k(params["decoder"], dcfg, feats, 1, fused_topk)
        preds.append(idx[:, 0])
        lps.append(lp[:, 0])
    preds = torch.stack(preds, dim=1)
    return (preds, torch.stack(lps, dim=1)) if with_log_probs else preds


class Captioner(nn.Module):
    """The captioner's params as an nn.Module (so .to(device) and
    state_dict() work); the methods call the plain functions."""

    def __init__(self, params: dict, cfg: CaptionerConfig):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    def tree(self) -> dict:
        return self.params.tree()

    def generate(self, batch: dict, early_stop: bool = True,
                 kv_cache: str = "fp", fused_topk: bool = False) -> dict:
        return generate(self.tree(), self.cfg, batch, early_stop, kv_cache,
                        fused_topk)

    def beam_search(self, batch: dict, beam_size: int = 5,
                    length_penalty: float = 0.0, early_stop: bool = True,
                    kv_cache: str = "fp", fused_topk: bool = False) -> dict:
        from .beam import beam_search
        return beam_search(self.tree(), self.cfg, batch, beam_size,
                           length_penalty, early_stop, kv_cache, fused_topk)

    def predict_forced(self, batch: dict, token_ids: torch.Tensor,
                       with_log_probs: bool = False, kv_cache: str = "fp",
                       fused_topk: bool = False):
        return predict_forced(self.tree(), self.cfg, batch, token_ids,
                              with_log_probs, kv_cache, fused_topk)
