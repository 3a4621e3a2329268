"""Task model: multi-context news captioner (counterpart of
tell_tpu/models/captioner.py: weighted_layer_sum, mask_nan_embeds,
build_contexts, encode_contexts (article branch), captioner_loss,
captioner_loss_e2e, generate (greedy or top-k sampled, with or without
attention maps), predict_forced and replay_attention).

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
from .backbones.resnet import resnet_forward
from .backbones.roberta import roberta_encode_windowed
from .decoder import (attn_segment_bounds, decoder_loss, decoder_step,
                      decoder_top_k, init_decode_state, split_attn_segments)


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
    """Run the frozen towers a batch needs: the RoBERTa article encode for
    context_ids (frozen["roberta"], frozen["roberta_cfg"]), and the ResNet
    grid for a batch's preprocessed `image` [B, H, W, 3] that carries no
    image_grid (frozen["resnet"] in load_tower's layout,
    frozen["resnet_cfg"]). No gradient
    reaches a tower: they are frozen (tell_tpu stops gradients here,
    captioner.py:104-113), and kernel B has no backward."""
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
    if "image" in batch and "image_grid" not in batch:
        with torch.no_grad():
            out["image_grid"] = resnet_forward(
                frozen["resnet"], frozen["resnet_cfg"], batch["image"])
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
    return B, feat0.device, state, contexts


def _split_maps(cfg: CaptionerConfig, contexts: dict, steps: list) -> list:
    """Per-step per-layer maps [B, M, 1, S] -> per layer {name:
    [T, B, 1, S_m]} (tell_tpu's attns payload)."""
    bounds = attn_segment_bounds(cfg.decoder, contexts)
    return [split_attn_segments(bounds, torch.stack(layer))
            for layer in zip(*steps)]


def sample_top_k(top_lp: torch.Tensor, temp: float,
                 gen: torch.Generator) -> torch.Tensor:
    """A draw from softmax(top_lp / temp) per row, by the Gumbel-max trick
    (the method of tell_tpu's jax.random.categorical; the two frameworks
    draw other numbers). top_lp: [B, k] -> [B] column indices."""
    u = torch.rand(top_lp.shape, generator=gen, device=top_lp.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(top_lp / temp + gumbel, dim=-1)


def generate(params: dict, cfg: CaptionerConfig, batch: dict,
             early_stop: bool = True, kv_cache: str = "fp",
             fused_topk: bool = False, gen: torch.Generator | None = None,
             need_weights: bool = False) -> dict:
    """Greedy generation, or top-k sampled where cfg.sampling_topk > 1.
    kv_cache ("fp", "int8", "int4") and fused_topk are the decode numerics
    levers of decoder.init_decode_state and decoder.decoder_top_k.

    Sampling draws from `gen` (a torch.Generator on the batch's device;
    default: seed 0 there) among decoder_top_k's k candidates, with
    temperature cfg.sampling_temp shaping the draw only: the reported
    log_probs are the model's untempered log-probability of the sampled
    token.

    Returns {token_ids [B, gen_len+1] incl. the seed <s>, log_probs
    [B, gen_len], finished [B]}; need_weights adds attns, per layer a
    {context: [gen_len, B, 1, S_m]} dict of head-averaged maps (the plain
    attention, see decoder.stacked_attention_core). early_stop ends the
    loop once every row has emitted EOS; later steps would emit <pad> at
    log-prob 0, which is the buffers' prefill, so the result is the same.
    need_weights runs every step, as tell_tpu's scan does. A `row_live`
    bool vector in the batch marks filler rows, which start finished."""
    dcfg = cfg.decoder
    B, device, state, contexts = _decode_setup(params, cfg, batch,
                                               kv_cache=kv_cache)
    k = cfg.sampling_topk
    if k > 1 and gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.full((B,), dcfg.bos_id, dtype=torch.long, device=device)
    if "row_live" in batch:
        finished = ~batch["row_live"]
    else:
        finished = torch.zeros(B, dtype=torch.bool, device=device)
    toks = torch.full((cfg.gen_len, B), dcfg.pad_id, dtype=torch.long,
                      device=device)
    lps = torch.zeros(cfg.gen_len, B, device=device)
    maps = []
    for t in range(cfg.gen_len):
        if early_stop and not need_weights and bool(finished.all()):
            break
        feats, state, *attns = decoder_step(params["decoder"], dcfg, tokens,
                                            state, need_weights=need_weights)
        maps += attns
        top_lp, top_idx = decoder_top_k(params["decoder"], dcfg, feats, k,
                                        fused_topk)
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
        out["attns"] = _split_maps(cfg, contexts, maps)
    return out


def predict_forced(params: dict, cfg: CaptionerConfig, batch: dict,
                   token_ids: torch.Tensor, with_log_probs: bool = False,
                   kv_cache: str = "fp", fused_topk: bool = False):
    """Teacher-forced next-token argmax for a KNOWN sequence: feeds
    token_ids[:, t] through the incremental decode path and records each
    step's top-1 without letting it steer the next step (the numerics-gate
    primitive: no greedy cascade). token_ids: [B, T+1] incl. the seed.
    Returns [B, T] predictions; with_log_probs also their log-probs."""
    dcfg = cfg.decoder
    _, _, state, _ = _decode_setup(params, cfg, batch,
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


def replay_attention(params: dict, cfg: CaptionerConfig, batch: dict,
                     token_ids: torch.Tensor, kv_cache: str = "fp") -> list:
    """Attention maps of a KNOWN token sequence, teacher-forced: a step's
    cross-attention depends only on the token prefix, so replaying a
    finished caption gives the maps the decode loop would have recorded.
    The engine serves its attention payload this way. token_ids: [B, T+1]
    incl. the seed. Returns per layer {context: [T, B, 1, S_m]}."""
    dcfg = cfg.decoder
    _, _, state, contexts = _decode_setup(params, cfg, batch,
                                          steps=token_ids.shape[1] - 1,
                                          kv_cache=kv_cache)
    maps = []
    for t in range(token_ids.shape[1] - 1):
        _, state, attns = decoder_step(params["decoder"], dcfg,
                                       token_ids[:, t], state,
                                       need_weights=True)
        maps.append(attns)
    return _split_maps(cfg, contexts, maps)


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
                 kv_cache: str = "fp", fused_topk: bool = False,
                 gen: torch.Generator | None = None,
                 need_weights: bool = False) -> dict:
        return generate(self.tree(), self.cfg, batch, early_stop, kv_cache,
                        fused_topk, gen, need_weights)

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

    def replay_attention(self, batch: dict, token_ids: torch.Tensor,
                         kv_cache: str = "fp") -> list:
        return replay_attention(self.tree(), self.cfg, batch, token_ids,
                                kv_cache)
