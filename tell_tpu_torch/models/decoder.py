"""DynamicConv caption decoder (counterpart of tell_tpu/models/decoder.py):
the teacher-forced forward and loss of training, and the decode path with
an fp K/V cache.

Layer structure (post-norm, as every shipped config; with
normalize_before and final_norm a LayerNorm follows the last layer):

    x - linear1 -> GLU -> dynamic or lightweight conv -> linear2
      - +residual -> LN                                         (conv)
    for each context c: LN(x + cross_attn_c(x))            (parallel branches)
    x = context_fc(concat(branches))                           (no residual)
    x - relu(fc1) -> fc2 - +residual -> LN                            (FFN)

Training (decoder_forward / decoder_loss) runs the layer over the whole
caption: the conv through dynamic_conv (kernel C where tell_tpu fuses it),
one cross-attention per context, dropout from an explicit torch.Generator.

Decoding shares ONE attention chain per layer across the context
branches: the modalities' K/V are concatenated on the source axis and a
segment bias keeps each query row on its own modality; the modality and
beam axes ride the query-row axis of kernel A
(ops/kernels/decode_attention.py). K/V are stored head-major and
transposed, [B, H, hd, S], as in the JAX decode state, in fp or, with
kv_cache="int8"/"int4", quantised per source column and head with fp32
scales (kernel D; tell_tpu's TELL_TPU_KV8/TELL_TPU_KV4, off by default as
off the TPU). The step is fixed-shape, so it can later be captured as one
CUDA graph. decoder_step(need_weights=True) also returns the head-averaged
attention maps; that route takes the plain attention, since kernel A
returns no probabilities (tell_tpu routes the same way, decoder.py:452).

Positions come from the static sinusoidal table or, with positional
"learned", from the trainable params["pos_embed"]["table"], both looked
up at pad-aware positions.
"""
from __future__ import annotations

import functools

import torch

from ..config import DecoderConfig
from ..ops.adaptive import (adaptive_embed, adaptive_log_probs,
                            adaptive_softmax_loss, adaptive_top_k,
                            merged_embed_table)
from ..ops.attention import cross_attention_with_kv, precompute_kv
from ..ops.common import dropout, glu, layer_norm
from ..ops.dynamic_conv import (dynamic_conv, dynamic_conv_step,
                                init_conv_state, lightweight_conv,
                                lightweight_conv_step)
from ..ops.kernels.decode_attention import (decode_attention,
                                            decode_attention_plain,
                                            decode_attention_q8,
                                            decode_attention_q8_plain,
                                            segment_bias)
from ..ops.linear import gehring_linear
from ..ops.positional import sinusoidal_embed, sinusoidal_table
from ..parallel.comm import world_size


@functools.lru_cache(maxsize=8)
def _pos_table(n: int, dim: int, pad: int, device: torch.device
               ) -> torch.Tensor:
    """The static sinusoidal table only: a trainable table is never
    cached."""
    return torch.from_numpy(sinusoidal_table(n, dim, padding_idx=pad)
                            ).to(device)


def _positional_table(params: dict, cfg: DecoderConfig,
                      device: torch.device) -> torch.Tensor:
    if cfg.positional == "learned":
        return params["pos_embed"]["table"]
    return _pos_table(cfg.max_target_positions + cfg.pad_id + 2,
                      cfg.embed_dim, cfg.pad_id, device)


# ---------------------------------------------------------------------------
# teacher-forced forward and loss (training)
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
                 gen: torch.Generator | None = None,
                 deterministic: bool = True,
                 start_pos: torch.Tensor | int = 0) -> torch.Tensor:
    """Adaptive + positional embeddings of ids [B, T], dropout. start_pos
    shifts the non-pad positions (a decode step's token at step t)."""
    x = adaptive_embed(params["embed"], ids, cfg.full_cutoffs, cfg.embed_dim,
                       padding_idx=cfg.embed_padding_idx,
                       scale_embeds=cfg.scale_embeds)
    table = _positional_table(params, cfg, ids.device)
    x = x + sinusoidal_embed(table, ids.long(), cfg.pad_id,
                             start_pos).to(x.dtype)
    return dropout(x, cfg.dropout, gen, deterministic)


def _conv_block_full(lp: dict, cfg: DecoderConfig, kernel_size: int,
                     x: torch.Tensor, gen: torch.Generator | None,
                     deterministic: bool) -> torch.Tensor:
    residual = x
    h = dropout(x, cfg.input_dropout, gen, deterministic)
    h = gehring_linear(lp["linear1"], h)
    if cfg.glu:
        h = glu(h)
    conv = dynamic_conv if cfg.conv_type == "dynamic" else lightweight_conv
    h = conv(lp["conv"], h, kernel_size=kernel_size, num_heads=cfg.num_heads,
             weight_softmax=cfg.weight_softmax,
             weight_dropout=cfg.weight_dropout, gen=gen,
             deterministic=deterministic)
    h = gehring_linear(lp["linear2"], h)
    h = dropout(h, cfg.dropout, gen, deterministic)
    return layer_norm(lp["conv_ln"], residual + h)


def _attn_and_ffn(lp: dict, cfg: DecoderConfig, x: torch.Tensor, kv: dict,
                  gen: torch.Generator | None,
                  deterministic: bool) -> torch.Tensor:
    """The cross-attention branches + context_fc + FFN of one layer over the
    whole sequence, given each context's precomputed K/V."""
    branches = []
    for spec in cfg.contexts:
        k, v, mask = kv[spec.name]
        out, _ = cross_attention_with_kv(
            lp["attn"][spec.name], x, k, v, mask, num_heads=cfg.num_heads,
            attn_dropout=cfg.attention_dropout, gen=gen,
            deterministic=deterministic)
        out = dropout(out, cfg.dropout, gen, deterministic)
        branches.append(layer_norm(lp["attn_ln"][spec.name], x + out))
    h = gehring_linear(lp["context_fc"], torch.cat(branches, dim=-1))
    residual = h
    h = torch.relu(gehring_linear(lp["fc1"], h))
    h = dropout(h, cfg.relu_dropout, gen, deterministic)
    h = gehring_linear(lp["fc2"], h)
    h = dropout(h, cfg.dropout, gen, deterministic)
    return layer_norm(lp["final_ln"], residual + h)


def precompute_context_kv(params: dict, cfg: DecoderConfig,
                          contexts: dict) -> list[dict]:
    """Per-layer, per-context projected K/V (+bias/zero columns) and masks.
    contexts: {name: (features [B, S, D], padding mask [B, S] True = pad)}."""
    return [{spec.name: precompute_kv(lp["attn"][spec.name],
                                      *contexts[spec.name])
             for spec in cfg.contexts}
            for lp in params["layers"]]


def decoder_forward(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
                    contexts: dict, gen: torch.Generator | None = None,
                    deterministic: bool = True) -> torch.Tensor:
    """Teacher-forced forward. ids: [B, T] -> features [B, T, E]. (tell_tpu
    also returns attention maps here; the port's maps come from the decode
    path, decoder_step(need_weights=True).)"""
    x = embed_tokens(params, cfg, ids, gen, deterministic)
    kvs = precompute_context_kv(params, cfg, contexts)
    for lp, k, kv in zip(params["layers"], cfg.kernel_sizes, kvs):
        x = _conv_block_full(lp, cfg, k, x, gen, deterministic)
        x = _attn_and_ffn(lp, cfg, x, kv, gen, deterministic)
    if "final_ln" in params:
        x = layer_norm(params["final_ln"], x)
    return x


def decoder_loss(params: dict, cfg: DecoderConfig, caption_ids: torch.Tensor,
                 contexts: dict, gen: torch.Generator | None = None,
                 deterministic: bool = True, group=None
                 ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Adaptive-softmax loss on right-shifted targets. caption_ids: [B, T] =
    <s> tokens </s> pads; inputs ids[:, :-1], targets ids[:, 1:].
    Returns (loss_sum in nats, sample_size, aux). group: the data-parallel
    ranks, each holding B rows of the global batch (None: one rank), whose
    tail capacity is the global batch's."""
    inputs = caption_ids[:, :-1]
    targets = caption_ids[:, 1:]
    feats = decoder_forward(params, cfg, inputs, contexts, gen,
                            deterministic)
    B, T, E = feats.shape
    cap = None
    if cfg.tail_capacity_frac is not None:
        n = B * T * (1 if group is None else world_size(group))
        cap = tuple(max(int(n * f), 8) for f in cfg.tail_capacity_frac)
    return adaptive_softmax_loss(
        params["adaptive_softmax"], params["embed"], feats.reshape(B * T, E),
        targets.reshape(-1), cfg.full_cutoffs, pad_id=cfg.pad_id,
        padding_idx=cfg.embed_padding_idx, tail_capacity=cap,
        drop_rate=cfg.adaptive_softmax_dropout, gen=gen,
        deterministic=deterministic, tail_group=group)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

KV_CACHE_MODES = ("fp", "int8", "int4")


def quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t: [B, H, hd, S] -> (int8 values, fp32 scales [B, H, 1, S]): one
    symmetric scale per source column and head (tell_tpu's _quantize_kv;
    torch.round and jnp.round both round half to even, so the bytes are
    JAX's)."""
    t32 = t.float()
    scale = t32.abs().amax(dim=2, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(t32 / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv4(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t: [B, H, hd, S] -> (nibble-packed int8 [B, H, hd/2, S], fp32 scales
    [B, H, 1, S]) (tell_tpu's _quantize_kv4): byte d packs rows d and
    d + hd/2 as two's-complement low/high nibbles in [-7, 7], the layout
    unpack_int4 restores. The nibble arithmetic runs in int32 and is masked
    to 8 bits before the cast (JAX shifts in int8)."""
    hd = t.shape[2]
    if hd % 2:
        raise ValueError(f"int4 packing needs an even head dim, not {hd}")
    t32 = t.float()
    scale = t32.abs().amax(dim=2, keepdim=True).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(t32 / scale), -7, 7).to(torch.int32)
    packed = (q[:, :, :hd // 2] & 0x0F) | ((q[:, :, hd // 2:] << 4) & 0xF0)
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8), \
        scale


def _store_kv(cat: dict, kt: torch.Tensor, vt: torch.Tensor,
              kv_cache: str) -> None:
    """K/V [B, H, hd, S] into the layer's cat in the cache's numerics,
    contiguous (elementwise ops keep a permuted view's strides)."""
    kt, vt = kt.contiguous(), vt.contiguous()
    if kv_cache == "fp":
        cat["k"], cat["v"] = kt, vt
        return
    quant = quantize_kv4 if kv_cache == "int4" else quantize_kv
    cat["k"], cat["k_scale"] = quant(kt)
    cat["v"], cat["v_scale"] = quant(vt)


def precompute_context_kv_cat(params: dict, cfg, contexts: dict,
                              beam: int = 1, kv_cache: str = "fp"
                              ) -> list[dict]:
    """Per-layer K/V of all contexts, concatenated on the source axis with
    segment ids: the JAX package's single stacked chain (its
    context_groups() returns one group, tell_tpu/models/decoder.py:284-295).
    cfg is a DecoderConfig or an LLMConfig (read through .contexts and
    .num_heads); the branch LayerNorms are stacked where the layers have
    them (the flagship; the modern family's cross block has none).

    contexts: {name: (features [B, S, D], padding mask [B, S] True = pad)}.
    Returns per layer {k, v: [B, H, hd, S] contiguous (kv_cache "fp"), or
    int8 [B, H, hd, S] ("int8") or packed int4 [B, H, hd/2, S] ("int4")
    with k_scale, v_scale: fp32 [B, H, 1, S]; mask: [B, S] True = masked,
    seg: [S] modality index, the stacked per-modality q/out projections and
    branch LayerNorms, and the segment bias [B, M*beam, S], built once for
    all decode steps}."""
    if kv_cache not in KV_CACHE_MODES:
        raise ValueError(f"kv_cache {kv_cache!r} not in {KV_CACHE_MODES}")
    H = cfg.num_heads
    names = [spec.name for spec in cfg.contexts]
    kvs = []
    for lp in params["layers"]:
        ks, vs, masks, segs = [], [], [], []
        for m, name in enumerate(names):
            feats, mask = contexts[name]
            k, v, kmask = precompute_kv(lp["attn"][name], feats, mask)
            ks.append(k)
            vs.append(v)
            masks.append(kmask)
            segs.append(torch.full((k.shape[1],), m, dtype=torch.long,
                                   device=k.device))
        k = torch.cat(ks, dim=1)
        v = torch.cat(vs, dim=1)
        B, S, E = k.shape
        ap = lp["attn"]
        cat = {
            "mask": torch.cat(masks, dim=1),
            "seg": torch.cat(segs),
            "wq": torch.stack([ap[n]["q_proj"]["w"] for n in names]),
            "bq": torch.stack([ap[n]["q_proj"]["b"] for n in names]),
            "wo": torch.stack([ap[n]["out_proj"]["w"] for n in names]),
            "bo": torch.stack([ap[n]["out_proj"]["b"] for n in names]),
        }
        if "attn_ln" in lp:
            cat["ln_s"] = torch.stack([lp["attn_ln"][n]["scale"]
                                       for n in names])
            cat["ln_b"] = torch.stack([lp["attn_ln"][n]["bias"]
                                       for n in names])
        _store_kv(cat, k.reshape(B, S, H, E // H).permute(0, 2, 3, 1),
                  v.reshape(B, S, H, E // H).permute(0, 2, 3, 1), kv_cache)
        cat["bias"] = segment_bias(cat["seg"], cat["mask"], len(names), beam)
        kvs.append(cat)
    return kvs


def _ln_stacked(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with per-modality [M, E] params;
    x: [B, M, G, E]."""
    return layer_norm({"scale": scale[:, None], "bias": bias[:, None]}, x,
                      eps)


def attn_segment_bounds(cfg, contexts: dict
                        ) -> tuple[tuple[str, int, int], ...]:
    """(name, offset, length) of each modality on the concatenated source
    axis, its bias and zero columns included (tell_tpu's
    attn_segment_bounds for its single context group)."""
    bounds, off = [], 0
    for spec in cfg.contexts:
        n = contexts[spec.name][0].shape[1] + 2
        bounds.append((spec.name, off, n))
        off += n
    return tuple(bounds)


def split_attn_segments(bounds, probs: torch.Tensor) -> dict:
    """probs [..., M, G, S] -> {name: [..., G, S_m]}."""
    return {name: probs[..., m, :, off:off + n]
            for m, (name, off, n) in enumerate(bounds)}


def stacked_attention_core(num_heads: int, x: torch.Tensor, cat: dict,
                           need_weights: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Per-modality q/out projections stacked over a modality axis around
    one segment-masked attention chain over the concatenated K/V: kernel A
    over an fp cache, kernel D over an int8/int4 one (the cat holds
    scales), each on CUDA, their plain versions on the CPU. need_weights
    takes the plain attention on any device (the kernels return no
    probabilities) and also returns the head-averaged maps.
    x: [B, G, E] -> (out [B, M, G, E] before the residual, probs
    [B, M, G, S] or None)."""
    B, G, E = x.shape
    M = cat["wq"].shape[0]
    H = num_heads
    hd = E // H
    q = torch.einsum("bge,mef->bmgf", x, cat["wq"].to(x.dtype))
    q = (q + cat["bq"].to(x.dtype)[None, :, None, :]) * (hd ** -0.5)
    # fold the modality axis into the query rows: K/V are read once for
    # all M branches
    qh = q.reshape(B, M * G, H, hd).transpose(1, 2).contiguous()
    probs = None
    if need_weights and "k_scale" in cat:
        out, probs = decode_attention_q8_plain(
            qh, cat["k"], cat["k_scale"], cat["v"], cat["v_scale"],
            cat["bias"], with_probs=True)
    elif need_weights:
        out, probs = decode_attention_plain(qh, cat["k"], cat["v"],
                                            cat["bias"], with_probs=True)
    elif "k_scale" in cat:
        out = decode_attention_q8(qh, cat["k"], cat["k_scale"], cat["v"],
                                  cat["v_scale"], cat["bias"])
    else:
        out = decode_attention(qh, cat["k"], cat["v"], cat["bias"])
    # out: [B, H, MG, hd]
    out = out.transpose(1, 2).reshape(B, M, G, E)
    out = torch.einsum("bmge,mef->bmgf", out, cat["wo"].to(x.dtype))
    out = out + cat["bo"].to(x.dtype)[None, :, None, :]
    if probs is not None:
        probs = probs.mean(dim=1).reshape(B, M, G, -1)
    return out, probs


def _attn_group(cfg: DecoderConfig, x: torch.Tensor, cat: dict,
                need_weights: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The stacked attention chain with each branch's residual + LN.
    x: [B, G, E] -> (branches [B, M, G, E], probs [B, M, G, S] or None)."""
    out, probs = stacked_attention_core(cfg.num_heads, x, cat, need_weights)
    return _ln_stacked(cat["ln_s"], cat["ln_b"], x[:, None] + out), probs


def _attn_and_ffn_cat(lp: dict, cfg: DecoderConfig, x: torch.Tensor,
                      cat: dict, need_weights: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Cross-attention branches + context_fc + FFN for one decode step.
    x: [B, G, E] (G = beam or 1) -> (x', probs [B, M, G, S] or None)."""
    B, G, E = x.shape
    branches, probs = _attn_group(cfg, x, cat, need_weights)
    # concat(branches) in context order: [B, M, G, E] -> [B, G, M*E]
    h = branches.transpose(1, 2).reshape(B, G, -1)
    h = gehring_linear(lp["context_fc"], h)
    residual = h
    h = torch.relu(gehring_linear(lp["fc1"], h))
    h = gehring_linear(lp["fc2"], h)
    return layer_norm(lp["final_ln"], residual + h), probs


def decoder_log_probs(params: dict, cfg: DecoderConfig,
                      feats: torch.Tensor) -> torch.Tensor:
    """Full-vocabulary log-probs from decoder features [..., E] ->
    [..., V] fp32."""
    shape = feats.shape[:-1]
    lp = adaptive_log_probs(params["adaptive_softmax"], params["embed"],
                            feats.reshape(-1, feats.shape[-1]),
                            cfg.full_cutoffs,
                            padding_idx=cfg.embed_padding_idx)
    return lp.reshape(*shape, cfg.vocab_size)


def decoder_top_k(params: dict, cfg: DecoderConfig, feats: torch.Tensor,
                  k: int, fused_topk: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k next-token log-probs from step features [B, E]; the
    [B, V] distribution is never built. fused_topk streams each cluster's
    logits through kernel E (tell_tpu's TELL_TPU_TOPK, off by default)."""
    return adaptive_top_k(params["adaptive_softmax"], params["embed"],
                          feats, cfg.full_cutoffs, k,
                          padding_idx=cfg.embed_padding_idx,
                          fused=fused_topk)


def init_decode_state(params: dict, cfg: DecoderConfig, contexts: dict,
                      batch: int, beam: int = 1,
                      dtype: torch.dtype = torch.float32,
                      kv_cache: str = "fp") -> dict:
    """Fixed-shape decode state: conv windows + static K/V + step.

    K/V are stored once per batch element and shared by its beams (the
    beams ride the attention query rows), in the numerics kv_cache names
    (see precompute_context_kv_cat); conv windows are per row
    [batch * beam, K-1, C]."""
    device = next(iter(contexts.values()))[0].device
    R = batch * beam
    return {
        "kv": precompute_context_kv_cat(params, cfg, contexts, beam=beam,
                                        kv_cache=kv_cache),
        # dense projected embedding table: one gather per decode step
        "embed_table": merged_embed_table(
            params["embed"], cfg.full_cutoffs, cfg.embed_dim,
            padding_idx=cfg.embed_padding_idx,
            scale_embeds=cfg.scale_embeds).to(dtype),
        "step": torch.zeros((), dtype=torch.long, device=device),
        "conv": [init_conv_state(R, cfg.conv_dim, k, dtype, device)
                 for k in cfg.kernel_sizes],
    }


def decoder_step(params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
                 state: dict, row_gather: torch.Tensor | None = None,
                 need_weights: bool = False):
    """One decode step. tokens: [B*beam] -> (features [B*beam, E], state'),
    with need_weights (features, state', per-layer head-averaged maps
    [B, M, beam, S]).

    row_gather [B*beam]: beam parent indices applied to the conv windows
    as they are read (beam_search's fused reorder). K/V are per batch
    element and never need gathering. state["step"] is a scalar or, in the
    engine, one start position per row."""
    R = tokens.shape[0]
    B = state["kv"][0]["k"].shape[0]
    G = R // B
    tok_embed = state["embed_table"][tokens]
    table = _positional_table(params, cfg, tokens.device)
    pos = sinusoidal_embed(table, tokens[:, None], cfg.pad_id,
                           state["step"])[:, 0]
    x = tok_embed + pos.to(tok_embed.dtype)                      # [R, E]
    conv_step = (dynamic_conv_step if cfg.conv_type == "dynamic"
                 else lightweight_conv_step)
    new_conv, attns = [], []
    for i, (lp, k) in enumerate(zip(params["layers"], cfg.kernel_sizes)):
        residual = x
        h = gehring_linear(lp["linear1"], x)
        if cfg.glu:
            h = glu(h)
        h, buf = conv_step(lp["conv"], h, state["conv"][i], kernel_size=k,
                           num_heads=cfg.num_heads,
                           weight_softmax=cfg.weight_softmax,
                           row_gather=row_gather)
        new_conv.append(buf)
        h = gehring_linear(lp["linear2"], h)
        h = layer_norm(lp["conv_ln"], residual + h)
        h, probs = _attn_and_ffn_cat(lp, cfg, h.reshape(B, G, -1),
                                     state["kv"][i], need_weights)
        attns.append(probs)
        x = h.reshape(R, -1)
    if "final_ln" in params:
        x = layer_norm(params["final_ln"], x)
    new_state = {**state, "conv": new_conv, "step": state["step"] + 1}
    return (x, new_state, attns) if need_weights else (x, new_state)
