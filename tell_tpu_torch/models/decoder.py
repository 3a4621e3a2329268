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

The int8 numerics levers (decode_levers) are built once a decode call:
dec8 (tell_tpu's TELL_TPU_DEC8) runs the step's linear1, linear2,
context_fc, fc1 and fc2 through kernel G on weights quantised once from
their weight-normed form (decode_step_quant); dec8_sm (TELL_TPU_DEC8_SM)
the softmax's head and tails on int8 tables (decode_softmax_quant);
merged_vocab (TELL_TPU_MERGED_VOCAB) every cluster's logits from one fp32
table (decode_vocab_table).

Positions come from the static sinusoidal table or, with positional
"learned", from the trainable params["pos_embed"]["table"], both looked
up at pad-aware positions.

Under tensor parallelism (the `tp` argument, a parallel/comm.py
ModelAxis of more than one rank; training only) a rank holds its heads' cross-attention q/k/v columns and
out_proj rows, fc1's columns and fc2's rows (the row-parallel outputs
summed over "model"; fc2's weight norm sums the ranks' squares), and
its rows of each vocabulary band (a masked lookup summed over "model";
the tied softmax gathers each band whole: ops/adaptive.py's
whole_bands). The conv block, the layer norms and context_fc run on
every rank alike. The default `tp`, ONE_RANK, shards nothing: the same
code is then the one-rank forward.
"""
from __future__ import annotations

import functools

import torch

from ..config import DecoderConfig
from ..ops.adaptive import (adaptive_embed, adaptive_log_probs,
                            adaptive_softmax_loss, adaptive_top_k,
                            merged_decode_table, merged_embed_table,
                            quantize_softmax_tables, whole_bands)
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
from ..ops.linear import gehring_linear, gehring_weight
from ..ops.quant import int8_linear, quantize_weight_int8
from ..ops.positional import sinusoidal_embed, sinusoidal_table
from ..parallel.comm import ONE_RANK, ModelAxis, world_size


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
                 start_pos: torch.Tensor | int = 0,
                 tp: ModelAxis = ONE_RANK) -> torch.Tensor:
    """Adaptive + positional embeddings of ids [B, T], dropout. start_pos
    shifts the non-pad positions (a decode step's token at step t)."""
    x = adaptive_embed(params["embed"], ids, cfg.full_cutoffs, cfg.embed_dim,
                       padding_idx=cfg.embed_padding_idx,
                       scale_embeds=cfg.scale_embeds, tp=tp)
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


# ---------------------------------------------------------------------------
# tensor parallelism (the `tp` axis): a rank holds its heads' q/k/v
# columns and out_proj rows, fc1's columns and fc2's rows
# ---------------------------------------------------------------------------

# the cross-attention leaves the rules shard, with the dim: q/k/v along
# their E output columns, out_proj along its E input rows; each divides
# as E does, so one rule decides them all (out_proj's bias is replicated)
_CROSS_SHARDS = (("q_proj", "w", 1), ("q_proj", "b", 0), ("k_proj", "w", 1),
                 ("k_proj", "b", 0), ("v_proj", "w", 1), ("v_proj", "b", 0),
                 ("out_proj", "w", 0))


def tp_cross_attention(p: dict, num_heads: int, tp: ModelAxis) -> dict:
    """How this rank runs one cross-attention: {"params", "heads",
    "split", "out_b"}. Split by heads where the rules shard the
    projections and the heads divide over "model": q/k/v are the rank's
    columns, bias_k/bias_v its slice, out_proj its rows with the bias
    left for after the sum. Otherwise every leaf is read whole (a shard
    gathered) and the branch runs as on one rank."""
    E = p["q_proj"]["w"].shape[0]
    sharded = tp.split("/attn/c/q_proj/w", (E, E))
    if not sharded or num_heads % tp.size:
        whole = {n: dict(p[n]) for n in ("q_proj", "k_proj", "v_proj",
                                         "out_proj")}
        for n, k, dim in _CROSS_SHARDS:
            if k in whole[n]:
                whole[n][k] = tp.whole(p[n][k], dim, sharded)
        return {"params": {**p, **whole}, "heads": num_heads,
                "split": False, "out_b": None}
    local = {**p, "out_proj": {"w": p["out_proj"]["w"]}}
    for n in ("bias_k", "bias_v"):
        if n in p:
            local[n] = tp.part(p[n], -1)
    return {"params": local, "heads": num_heads // tp.size, "split": True,
            "out_b": p["out_proj"].get("b")}


def tp_context_kv(a: dict, feats: torch.Tensor, mask, tp: ModelAxis):
    """precompute_kv of one context with tp_cross_attention's params."""
    return precompute_kv(a["params"], tp.enter(feats) if a["split"]
                         else feats, mask)


def tp_attend(a: dict, x: torch.Tensor, k, v, mask, cfg, gen,
              deterministic: bool, tp: ModelAxis) -> torch.Tensor:
    """The branch's attention output [B, T, E], whole on every rank: a
    split branch sums its heads' out_proj parts over "model"."""
    out, _ = cross_attention_with_kv(
        a["params"], tp.enter(x) if a["split"] else x, k, v, mask,
        num_heads=a["heads"], attn_dropout=cfg.attention_dropout, gen=gen,
        deterministic=deterministic,
        head_shard=tp.shard(1) if a["split"] else None)
    if not a["split"]:
        return out
    y = tp.reduce(out.float())
    if a["out_b"] is not None:
        y = y + a["out_b"]
    return y.to(x.dtype)


def row_parallel_linear(p: dict, h: torch.Tensor, tp: ModelAxis
                        ) -> torch.Tensor:
    """h [..., F/n] (this rank's columns) @ the layer's rows, summed over
    "model", plus the bias. A weight-normed layer's norm over its split
    input axis sums the ranks' squares first (the effective weight is the
    one-rank layer's, rows sliced)."""
    if "w" in p:
        w = p["w"]
    else:
        v = p["v"]
        sq = tp.reduce(v.float().square().sum(dim=0, keepdim=True))
        scale = p["g"] / sq.sqrt().clamp_min(1e-12)
        w = tp.enter(scale).to(v.dtype) * v
    y = tp.reduce(torch.matmul(h, w).float())
    if "b" in p:
        y = y + p["b"]
    return y.to(h.dtype)


def _ffn_block(lp: dict, cfg: DecoderConfig, h: torch.Tensor,
               gen: torch.Generator | None, deterministic: bool,
               tp: ModelAxis) -> torch.Tensor:
    """relu(fc1) -> dropout -> fc2; column- then row-parallel where the
    rules shard fc1's columns and fc2's rows."""
    if not tp.split("/fc1/w", (cfg.embed_dim, cfg.ffn_dim)):
        h = torch.relu(gehring_linear(lp["fc1"], h))
        h = dropout(h, cfg.relu_dropout, gen, deterministic)
        return gehring_linear(lp["fc2"], h)
    h = torch.relu(gehring_linear(lp["fc1"], tp.enter(h)))
    h = dropout(h, cfg.relu_dropout, gen, deterministic, shard=tp.shard(-1))
    return row_parallel_linear(lp["fc2"], h, tp)


def _attn_and_ffn(lp: dict, cfg: DecoderConfig, x: torch.Tensor, kv: dict,
                  gen: torch.Generator | None, deterministic: bool,
                  tp: ModelAxis) -> torch.Tensor:
    """The cross-attention branches + context_fc + FFN of one layer over the
    whole sequence, given each context's precomputed K/V and, under "tp",
    its tp_cross_attention."""
    branches = []
    for spec in cfg.contexts:
        k, v, mask = kv[spec.name]
        out = tp_attend(kv["tp"][spec.name], x, k, v, mask, cfg, gen,
                        deterministic, tp)
        out = dropout(out, cfg.dropout, gen, deterministic)
        branches.append(layer_norm(lp["attn_ln"][spec.name], x + out))
    h = gehring_linear(lp["context_fc"], torch.cat(branches, dim=-1))
    residual = h
    h = _ffn_block(lp, cfg, h, gen, deterministic, tp)
    h = dropout(h, cfg.dropout, gen, deterministic)
    return layer_norm(lp["final_ln"], residual + h)


def precompute_context_kv(params: dict, cfg: DecoderConfig, contexts: dict,
                          tp: ModelAxis = ONE_RANK) -> list[dict]:
    """Per-layer, per-context projected K/V (+bias/zero columns) and masks.
    contexts: {name: (features [B, S, D], padding mask [B, S] True = pad)}.
    Under tensor parallelism each is this rank's heads' K/V; "tp" holds
    each context's tp_cross_attention."""
    out = []
    for lp in params["layers"]:
        a = {spec.name: tp_cross_attention(lp["attn"][spec.name],
                                           cfg.num_heads, tp)
             for spec in cfg.contexts}
        kv = {n: tp_context_kv(a[n], *contexts[n], tp) for n in a}
        out.append({**kv, "tp": a})
    return out


def decoder_forward(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
                    contexts: dict, gen: torch.Generator | None = None,
                    deterministic: bool = True, tp: ModelAxis = ONE_RANK
                    ) -> torch.Tensor:
    """Teacher-forced forward. ids: [B, T] -> features [B, T, E]. (tell_tpu
    also returns attention maps here; the port's maps come from the decode
    path, decoder_step(need_weights=True).) tp: the "model" axis the
    params' shards lie over."""
    x = embed_tokens(params, cfg, ids, gen, deterministic, tp=tp)
    kvs = precompute_context_kv(params, cfg, contexts, tp)
    for lp, k, kv in zip(params["layers"], cfg.kernel_sizes, kvs):
        x = _conv_block_full(lp, cfg, k, x, gen, deterministic)
        x = _attn_and_ffn(lp, cfg, x, kv, gen, deterministic, tp)
    if "final_ln" in params:
        x = layer_norm(params["final_ln"], x)
    return x


def decoder_loss(params: dict, cfg: DecoderConfig, caption_ids: torch.Tensor,
                 contexts: dict, gen: torch.Generator | None = None,
                 deterministic: bool = True, group=None,
                 tp: ModelAxis = ONE_RANK
                 ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Adaptive-softmax loss on right-shifted targets. caption_ids: [B, T] =
    <s> tokens </s> pads; inputs ids[:, :-1], targets ids[:, 1:].
    Returns (loss_sum in nats, sample_size, aux). group: the data-parallel
    ranks, each holding B rows of the global batch (None: one rank), whose
    tail capacity is the global batch's. tp: the "model" axis."""
    inputs = caption_ids[:, :-1]
    targets = caption_ids[:, 1:]
    feats = decoder_forward(params, cfg, inputs, contexts, gen,
                            deterministic, tp)
    B, T, E = feats.shape
    cap = None
    if cfg.tail_capacity_frac is not None:
        n = B * T * (1 if group is None else world_size(group))
        cap = tuple(max(int(n * f), 8) for f in cfg.tail_capacity_frac)
    return adaptive_softmax_loss(
        params["adaptive_softmax"],
        whole_bands(params["embed"], cfg.full_cutoffs, tp),
        feats.reshape(B * T, E),
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


def _step_lin(lp: dict, q8: dict | None, name: str, x: torch.Tensor
              ) -> torch.Tensor:
    """A decode step's dense layer: kernel G over the layer's
    decode_step_quant tables, or the exact weight-normed matmul."""
    if q8 is not None:
        return int8_linear(q8[name], x)
    return gehring_linear(lp[name], x)


def _attn_and_ffn_cat(lp: dict, cfg: DecoderConfig, x: torch.Tensor,
                      cat: dict, need_weights: bool = False,
                      q8: dict | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Cross-attention branches + context_fc + FFN for one decode step.
    x: [B, G, E] (G = beam or 1) -> (x', probs [B, M, G, S] or None). q8:
    the layer's decode_step_quant tables (context_fc and the FFN in
    int8)."""
    B, G, E = x.shape
    branches, probs = _attn_group(cfg, x, cat, need_weights)
    # concat(branches) in context order: [B, M, G, E] -> [B, G, M*E]
    h = branches.transpose(1, 2).reshape(B, G, -1)
    h = _step_lin(lp, q8, "context_fc", h)
    residual = h
    h = torch.relu(_step_lin(lp, q8, "fc1", h))
    h = _step_lin(lp, q8, "fc2", h)
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
                  k: int, fused_topk: bool = False,
                  vocab_table: torch.Tensor | None = None,
                  quant_sm: dict | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k next-token log-probs from step features [B, E]; the
    [B, V] distribution is never built. fused_topk streams each cluster's
    logits through kernel E (tell_tpu's TELL_TPU_TOPK, off by default);
    vocab_table (decode_vocab_table) and quant_sm (decode_softmax_quant)
    are the merged-table and int8-table routes, which take precedence
    (ops/adaptive.py::adaptive_top_k)."""
    return adaptive_top_k(params["adaptive_softmax"], params["embed"],
                          feats, cfg.full_cutoffs, k,
                          padding_idx=cfg.embed_padding_idx,
                          fused=fused_topk, vocab_table=vocab_table,
                          quant_sm=quant_sm)


def decode_vocab_table(params: dict, cfg: DecoderConfig) -> torch.Tensor:
    """The merged fp32 [E, V + n_tails] softmax table of the decode loop
    (ops/adaptive.py::merged_decode_table; tell_tpu's TELL_TPU_MERGED_VOCAB
    lever), kept fp32 whatever the compute dtype: rounding the composed
    tail products to bf16 can flip near-tie top-k ids."""
    return merged_decode_table(params["adaptive_softmax"], params["embed"],
                               cfg.full_cutoffs,
                               padding_idx=cfg.embed_padding_idx)


def decode_softmax_quant(params: dict, cfg: DecoderConfig) -> dict:
    """The int8 decode softmax tables (ops/adaptive.py::
    quantize_softmax_tables; tell_tpu's TELL_TPU_DEC8_SM lever)."""
    return quantize_softmax_tables(params["adaptive_softmax"],
                                   params["embed"], cfg.full_cutoffs,
                                   padding_idx=cfg.embed_padding_idx)


_STEP_DENSE = ("linear1", "linear2", "context_fc", "fc1", "fc2")


def decode_step_quant(params: dict) -> list[dict]:
    """Per layer, the decode step's linear1, linear2, context_fc, fc1 and
    fc2 in int8 (tell_tpu's TELL_TPU_DEC8 lever): each weight-normed weight
    made once (gehring_weight), then quantised per output channel, its bias
    kept fp32."""
    out = []
    for lp in params["layers"]:
        layer = {}
        for name in _STEP_DENSE:
            q = quantize_weight_int8(gehring_weight(lp[name]))
            if "b" in lp[name]:
                q["b"] = lp[name]["b"].float()
            layer[name] = q
        out.append(layer)
    return out


def decode_levers(params: dict, cfg: DecoderConfig, dec8: bool = False,
                  dec8_sm: bool = False, merged_vocab: bool = False) -> dict:
    """The tables of the int8 numerics levers that are on, built once a
    decode call and read by every step: {"step_quant": decode_step_quant
    or None, "quant_sm": decode_softmax_quant or None, "vocab_table":
    decode_vocab_table or None}. The merged table wins over the int8
    softmax tables (adaptive_top_k), so with both asked for only it is
    built."""
    return {
        "step_quant": decode_step_quant(params) if dec8 else None,
        "quant_sm": (decode_softmax_quant(params, cfg)
                     if dec8_sm and not merged_vocab else None),
        "vocab_table": (decode_vocab_table(params, cfg) if merged_vocab
                        else None)}


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
                 need_weights: bool = False, quant: list | None = None):
    """One decode step. tokens: [B*beam] -> (features [B*beam, E], state'),
    with need_weights (features, state', per-layer head-averaged maps
    [B, M, beam, S]).

    row_gather [B*beam]: beam parent indices applied to the conv windows
    as they are read (beam_search's fused reorder). K/V are per batch
    element and never need gathering. state["step"] is a scalar or, in the
    engine, one start position per row. quant: decode_step_quant's
    per-layer int8 tables (the dec8 lever), or None."""
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
        q8 = quant[i] if quant else None
        residual = x
        h = _step_lin(lp, q8, "linear1", x)
        if cfg.glu:
            h = glu(h)
        h, buf = conv_step(lp["conv"], h, state["conv"][i], kernel_size=k,
                           num_heads=cfg.num_heads,
                           weight_softmax=cfg.weight_softmax,
                           row_gather=row_gather)
        new_conv.append(buf)
        h = _step_lin(lp, q8, "linear2", h)
        h = layer_norm(lp["conv_ln"], residual + h)
        h, probs = _attn_and_ffn_cat(lp, cfg, h.reshape(B, G, -1),
                                     state["kv"][i], need_weights, q8)
        attns.append(probs)
        x = h.reshape(R, -1)
    if "final_ln" in params:
        x = layer_norm(params["final_ln"], x)
    new_state = {**state, "conv": new_conv, "step": state["step"] + 1}
    return (x, new_state, attns) if need_weights else (x, new_state)
