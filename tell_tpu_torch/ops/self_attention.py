"""Gated self-attention and copy-attention scores for the pointer models
(counterpart of tell_tpu/ops/self_attention.py: gated_linear,
self_attention, copy_attention_scores). The initialisers
(init_gated_linear, init_self_attention, init_copy_attention) are in
bridge.py.

Kept from tell_tpu:

* STRICT causality: a position never attends to itself, only to the
  past;
* a scalar-bias column (score 0, value 0) PREPENDED to the source axis
  after masking, so step 0, which sees nothing, attends to the zero
  vector and outputs 0;
* the module's output is LayerNorm(x + out_proj(attn)), the
  out-projection shared across heads;
* copy_attention_scores: unpacked q/k in-projections, a learned bias-k
  column and a zero column APPENDED at the end of the source axis,
  padded keys masked, fp32 scores and softmax, dropout, then the mean
  over heads.

The products that tell_tpu sums into fp32 (preferred_element_type) are
taken here on fp32 copies of their operands, the same exact products.
"""
from __future__ import annotations

import torch

from .common import dropout, glu, layer_norm
from .linear import gehring_linear


def gated_linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Linear -> GLU -> Linear -> GLU -> Linear (fconv_self_att)."""
    h = glu(gehring_linear(params["l1"], x))
    h = glu(gehring_linear(params["l2"], h))
    return gehring_linear(params["l3"], h)


def _attend_strict_causal(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, num_heads: int, q_offset,
                          kv_valid: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Multi-head attention of q [B, T, E] at absolute positions
    q_offset + t over k/v [B, S, E] at positions 0..S-1, each query row
    over the keys strictly before it and a prepended zero column;
    kv_valid [B, S] (optional) marks the key rows that hold features."""
    B, T, E = q.shape
    S = k.shape[1]
    H = num_heads
    hd = E // H
    qh = (q * hd ** -0.5).reshape(B, T, H, hd)
    kh = k.reshape(B, S, H, hd)
    vh = v.reshape(B, S, H, hd)
    scores = torch.einsum("bthd,bshd->bhts", qh.float(), kh.float())
    tpos = torch.arange(T, device=q.device)[:, None] + q_offset
    spos = torch.arange(S, device=q.device)[None, :]
    scores = scores.masked_fill(~(spos < tpos)[None, None], float("-inf"))
    if kv_valid is not None:
        scores = scores.masked_fill(~kv_valid[:, None, None, :],
                                    float("-inf"))
    scores = torch.cat([scores.new_zeros(B, H, T, 1), scores], dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd",
                       probs[..., 1:].to(q.dtype).float(), vh.float())
    return out.reshape(B, T, E).to(q.dtype)


def self_attention(params: dict, x: torch.Tensor, num_heads: int = 16,
                   q_offset=0, kv: torch.Tensor | None = None,
                   kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """x: [B, T, E] -> LayerNorm(x + out_proj(strict-causal attention)).

    Incremental decode passes the whole feature history [B, G, E] as `kv`
    (kv_valid marking its filled rows) and the current step's features as
    x at absolute position q_offset (an int or a 0-d tensor)."""
    src = x if kv is None else kv
    q = gehring_linear(params["in_proj_q"], x)
    k = gehring_linear(params["in_proj_k"], src)
    v = gehring_linear(params["in_proj_v"], src)
    attn = _attend_strict_causal(q, k, v, num_heads, q_offset, kv_valid)
    attn = gehring_linear(params["out_proj"], attn)
    return layer_norm(params["ln"], x + attn)


def copy_attention_keys(params: dict, key: torch.Tensor) -> torch.Tensor:
    """The copy attention's projected keys with the bias-k column and the
    zero column appended: key [B, S, Dk] -> [B, S + 2, E]. Decoding
    projects them once per caption, not once per step (tell_tpu projects
    inside the step and XLA hoists it out of the scan)."""
    B = key.shape[0]
    k = key @ params["k_w"].to(key.dtype) + params["k_b"].to(key.dtype)
    E = k.shape[-1]
    bias_k = params["bias_k"].to(k.dtype).expand(B, 1, E)
    return torch.cat([k, bias_k, k.new_zeros(B, 1, E)], dim=1)


def copy_attention_scores(params: dict, query: torch.Tensor,
                          keys: torch.Tensor,
                          key_padding_mask: torch.Tensor | None = None,
                          num_heads: int = 16, drop_rate: float = 0.0,
                          gen: torch.Generator | None = None,
                          deterministic: bool = True) -> torch.Tensor:
    """Head-averaged attention probabilities of caption positions over
    article positions: query [B, L, E] and the article's
    copy_attention_keys [B, S + 2, E] -> fp32 probs [B, L, S + 2] (the
    bias-k column at S, the zero column at S + 1; callers slice
    [..., :-2]). key_padding_mask [B, S]: True = pad."""
    B, L, E = query.shape
    S2 = keys.shape[1]
    H = num_heads
    hd = E // H
    q = query @ params["q_w"].to(query.dtype) \
        + params["q_b"].to(query.dtype)
    q = q * hd ** -0.5
    scores = torch.einsum("blhd,bshd->bhls",
                          q.reshape(B, L, H, hd).float(),
                          keys.reshape(B, S2, H, hd).float())
    if key_padding_mask is not None:
        pad = torch.cat([key_padding_mask, key_padding_mask.new_zeros(
            B, 2)], dim=1)
        scores = scores.masked_fill(pad[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = dropout(probs, drop_rate, gen, deterministic)
    return probs.mean(dim=1)
