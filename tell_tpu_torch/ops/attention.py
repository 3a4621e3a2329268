"""Multi-head cross-attention over a context (counterpart of
tell_tpu/ops/attention.py): a context is projected to K/V once per
sequence (precompute_kv), with the learned bias column (add_bias_kv) and a
zero column (add_zero_attn) appended, so the decoder can attend to
"nothing"; cross_attention_with_kv attends to it (the teacher-forced
forward's path; decoding stacks the contexts through kernel A instead).
"""
from __future__ import annotations

import torch

from .common import dropout
from .linear import linear


def precompute_kv(params: dict, key: torch.Tensor,
                  key_padding_mask: torch.Tensor | None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """key: [B, S, Dk]; key_padding_mask: [B, S] bool, True = padding.
    Returns (k, v, mask) with S' = S (+1 bias when the params have
    bias_k/bias_v) +1 zero columns: k, v [B, S', E]; mask [B, S'] True =
    masked out."""
    B, S, _ = key.shape
    k = linear(params["k_proj"], key)
    v = linear(params["v_proj"], key)
    if key_padding_mask is None:
        key_padding_mask = torch.zeros(B, S, dtype=torch.bool,
                                       device=key.device)
    cols, vols, masks = [k], [v], [key_padding_mask]
    no_pad = torch.zeros(B, 1, dtype=torch.bool, device=key.device)
    if "bias_k" in params:
        E = k.shape[-1]
        cols.append(params["bias_k"].to(k.dtype).expand(B, 1, E))
        vols.append(params["bias_v"].to(v.dtype).expand(B, 1, E))
        masks.append(no_pad)
    cols.append(k.new_zeros(B, 1, k.shape[-1]))
    vols.append(v.new_zeros(B, 1, v.shape[-1]))
    masks.append(no_pad)
    return (torch.cat(cols, dim=1), torch.cat(vols, dim=1),
            torch.cat(masks, dim=1))


def cross_attention_with_kv(params: dict, query: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            mask: torch.Tensor, *, num_heads: int,
                            attn_dropout: float = 0.0,
                            gen: torch.Generator | None = None,
                            deterministic: bool = True,
                            need_weights: bool = False,
                            head_shard: tuple[int, int, int] | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Attention against precomputed K/V. query: [B, T, E]; k, v:
    [B, S', E]; mask: [B, S'] True = masked. fp32 scores and softmax; the
    (dropped-out) probabilities are cast to the query's dtype before the
    value contraction. Returns (out [B, T, E], head-averaged probabilities
    [B, T, S'] when need_weights). A tensor-parallel rank passes its
    num_heads heads' q/k/v columns (E is then q_proj's width) and
    head_shard, dropout's shard of the probabilities' head dim."""
    B, T, _ = query.shape
    H = num_heads
    E = params["q_proj"]["w"].shape[1]
    hd = E // H
    q = linear(params["q_proj"], query) * (hd ** -0.5)
    qh = q.reshape(B, T, H, hd)
    kh = k.reshape(B, -1, H, hd)
    vh = v.reshape(B, -1, H, hd)
    scores = torch.einsum("bthd,bshd->bhts", qh.float(), kh.float())
    scores = scores.masked_fill(mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs_d = dropout(probs, attn_dropout, gen, deterministic,
                      shard=head_shard)
    out = torch.einsum("bhts,bshd->bthd", probs_d.to(query.dtype), vh)
    out = linear(params["out_proj"], out.reshape(B, T, E))
    attn = probs.mean(dim=1) if need_weights else None
    return out, attn


def cross_attention(params: dict, query: torch.Tensor, key: torch.Tensor,
                    key_padding_mask: torch.Tensor | None, *,
                    num_heads: int, attn_dropout: float = 0.0,
                    gen: torch.Generator | None = None,
                    deterministic: bool = True, need_weights: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Full cross-attention: project the context's K/V, then attend."""
    k, v, mask = precompute_kv(params, key, key_padding_mask)
    return cross_attention_with_kv(
        params, query, k, v, mask, num_heads=num_heads,
        attn_dropout=attn_dropout, gen=gen, deterministic=deterministic,
        need_weights=need_weights)
