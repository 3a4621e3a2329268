"""Ulysses sequence parallelism for the article encoder (counterpart of
tell_tpu/parallel/sequence.py).

The sequence axis of a RoBERTa encode is sharded over the ranks of a
group: each rank embeds and projects its S/P tokens, one all_to_all
re-shards Q, K and V from sequence to heads, so each rank holds the whole
sequence for H/P heads, [B, S, H/P, hd], which is the padded
self-attention kernel B computes (ops/kernels/encoder_attention.py) with
the whole key-pad mask; a second all_to_all restores the sequence shards
for the FFN. Activations scale as S/P and attention as H/P per rank.

Positions come from RoBERTa's 514-row table, so S stays within
max_positions - 2 (a longer article goes through roberta_encode_windowed);
the heads must divide by P. Both refusals are tell_tpu's
(sequence.py:72-83). The encode is the frozen tower's: forward only, as
kernel B has no backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.backbones.roberta import RobertaConfig
from ..ops.common import layer_norm
from ..ops.kernels.encoder_attention import encoder_attention
from ..ops.linear import linear
from ..ops.positional import make_positions
from .comm import all_to_all, rank, world_size


def check_positions(S: int, cfg: RobertaConfig, what: str) -> None:
    if S > cfg.max_positions - 2:
        raise ValueError(
            f"S={S} exceeds the position table ({cfg.max_positions - 2} "
            f"usable rows) — position ids would silently clamp and degrade "
            f"every token past the table; use roberta_encode_windowed for "
            f"long articles ({what} buys per-device memory, not positions)")


def _seq_to_heads(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """[B, S/P, H, hd] sequence shard -> [B, S, H/P, hd] head shard."""
    B, S_loc, H, hd = x.shape
    x = x.reshape(B, S_loc, n, H // n, hd).permute(2, 0, 1, 3, 4)
    x = all_to_all(x.contiguous(), group)        # [P(src), B, S/P, H/P, hd]
    return x.permute(1, 0, 2, 3, 4).reshape(B, n * S_loc, H // n, hd) \
        .contiguous()


def _heads_to_seq(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """[B, S, H/P, hd] head shard -> [B, S/P, H, hd] sequence shard."""
    B, S, Hp, hd = x.shape
    x = x.reshape(B, n, S // n, Hp, hd).permute(1, 0, 2, 3, 4)
    x = all_to_all(x.contiguous(), group)        # [P(heads), B, S/P, ...]
    return x.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * Hp, hd)


def roberta_encode_seq_parallel(params: dict, cfg: RobertaConfig,
                                ids: torch.Tensor, group=None,
                                return_all_hiddens: bool = True
                                ) -> torch.Tensor:
    """roberta_encode with S sharded over `group`. ids: the whole [B, S]
    on every rank, S divisible by the group size P. Returns this rank's
    sequence shard of roberta_encode's output: [B, S/P, L+1, D] (or
    [B, S/P, D]), rows rank*S/P to (rank+1)*S/P."""
    B, S = ids.shape
    n, r = world_size(group), rank(group)
    assert S % n == 0, f"S={S} not divisible by {n}"
    assert cfg.num_heads % n == 0, \
        (f"Ulysses SP needs heads ({cfg.num_heads}) divisible by the "
         f"sequence-axis size ({n})")
    check_positions(S, cfg, "SP")
    S_loc, H = S // n, cfg.num_heads
    hd = cfg.dim // H
    positions = make_positions(ids, cfg.pad_id)
    key_pad = ids == cfg.pad_id
    rows = slice(r * S_loc, (r + 1) * S_loc)
    ids_loc, pos_loc = ids[:, rows], positions[:, rows]
    x = (params["word_embed"][ids_loc] + params["pos_embed"][pos_loc]
         + params["type_embed"][0])
    x = layer_norm(params["embed_ln"], x, cfg.ln_eps)
    hiddens = [x]
    for lp in params["layers"]:
        q, k, v = (_seq_to_heads(linear(lp[name], x).reshape(
            B, S_loc, H, hd), n, group) for name in ("q", "k", "v"))
        o = _heads_to_seq(encoder_attention(q, k, v, key_pad), n, group)
        o = linear(lp["attn_out"], o.reshape(B, S_loc, cfg.dim))
        x = layer_norm(lp["attn_ln"], x + o, cfg.ln_eps)
        h = F.gelu(linear(lp["fc1"], x).float(),
                   approximate="tanh" if cfg.gelu == "tanh" else "none"
                   ).to(x.dtype)
        h = linear(lp["fc2"], h)
        x = layer_norm(lp["ffn_ln"], x + h, cfg.ln_eps)
        hiddens.append(x)
    if return_all_hiddens:
        return torch.stack(hiddens, dim=2)
    return x
