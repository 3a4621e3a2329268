"""Ring-attention context parallelism for the article encoder
(counterpart of tell_tpu/parallel/ring.py).

The second way to shard the article's sequence over the ranks of a
group. Queries stay on their rank; the K/V blocks rotate around the ring
by point-to-point hops (comm.RingHop) under an fp32 online softmax per
query row: the running max, normaliser and output of flash attention,
one block per hop. There is no constraint on the head count, and each
rank holds one K/V block at a time, so memory scales as S/P.

After `step` hops rank d holds the block that started on rank
(d - step) mod P, so the pad-mask block of that rank's columns is the
one it adds (ring.py:64-67). The per-block math is plain torch, as
tell_tpu's is plain jnp; the hops' backward sends the K/V gradients the
other way round the ring, so the encode is differentiable end to end.
Each rank's gradients of the (replicated) params are its part: summed
over the group they are the one-rank encode's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.backbones.roberta import RobertaConfig
from ..ops.common import layer_norm
from ..ops.linear import linear
from ..ops.positional import make_positions
from .comm import RingHop, rank, world_size
from .sequence import check_positions


def _attention_ring(lp: dict, x: torch.Tensor, pad_neg: torch.Tensor,
                    cfg: RobertaConfig, group, n: int, r: int
                    ) -> torch.Tensor:
    """One self-attention block with ring-rotated K/V. x: [B, S/P, D];
    pad_neg: [B, S] additive pad mask (0 / -1e9) of the whole sequence."""
    B, S_loc, D = x.shape
    H = cfg.num_heads
    hd = D // H

    def heads(name):
        return linear(lp[name], x).reshape(B, S_loc, H, hd).transpose(1, 2)

    q, k, v = heads("q"), heads("k"), heads("v")
    scale = hd ** -0.5
    m = torch.full((B, H, S_loc), float("-inf"), device=x.device)
    l = torch.zeros(B, H, S_loc, device=x.device)
    acc = torch.zeros(B, H, S_loc, hd, device=x.device)
    for step in range(n):
        src = (r - step) % n
        neg = pad_neg[:, src * S_loc:(src + 1) * S_loc]
        scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
        scores = scores * scale + neg[:, None, None, :]
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)     # exp(-inf) = 0 retires the init
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhts,bhsd->bhtd", p.to(x.dtype).float(), v.float())
        m = m_new
        if step + 1 < n:
            k, v = RingHop.apply(group, 1, k.contiguous(), v.contiguous())
    o = (acc / l[..., None]).to(x.dtype)
    o = o.transpose(1, 2).reshape(B, S_loc, D)
    return linear(lp["attn_out"], o)


def roberta_encode_ring(params: dict, cfg: RobertaConfig, ids: torch.Tensor,
                        group=None, return_all_hiddens: bool = True
                        ) -> torch.Tensor:
    """roberta_encode with S ring-sharded over `group`. ids: the whole
    [B, S] on every rank, S divisible by the group size P (the heads need
    not divide by P). Returns this rank's sequence shard of
    roberta_encode's output, [B, S/P, L+1, D] (or [B, S/P, D])."""
    B, S = ids.shape
    n, r = world_size(group), rank(group)
    assert S % n == 0, f"S={S} not divisible by {n}"
    check_positions(S, cfg, "CP")
    S_loc = S // n
    positions = make_positions(ids, cfg.pad_id)
    pad_neg = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device
                          ).masked_fill_(ids == cfg.pad_id, -1e9)
    rows = slice(r * S_loc, (r + 1) * S_loc)
    x = (params["word_embed"][ids[:, rows]]
         + params["pos_embed"][positions[:, rows]]
         + params["type_embed"][0])
    x = layer_norm(params["embed_ln"], x, cfg.ln_eps)
    hiddens = [x]
    for lp in params["layers"]:
        o = _attention_ring(lp, x, pad_neg, cfg, group, n, r)
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
