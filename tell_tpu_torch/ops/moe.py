"""Mixture-of-Experts SwiGLU FFN (counterpart of tell_tpu/ops/moe.py:
init_moe_ffn, _route, moe_ffn and moe_ffn_dense_reference).

The routing and the capacity rule are tell_tpu's: the router's softmax,
top-k by repeated argmax (ties keep the first expert, as jnp.argmax and
torch.argmax both do), the gate renormalised over the k choices for
k > 1 and the raw probability for top-1, and a static capacity per expert
filled in GShard's priority order (choice 0 of every token before any
choice 1; pads take no slot). tell_tpu expresses the dispatch as dense
[N, E, cap] one-hot einsums, which partition over an expert mesh axis;
here each expert gathers the rows routed to it, runs its SwiGLU on them
and index_add_s the gated result back. The experts' products stay
torch.matmul: tell_tpu has no Pallas kernel here.

Across ranks the routing is the global batch's, as tell_tpu's moe_ffn
under GSPMD sees one batch. With `group` (the data-parallel ranks, each
holding its rows of the batch, in rank order) the capacity comes from
the global token count, a (token, choice) pair's slot follows every
earlier choice's pairs of all ranks and the same choice's pairs of the
lower ranks, and the aux's f and P are the global batch's: one
gather_counts of the per-choice, per-expert counts a call (and the
P numerators summed over the group). Under tensor parallelism (the
`tp` axis, where the rules shard the stacked experts) w1/w2/w3 hold
this rank's E / n_model experts; the tokens are the same on every "model" rank, so
each runs its experts and the outputs are summed over "model" (expert
parallelism riding the "model" axis, as tell_tpu's rules place it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.comm import (ONE_RANK, ModelAxis, SumOverRanks, gather_counts,
                             rank)


def init_moe_ffn(generator: torch.Generator, dim: int, ffn_dim: int,
                 num_experts: int) -> dict:
    """Stacked-expert SwiGLU params: w1/w3 [E, D, F], w2 [E, F, D] and a
    router [D, E], xavier-uniform per expert as tell_tpu's init_moe_ffn
    (the two frameworks draw different numbers from one seed)."""
    g = generator

    def xavier(din, dout, *lead):
        bound = (6.0 / (din + dout)) ** 0.5
        return (torch.rand(*lead, din, dout, generator=g, device=g.device)
                * (2 * bound) - bound)

    return {"router": {"w": xavier(dim, num_experts)},
            "w1": xavier(dim, ffn_dim, num_experts),
            "w3": xavier(dim, ffn_dim, num_experts),
            "w2": xavier(ffn_dim, dim, num_experts)}


def _route(params: dict, x: torch.Tensor, top_k: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs [N, E] fp32, chosen [k, N] expert ids, gate [N, k] fp32)."""
    E = params["router"]["w"].shape[1]
    k = min(top_k, E)
    logits = x.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    remaining = probs
    chosen, gatevals = [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        chosen.append(idx)
        gatevals.append(probs.gather(1, idx[:, None])[:, 0])
        remaining = remaining * (1.0 - F.one_hot(idx, E).to(probs.dtype))
    gate = torch.stack(gatevals, dim=-1)
    if k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, torch.stack(chosen), gate


def _swiglu(params: dict, e: int, x: torch.Tensor) -> torch.Tensor:
    h = F.silu((x @ params["w1"][e]).float()).to(x.dtype)
    return (h * (x @ params["w3"][e])) @ params["w2"][e]


def moe_ffn(params: dict, x: torch.Tensor, top_k: int = 2,
            capacity_factor: float = 1.25,
            token_mask: torch.Tensor | None = None, group=None,
            tp: ModelAxis = ONE_RANK) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE SwiGLU. x: [N, D] -> ([N, D] in x's dtype, aux loss fp32).

    Each expert takes at most cap = min(N, int(ceil(N k / E) *
    capacity_factor)) (token, choice) pairs; a pair past its expert's
    capacity is dropped (that token gets nothing from that choice).
    token_mask [N] (True = real token): a pad takes no slot, gets zero
    output and is left out of the aux statistics. aux is the Switch
    load-balancing term E * sum_e f_e P_e over the top-1 choices.
    group: the data-parallel ranks whose rows, in rank order, make the
    batch (N is then the global count, as above); every rank returns
    the global aux. tp: the "model" axis the experts shard over.

    One host synchronisation a call (two with a group): the per-expert
    row counts."""
    routing = moe_routing(params, x, top_k, capacity_factor, token_mask,
                          group)
    N, D = x.shape
    E, k = routing["E"], routing["k"]
    keep, flat_e, gate = routing["keep"], routing["flat_e"], routing["gate"]
    # this rank's experts: all of them at one rank
    sharded = tp.split("/ffn/w1", (E,) + tuple(params["w1"].shape[1:]))
    local_e = params["w1"].shape[0]
    first = tp.index * local_e if sharded else 0
    if sharded:
        x, gate = tp.enter(x), tp.enter(gate)
    # the kept pairs of this rank's experts grouped by expert (a stable
    # sort keeps priority order)
    mine = keep & (flat_e >= first) & (flat_e < first + local_e)
    expert_of = torch.where(mine, flat_e - first, local_e)
    order = torch.argsort(expert_of, stable=True)
    counts = torch.bincount(expert_of, minlength=local_e + 1)[
        :local_e].tolist()
    tokens = order % N
    gates = gate.T.reshape(k * N)[order]
    out = torch.zeros(N, D, dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            rows = tokens[start:start + n]
            y = _swiglu(params, e, x[rows]).float()
            out.index_add_(0, rows, gates[start:start + n, None] * y)
        start += n
    if sharded:
        out = tp.reduce(out)
    live, probs = routing["live"], routing["probs"]
    psum = (probs * live[:, None].float()).sum(dim=0)
    if group is not None:
        psum = SumOverRanks.apply(psum, group)
    n_live = routing["n_live"].float().clamp_min(1.0)
    f = routing["top1"].float() / n_live
    P = psum / n_live
    return out.to(x.dtype), E * (f * P).sum()


def moe_routing(params: dict, x: torch.Tensor, top_k: int,
                capacity_factor: float,
                token_mask: torch.Tensor | None = None, group=None
                ) -> dict:
    """moe_ffn's routing: {"probs" [N, E], "gate" [N, k], "flat_e" and
    "pos" [k N] (each (choice, token) pair's expert and slot, choice-major
    as tell_tpu's priority order), "keep" [k N], "cap", "live" [N], and
    the aux's counts over the (global) batch: "top1" [E] pairs of choice
    0 and "n_live"}. With a group, the positions are those of the global
    batch (the ranks' rows in rank order)."""
    N = x.shape[0]
    E = params["router"]["w"].shape[1]
    k = min(top_k, E)
    probs, chosen, gate = _route(params, x, top_k)
    live = (torch.ones(N, dtype=torch.bool, device=x.device)
            if token_mask is None else token_mask.to(torch.bool))
    flat_e = chosen.reshape(k * N)
    sel = (F.one_hot(chosen, E) * live[None, :, None]).long()  # [k, N, E]
    within = (torch.cumsum(sel, dim=1) - sel).gather(
        2, chosen[:, :, None])[:, :, 0]                        # [k, N]
    per_choice = sel.sum(dim=1)                                 # [k, E]
    n_live = live.sum()
    if group is None:
        n_total = N
        earlier = torch.cumsum(per_choice, dim=0) - per_choice
        top1 = per_choice[0]
    else:
        got = gather_counts(torch.cat([per_choice.reshape(-1),
                                       n_live.reshape(1),
                                       torch.tensor([N], device=x.device)]),
                            group)                              # [P, kE+2]
        counts = got[:, :k * E].reshape(-1, k, E)
        n_total = int(got[:, -1].sum())
        n_live = got[:, -2].sum()
        every = counts.sum(dim=0)                               # [k, E]
        earlier = (torch.cumsum(every, dim=0) - every
                   + counts[:rank(group)].sum(dim=0))
        top1 = every[0]
    cap = min(max(1, int(-(-n_total * k // E) * capacity_factor)), n_total)
    pos = (earlier.gather(1, chosen) + within).reshape(k * N)
    flat_live = live.repeat(k)
    return {"probs": probs, "gate": gate, "flat_e": flat_e, "pos": pos,
            "keep": flat_live & (pos < cap), "cap": cap, "live": live,
            "top1": top1, "n_live": n_live, "E": E, "k": k}


def moe_ffn_dense_reference(params: dict, x: torch.Tensor, top_k: int = 2
                            ) -> torch.Tensor:
    """Infinite capacity: every token runs its top-k experts densely (the
    tests' check of moe_ffn where no pair is dropped); the routing is
    _route's, as in moe_ffn."""
    N, D = x.shape
    E = params["w1"].shape[0]
    k = min(top_k, E)
    _, chosen, gate = _route(params, x, top_k)
    out = torch.zeros(N, D, dtype=torch.float32, device=x.device)
    for j in range(k):
        for e in range(E):
            m = (chosen[j] == e).float()[:, None]
            out = out + m * gate[:, j:j + 1] * _swiglu(params, e, x).float()
    return out.to(x.dtype)
