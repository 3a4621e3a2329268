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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
    E = params["w1"].shape[0]
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
            token_mask: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE SwiGLU. x: [N, D] -> ([N, D] in x's dtype, aux loss fp32).

    Each expert takes at most cap = min(N, int(ceil(N k / E) *
    capacity_factor)) (token, choice) pairs; a pair past its expert's
    capacity is dropped (that token gets nothing from that choice).
    token_mask [N] (True = real token): a pad takes no slot, gets zero
    output and is left out of the aux statistics. aux is the Switch
    load-balancing term E * sum_e f_e P_e over the top-1 choices.

    One host synchronisation a call: the per-expert row counts."""
    N, D = x.shape
    E = params["w1"].shape[0]
    k = min(top_k, E)
    cap = min(max(1, int(-(-N * k // E) * capacity_factor)), N)
    probs, chosen, gate = _route(params, x, top_k)
    live = (torch.ones(N, dtype=torch.bool, device=x.device)
            if token_mask is None else token_mask.to(torch.bool))
    # slot of each (choice, token) pair in its expert's buffer: the count
    # of earlier live pairs, in [k, N] priority order, routed to it
    flat_e = chosen.reshape(k * N)
    flat_live = live.repeat(k)
    sel = F.one_hot(flat_e, E) * flat_live[:, None]              # [kN, E]
    pos = (torch.cumsum(sel, dim=0) - sel).gather(1, flat_e[:, None])[:, 0]
    keep = flat_live & (pos < cap)
    # the kept pairs grouped by expert (a stable sort keeps priority order)
    expert_of = torch.where(keep, flat_e, E)
    order = torch.argsort(expert_of, stable=True)
    counts = torch.bincount(expert_of, minlength=E + 1)[:E].tolist()
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
    n_live = live.float().sum().clamp_min(1.0)
    f = sel[:N].float().sum(dim=0) / n_live
    P = (probs * live[:, None].float()).sum(dim=0) / n_live
    return out.to(x.dtype), E * (f * P).sum()


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
