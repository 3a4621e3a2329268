"""Pipeline parallelism: a layer stack in stages over the ranks of a group
(counterpart of tell_tpu/parallel/pipeline.py).

Stage s is rank s of the pipe group and computes layers s*L/P to
(s+1)*L/P - 1 (stack_stages' contiguous split). Every rank holds the
stacked tree in this cut; a rank's gradients are zero on the other
stages' slices, which is its shard of tell_tpu's stage-sharded
gradient. The schedule is tell_tpu's GPipe one over M + P - 1 ticks: at tick t stage s computes
microbatch t - s, and the bubble ticks (t - s outside [0, M)) are
discarded, here by not computing them. Activations move stage to stage
by point-to-point hops (comm.PipeSend / PipeRecv) whose backward sends
the gradient upstream, as lax.ppermute's transpose does, so a loss's
backward on every rank gives each stage the gradients of its own layers.

The hops of a rank are chained by a token (each takes the last one's
and gives the next), so the backward runs them in exactly the reverse of
the forward order on every rank and neighbours' sends and receives pair
up. The last stage's outputs reach every stage (comm.FromRank); the loss
is computed alike on every rank, and the gradient kept is the last
stage's. The input and the per-example extras are the same on every
stage, so their gradient is summed over the stages (comm.Replicated), as
shard_map's transpose of a replicated input is.

`data_group` composes dp x pp: each microbatch's examples are split over
that group (a rank holds its slice), the stage params are the same on
its ranks, and the caller sums their gradients over it, as the dp train
step does.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..bridge import tree_leaves, tree_map
from .comm import (FromRank, PipeRecv, PipeSend, Replicated, SumOverRanks,
                   Tie, rank, world_size)


def stack_stages(layer_params: list, n_stages: int):
    """[L layer trees] -> one tree with leading [n_stages, L/P] dims;
    stage s owns layers s*L/P .. (s+1)*L/P - 1."""
    L = len(layer_params)
    assert L % n_stages == 0, f"{L} layers not divisible by {n_stages} stages"
    per = L // n_stages
    stages = [tree_map(lambda *xs: torch.stack(xs),
                       *layer_params[s * per:(s + 1) * per])
              for s in range(n_stages)]
    return tree_map(lambda *xs: torch.stack(xs), *stages)


def _rows(a: torch.Tensor, n_micro: int, d: int, n_d: int) -> torch.Tensor:
    """[B, ...] -> [n_micro, mb / n_d, ...]: each microbatch's slice of
    data rank d."""
    mb = a.shape[0] // n_micro
    a = a.reshape((n_micro, mb) + tuple(a.shape[1:]))
    k = mb // n_d
    return a[:, d * k:(d + 1) * k]


def pipeline_apply(stacked, layer_fn: Callable, x: torch.Tensor,
                   group, n_micro: int, extras=None, batched=None,
                   data_group=None, layer_aux: bool = False):
    """Run x [B, ...] through every stage's layers with GPipe
    microbatching. stacked: stack_stages' tree, whose leading dim (the
    stage count) must equal the group size; rank s computes stacked[s],
    so its gradients land on that slice. layer_fn(lparams, x, extras) -> x
    applies one layer. `extras` pass through to every layer; `batched`
    (per-example tensors with leading dim B) is split into microbatches,
    and the slice of the microbatch a stage computes is appended as the
    last element of layer_fn's extras.

    layer_aux=True: layer_fn returns (x, aux scalar) and this returns
    (out, aux_sum), aux_sum totalling every real (layer, microbatch)
    contribution over the stages, averaged over data_group.

    Returns the output on every rank: [B, ...], or with data_group this
    rank's rows, [n_micro * mb / D, ...] (each microbatch's slice)."""
    P = world_size(group)
    s = rank(group)
    n_stages = tree_leaves(stacked)[0].shape[0]
    assert n_stages == P, \
        (f"stacked params have {n_stages} stages but the pipe group has "
         f"{P} ranks (each stage must map to exactly one rank; a mismatch "
         f"would silently drop layers)")
    B = x.shape[0]
    assert B % n_micro == 0, f"batch {B} not divisible by {n_micro}"
    mb = B // n_micro
    n_d, d = 1, 0
    if data_group is not None:
        n_d, d = world_size(data_group), rank(data_group)
        assert mb % n_d == 0, \
            f"microbatch {mb} not divisible by data axis {n_d}"
    extras = tuple(extras) if extras is not None else ()
    x = Replicated.apply(x, group) if x.requires_grad else x
    micro = _rows(x, n_micro, d, n_d)
    micro_b = None
    if batched is not None:
        batched = tree_map(lambda a: Replicated.apply(a, group)
                           if a.requires_grad else a, batched)
        micro_b = tree_map(lambda a: _rows(a, n_micro, d, n_d), batched)
    stage = tree_map(lambda a: a[s], stacked)
    n_layers = tree_leaves(stage)[0].shape[0]

    def run_stage(h, m):
        ex = extras
        if micro_b is not None:
            ex = extras + (tree_map(lambda a: a[m], micro_b),)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for j in range(n_layers):
            out = layer_fn(tree_map(lambda a: a[j], stage), h, ex)
            if layer_aux:
                h, a = out
                aux = aux + a.float()
            else:
                h = out
        return h, aux

    # the token chain, tied to everything that may want a gradient: the
    # stage params, and the replicated inputs, whose summed gradient then
    # comes after every hop's in each rank's backward
    ties = [t for t in tree_leaves(stacked) + [x] + tree_leaves(
        batched if batched is not None else {})
        if isinstance(t, torch.Tensor) and t.requires_grad]
    token = torch.zeros((), device=x.device,
                        requires_grad=torch.is_grad_enabled())
    if ties:
        token = Tie.apply(token, *ties)
    outs, aux_acc = [], torch.zeros((), dtype=torch.float32,
                                    device=x.device)
    for m in range(n_micro):
        if s == 0:
            h = micro[m]
        else:
            h, token = PipeRecv.apply(token, micro[m].detach(), s - 1, group)
        h, aux = run_stage(h, m)
        aux_acc = aux_acc + aux
        if s < P - 1:
            token = PipeSend.apply(h, token, s + 1, group)
        else:
            outs.append(h)
    local = torch.stack(outs) if outs else torch.zeros_like(micro)
    out = FromRank.apply(local, token, P - 1, group)
    out = out.reshape((-1,) + tuple(x.shape[1:]))
    if not layer_aux:
        return out
    aux_acc = SumOverRanks.apply(aux_acc, group)
    if data_group is not None:
        aux_acc = SumOverRanks.apply(aux_acc, data_group) / n_d
    return out, aux_acc
