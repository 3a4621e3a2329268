"""The training step (counterpart of tell_tpu/training/train_step.py).

One step: the model's loss (the captioner's, or an adapter's: models/
registry.py) and its gradients, a BertAdam update, and the reference's
NaN-batch skip, kept on the device: a non-finite loss leaves
params and optimizer state as they were through torch.where, so the host
never waits for the loss. Mixed precision mirrors tell_tpu's _cast (apex O2
analogue): with compute_dtype "bfloat16" the whole param tree and batch are
cast to bf16 INSIDE the differentiated function, so the gradients land on
the fp32 master leaves. (torch.autocast picks per-op dtypes that differ
from JAX's blanket cast, so it is not used.)

Data parallelism (in a process group, of any size): each rank holds its
rows of the global batch, and the step is tell_tpu's on the whole of it.
The loss is normalised over the global batch, so a rank weighs its loss
by its sample size (its non-pad tokens: aux["sample_size"]), and one
all_reduce sums the weighted gradients, the weighted losses, the weights
and the metrics' counts; the sums over the summed weights are the global
loss and gradients. This is exact for an objective that is a mean over
tokens; one that is not (the pointer's per-entity terms, the MoE's
per-batch capacity and aux) has no data-parallel step, and the Trainer
refuses it. The loss gets the group, for the batch-wide budget of the
adaptive softmax's tails. Clipping and BertAdam act after the
reduction, so every rank updates the same params. With more than one
rank, each draws its dropout masks from fold_in(gen, rank): its own
masks, not its rows of the masks one rank would draw for the whole
batch (tell_tpu's sharded key draws those; the bits differ from JAX's
anyway).

An objective that is the global batch's on every rank (the MoE's routed
loss, the pointer's per-entity means: aux["global_loss"]) builds its
cross-rank sums from SumOverRanks, so each rank's gradient is its share
of the global one: the step adds the ranks' gradients unweighted and
keeps the loss and its counts as they are.

Tensor parallelism (mesh with a "model" axis of more than one rank): the
loss takes the grid's "model" axis as tp (Mesh.model_axis), on params of
which the rules' leaves are this rank's shards. Every rank of a "model" group
computes the same loss, and each holds the whole gradient of its shards
and of the replicated leaves. The shards' gradients are summed over
"data"; the replicated leaves' over every rank, divided by the model
size, so they stay bit-equal across "model" whatever order the card
summed them in. The dropout generator is folded by the "data" index, so
the ranks of a "model" group draw alike. BertAdam's moments are shards
where the leaf is, and its clip takes the whole leaf's norm.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..bridge import tree_leaves, tree_map
from ..models.captioner import captioner_loss, captioner_loss_e2e
from ..ops.common import fold_in
from ..ops.quant import map_tree_preserving_quant
from ..parallel.comm import all_reduce, grouped, rank, world_size
from ..parallel.mesh import sharded_mask
from .optimizer import BertAdam, apply_updates


def cast_tree(tree, compute_dtype: str):
    """fp32 leaves to bf16 under compute_dtype "bfloat16"; other leaves
    (ints, bools, configs) and other dtypes pass through, and so does a
    quantised dense dict ({"q8", "scale", ...}: an int8 frozen tower), whose
    fp32 scales stay fp32 (tell_tpu's _cast through
    map_tree_preserving_quant)."""
    if compute_dtype != "bfloat16":
        return tree
    return map_tree_preserving_quant(
        lambda x: x.to(torch.bfloat16) if isinstance(x, torch.Tensor)
        and x.dtype == torch.float32 else x, tree)


def compute_dtype_of(cfg) -> str:
    """The training compute dtype of a model config: a CaptionerConfig's,
    a wrapper's captioner's, else fp32 (LLMConfig has none), as tell_tpu's
    train step reads it."""
    return getattr(getattr(cfg, "captioner", cfg), "compute_dtype",
                   "float32")


def loss_weight(aux: dict) -> torch.Tensor:
    """A rank's share of the global normaliser: its sample size."""
    n = aux.get("sample_size")
    if not isinstance(n, torch.Tensor):
        raise ValueError("a data-parallel step weighs each rank's loss by "
                         "its sample_size, which this objective does not "
                         "return")
    return n.detach().float().reshape(())


def make_train_step(cfg, optimizer: BertAdam, loss=None, loss_e2e=None,
                    group=None, mesh=None, specs: dict | None = None):
    """loss(params, cfg, batch, gen, deterministic[, group][, tp]) and
    loss_e2e(params, frozen, cfg, batch, gen, deterministic[, group][, tp])
    are the model's objective
    (default: the captioner's), each returning (loss, aux) with aux
    holding sample_size and tail_dropped (each 0 where absent: the
    pointer's aux holds its gen, entity and copy losses instead).

    Returns step(params, opt_state, batch, gen, frozen=None) ->
    (params', opt_state', metrics). params: a tree of fp32 tensors (not
    requiring grad); batch: device tensors; gen: the step's dropout
    generator; frozen: the frozen towers, whose presence makes the step
    encode context_ids itself (the Trainer casts them to the compute dtype
    once, so the cast here finds nothing to do). metrics are device
    tensors (no host sync). group: the data-parallel ranks (None: the
    default group where one is initialised and mesh is None); batch then
    is this rank's rows, and with more than one rank the losses get
    group= and the objective must return its sample_size or be global.
    mesh, specs: the rank grid when its "model" axis has more than one
    rank (the losses then get tp=, its "model" axis), and the rules' specs
    of the whole tree (param_sharding_rules), which say which of the
    params are "model" shards."""
    loss_f = loss or captioner_loss
    loss_e2e_f = loss_e2e or captioner_loss_e2e
    compute_dtype = compute_dtype_of(cfg)
    reduce = grouped()
    n_model = 1 if mesh is None else mesh.shape["model"]
    if reduce and group is None and n_model == 1:
        group = dist.group.WORLD
    world = world_size(group) if group is not None else 1
    model_group = mesh.group("model") if n_model > 1 else None
    kw = {"group": group} if world > 1 else {}
    if n_model > 1:
        kw["tp"] = mesh.model_axis()

    def step(params, opt_state, batch, gen, frozen=None):
        batch_c = cast_tree(batch, compute_dtype)
        frozen_c = cast_tree(frozen, compute_dtype)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        sharded = sharded_mask(params, specs) if n_model > 1 else None
        if world > 1:
            gen = fold_in(gen, rank(group))
        with torch.enable_grad():
            p = cast_tree(leaves, compute_dtype)
            if frozen is not None:
                value, aux = loss_e2e_f(p, frozen_c, cfg, batch_c, gen,
                                        deterministic=False, **kw)
            else:
                value, aux = loss_f(p, cfg, batch_c, gen,
                                    deterministic=False, **kw)
            value = value.float()
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(value, flat, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(flat, grads)]
        value = value.detach()
        counts = {k: aux.get(k, 0) for k in ("sample_size", "tail_dropped")}
        if reduce:
            glob = bool(aux.get("global_loss"))
            w = (loss_weight(aux) if world > 1 and not glob
                 else value.new_ones(()))
            grads, value, counts = _reduce(
                grads, value, w, counts, group if world > 1 else None,
                n_model, sharded, glob)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        with torch.no_grad():
            updates, new_opt = optimizer.update(grads, opt_state, params,
                                                sharded, model_group)
            new_params = apply_updates(params, updates)
            # NaN-loss batches are skipped (reference :225-227): old state
            ok = torch.isfinite(value)
            new_params = tree_map(lambda n, o: torch.where(ok, n, o),
                                  new_params, params)
            new_opt = tree_map(lambda n, o: torch.where(ok, n, o),
                               new_opt, opt_state)
            metrics = {"loss": value, "skipped": (~ok).int(), **counts}
        return new_params, new_opt, metrics

    return step


def _reduce(grads: list, value: torch.Tensor, w: torch.Tensor,
            counts: dict, data_group, n_model: int = 1,
            sharded: list[bool] | None = None, global_loss: bool = False
            ) -> tuple[list, torch.Tensor, dict]:
    """The global gradients, loss and counts from every rank's.

    One all_reduce of [the gradients weighted by w, w * loss, w, the
    counts] over the ranks; the sums over the summed w are the global
    gradients and loss, and the counts are summed. The weighing is in
    fp32, after the backward, so a group of one rank gives the gradients
    of no group to rounding. With global_loss (w is 1) the gradients are
    summed unweighted, and the loss and counts are each rank's already.

    With a "model" axis of n_model > 1 ranks, the replicated leaves and
    the scalars take that all_reduce over every rank (each "model" rank
    adds the same terms: the sums are divided by n_model), and the
    sharded leaves a second one over data_group alone (none without
    one)."""
    sharded = sharded if n_model > 1 else None
    rep = [i for i in range(len(grads)) if not (sharded and sharded[i])]
    shd = [i for i in range(len(grads)) if sharded and sharded[i]]
    extra = torch.stack([value * w, w] + [
        torch.as_tensor(c, dtype=torch.float32, device=value.device)
        .reshape(()) for c in counts.values()])
    buf = torch.cat([grads[i].reshape(-1).float() * w for i in rep]
                    + [extra])
    buf = all_reduce(buf, data_group if n_model == 1 else None)
    tail = buf[-len(extra):] / n_model
    total = torch.ones((), device=value.device) if global_loss else tail[1]
    out = list(grads)
    at = 0
    for i in rep:
        g = grads[i]
        out[i] = (buf[at:at + g.numel()] / n_model / total).reshape(
            g.shape).to(g.dtype)
        at += g.numel()
    if shd:
        sbuf = torch.cat([grads[i].reshape(-1).float() * w for i in shd])
        if data_group is not None:
            sbuf = all_reduce(sbuf, data_group)
        at = 0
        for i in shd:
            g = grads[i]
            out[i] = (sbuf[at:at + g.numel()] / total).reshape(
                g.shape).to(g.dtype)
            at += g.numel()
    if global_loss:
        return out, value, counts
    counts = {k: tail[2 + i].round().long()
              for i, k in enumerate(counts)}
    return out, tail[0] / total, counts
