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
"""
from __future__ import annotations

import torch

from ..bridge import tree_leaves, tree_map
from ..models.captioner import captioner_loss, captioner_loss_e2e
from .optimizer import BertAdam, apply_updates


def cast_tree(tree, compute_dtype: str):
    """fp32 leaves to bf16 under compute_dtype "bfloat16"; other leaves
    (ints, bools, configs) and other dtypes pass through."""
    if compute_dtype != "bfloat16":
        return tree
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if isinstance(x, torch.Tensor)
                    and x.dtype == torch.float32 else x, tree)


def compute_dtype_of(cfg) -> str:
    """The training compute dtype of a model config: a CaptionerConfig's,
    a wrapper's captioner's, else fp32 (LLMConfig has none), as tell_tpu's
    train step reads it."""
    return getattr(getattr(cfg, "captioner", cfg), "compute_dtype",
                   "float32")


def make_train_step(cfg, optimizer: BertAdam, loss=None, loss_e2e=None):
    """loss(params, cfg, batch, gen, deterministic) and loss_e2e(params,
    frozen, cfg, batch, gen, deterministic) are the model's objective
    (default: the captioner's), each returning (loss, aux) with aux
    holding sample_size and tail_dropped (each 0 where absent: the
    pointer's aux holds its gen, entity and copy losses instead).

    Returns step(params, opt_state, batch, gen, frozen=None) ->
    (params', opt_state', metrics). params: a tree of fp32 tensors (not
    requiring grad); batch: device tensors; gen: the step's dropout
    generator; frozen: the frozen towers, whose presence makes the step
    encode context_ids itself (the Trainer casts them to the compute dtype
    once, so the cast here finds nothing to do). metrics are device
    tensors (no host sync)."""
    loss_f = loss or captioner_loss
    loss_e2e_f = loss_e2e or captioner_loss_e2e
    compute_dtype = compute_dtype_of(cfg)

    def step(params, opt_state, batch, gen, frozen=None):
        batch_c = cast_tree(batch, compute_dtype)
        frozen_c = cast_tree(frozen, compute_dtype)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            p = cast_tree(leaves, compute_dtype)
            if frozen is not None:
                value, aux = loss_e2e_f(p, frozen_c, cfg, batch_c, gen,
                                        deterministic=False)
            else:
                value, aux = loss_f(p, cfg, batch_c, gen,
                                    deterministic=False)
            value = value.float()
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(value, flat, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(flat, grads)]
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        value = value.detach()
        with torch.no_grad():
            updates, new_opt = optimizer.update(grads, opt_state, params)
            new_params = apply_updates(params, updates)
            # NaN-loss batches are skipped (reference :225-227): old state
            ok = torch.isfinite(value)
            new_params = tree_map(lambda n, o: torch.where(ok, n, o),
                                  new_params, params)
            new_opt = tree_map(lambda n, o: torch.where(ok, n, o),
                               new_opt, opt_state)
            metrics = {"loss": value, "skipped": (~ok).int(),
                       "sample_size": aux.get("sample_size", 0),
                       "tail_dropped": aux.get("tail_dropped", 0)}
        return new_params, new_opt, metrics

    return step
