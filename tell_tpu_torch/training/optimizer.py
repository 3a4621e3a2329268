"""BertAdam (counterpart of tell_tpu/training/optimizer.py).

The reference trains with AllenNLP's `bert_adam`: lr 1e-4, 5% linear warmup
of t_total then linear decay, betas (0.9, 0.98), eps 1e-6, decoupled weight
decay 1e-5. It is not AdamW: there is NO bias correction, each tensor's
gradient is clipped to norm 0.1 on its own (not the global norm), and the
weight decay is added to the update before the lr multiplier. Under tensor
parallelism a leaf's moments are its shard's, and its clip is the whole
leaf's (update's sharded and group).

Functional like the JAX package's optax transformation: init(params) and
update(grads, state, params) -> (updates, state'), on nested dicts/lists of
tensors; apply_updates adds them. The state's step is a device tensor, so
the schedule never synchronises with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bridge import tree_leaves, tree_map


def warmup_linear(step: torch.Tensor, t_total: int, warmup: float
                  ) -> torch.Tensor:
    """lr multiplier: 0 -> 1 over warmup * t_total steps, then linear to 0."""
    t = step.float()
    w = warmup * t_total
    warm = t / max(w, 1.0)
    decay = (t_total - t) / max(t_total - w, 1.0)
    return torch.where(t < w, warm, decay).clamp(0.0, 1.0)


class BertAdamState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: object                # first moments, a tree like the params
    v: object                # second moments


class BertAdam:
    def __init__(self, lr: float = 1e-4, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-6, weight_decay: float = 1e-5,
                 max_grad_norm: float = 0.1, t_total: int = 437600,
                 warmup: float = 0.05):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.t_total, self.warmup = t_total, warmup

    def init(self, params) -> BertAdamState:
        leaf = tree_leaves(params)[0]
        return BertAdamState(
            torch.zeros((), dtype=torch.int32, device=leaf.device),
            tree_map(torch.zeros_like, params),
            tree_map(torch.zeros_like, params))

    def _clip(self, g: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
        scale = (self.max_grad_norm / norm.clamp_min(1e-12)).clamp(max=1.0)
        return g * scale.to(g.dtype)

    def _clipped(self, grads, sharded: list[bool] | None, group):
        """Each leaf clipped by its own norm. A leaf that is a tensor-
        parallel shard (sharded, in tree_leaves order) is clipped by the
        whole leaf's norm: its square sums meet over `group` (the "model"
        ranks), one all_reduce for every such leaf."""
        if self.max_grad_norm <= 0:
            return grads
        flat = tree_leaves(grads)
        norms = [torch.linalg.vector_norm(g.float()) for g in flat]
        if sharded is not None and any(sharded):
            from ..parallel.comm import all_reduce
            at = [i for i, s in enumerate(sharded) if s]
            sq = all_reduce(torch.stack([norms[i] ** 2 for i in at]), group)
            for i, v in zip(at, sq.sqrt().unbind(0)):
                norms[i] = v
        it = iter(norms)
        return tree_map(lambda g: self._clip(g, next(it)), grads)

    def update(self, grads, state: BertAdamState, params,
               sharded: list[bool] | None = None, group=None):
        """sharded, group: the leaves that are shards over the tensor-
        parallel group (parallel/mesh.py's sharded_mask); their moments
        are shards too, and their clip takes the whole leaf's norm."""
        b1, b2 = self.b1, self.b2
        grads = self._clipped(grads, sharded, group)
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state.m, grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g * g, state.v, grads)
        mult = self.lr * warmup_linear(state.step, self.t_total, self.warmup)

        def upd(mm, vv, p):
            u = mm / (vv.sqrt() + self.eps)
            if self.weight_decay > 0:
                u = u + self.weight_decay * p
            return -mult * u

        updates = tree_map(upd, m, v, params)
        return updates, BertAdamState(state.step + 1, m, v)


bert_adam = BertAdam   # tell_tpu's name, same hyperparameters and defaults


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
