"""Shared functional building blocks (counterpart of tell_tpu/ops/common.py).

Params are the JAX package's nested dicts, holding torch tensors. Dropout
draws from an explicit torch.Generator (the JAX rng key's counterpart) and
has no global training mode: it is off when `deterministic` is set, the
rate is 0 or no generator is given. fold_in derives a call site's own
generator from a parent's seed, as jax.random.fold_in derives a key.
"""
from __future__ import annotations

import numpy as np
import torch


def fold_in(gen: torch.Generator | None, data: int
            ) -> torch.Generator | None:
    """A generator for call site `data`, on gen's device: a pure function
    of gen's seed and data (what it has drawn does not matter), as
    jax.random.fold_in(key, data) is of the key. None stays None."""
    if gen is None:
        return None
    state = np.random.SeedSequence([gen.initial_seed(), data]
                                   ).generate_state(2)
    g = torch.Generator(device=gen.device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None,
            deterministic: bool,
            shard: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Inverted dropout with a keep mask drawn from `gen` (on x's device).
    The bits differ from JAX's for the same seed; the semantics do not.
    shard (dim, index, n): x is the index-th of n equal slices along dim
    of a whole tensor (a tensor-parallel rank's heads or columns); the
    whole mask is drawn and its slice kept, so every rank's generator
    advances alike and the masks are the unsharded run's."""
    if deterministic or rate == 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    if shard is None:
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    else:
        dim, i, n = shard
        shape = list(x.shape)
        k = shape[dim]
        shape[dim] = k * n
        mask = (torch.rand(shape, generator=gen, device=x.device)
                < keep).narrow(dim, i * k, k)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in fp32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


def glu(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Gated linear unit: split in half, gate second half with sigmoid."""
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis with jax.lax.top_k's tie order: among equal
    values the lower index comes first (torch.topk promises no order). A
    stable descending sort gives exactly that; used where ties occur by
    construction (beam bookkeeping), not on the vocabulary-wide searches."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
