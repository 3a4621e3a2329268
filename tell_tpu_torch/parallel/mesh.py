"""The rank grid and sharding rules (counterpart of
tell_tpu/parallel/mesh.py).

tell_tpu's ("data", "model") jax.sharding.Mesh of devices becomes a grid
of ranks: one rank is one process that owns one device, and each axis of
the grid has its process groups (the ranks that differ only along it).
Its "data" size is the world size over its "model" size. Batches shard
over "data": each rank holds its rows, and gradients are summed over the
"data" group by the train step (training/train_step.py).

param_sharding_rules is tell_tpu's rule table carried as data: per leaf,
the dim and the axis that tell_tpu shards it over, with the same
divisibility and short-leaf fallbacks. Tensor parallelism, the rules'
"model" axis, is not ported (ROADMAP queue 1 item 10's rest): the trainer
refuses n_model > 1, and shard_params on a mesh of model size 1
replicates, which is what the rules give there.
"""
from __future__ import annotations

import re

import torch
import torch.distributed as dist

from ..bridge import tree_leaves_with_path
from .comm import rank as _rank
from .comm import world_size


class Mesh:
    """A grid of ranks, row-major over `names` (rank = index in the
    flattened grid), with a process group per axis of more than one rank
    for this rank. `shape` maps each name to its size, as jax's
    Mesh.shape does."""

    def __init__(self, sizes: tuple[int, ...], names: tuple[str, ...]):
        self.sizes, self.names = tuple(sizes), tuple(names)
        self.shape = dict(zip(names, sizes))
        self.size = 1
        for n in sizes:
            self.size *= n
        self.rank = _rank()
        self._groups = {}
        self._coords = []
        r = self.rank
        for n in reversed(self.sizes):
            self._coords.insert(0, r % n)
            r //= n
        if world_size() > 1:
            for ax, name in enumerate(names):
                if self.sizes[ax] > 1:
                    self._groups[name] = self._axis_group(ax)

    def _axis_group(self, ax: int):
        """This rank's group along axis `ax`. Every rank creates every
        group of the axis in the same order, as new_group requires."""
        if self.sizes[ax] == self.size:
            return dist.group.WORLD
        strides = [1] * len(self.sizes)
        for i in range(len(self.sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * self.sizes[i + 1]
        mine = None
        for base in range(self.size):
            coords = [(base // strides[i]) % self.sizes[i]
                      for i in range(len(self.sizes))]
            if coords[ax] != 0:
                continue
            ranks = [base + j * strides[ax] for j in range(self.sizes[ax])]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def group(self, name: str):
        """The process group of axis `name` holding this rank (None, the
        default group, in a single process). An axis of size 1 on several
        ranks has none: it would hold this rank alone."""
        if self.size > 1 and name not in self._groups:
            raise ValueError(f"axis {name!r} of {self} has size 1 and no "
                             "process group")
        return self._groups.get(name)

    def index(self, name: str) -> int:
        """This rank's coordinate along axis `name`."""
        return self._coords[self.names.index(name)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def check_mesh_size(n_data: int, n_model: int, available: int) -> None:
    """tell_tpu's make_mesh check (mesh.py:22-31), on ranks or devices."""
    n = n_data * n_model
    if n > available:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n} devices, "
                         f"have {available}")


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """A ("data", "model") grid over the ranks of the default group (a
    single process is the 1x1 grid). n_data None takes every rank over
    n_model. Every rank must be on the grid."""
    world = world_size()
    if n_data is None:
        n_data = world // n_model
    check_mesh_size(n_data, n_model, world)
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} leaves ranks of the "
                         f"{world} off the grid; every rank must be on it")
    return Mesh((n_data, n_model), ("data", "model"))


# (path regex, spec) — first match wins; a spec names each dim's axis or
# None. Paths look like "decoder/layers/0/attn/image/q_proj/w".
# tell_tpu/parallel/mesh.py:35-62, rule for rule.
_RULES: list[tuple[str, tuple]] = [
    (r".*/attn/[^/]+/(q_proj|k_proj|v_proj)/w$", (None, "model")),
    (r".*/attn/[^/]+/(q_proj|k_proj|v_proj)/b$", ("model",)),
    (r".*/attn/[^/]+/out_proj/w$", ("model", None)),
    (r".*/fc1/(v|w)$", (None, "model")),
    (r".*/fc1/(g|b)$", ("model",)),
    (r".*/fc2/(v|w)$", ("model", None)),
    (r".*/embed/bands/\d+/embed$", ("model", None)),
    (r".*/embed/bands/\d+/proj$", (None, None)),
    (r".*/self_attn/(q|k|v)/w$", (None, "model")),
    (r".*/self_attn/o/w$", ("model", None)),
    (r".*/ffn/(w1|w3)/w$", (None, "model")),
    (r".*/ffn/w2/w$", ("model", None)),
    (r".*/ffn/(w1|w2|w3)$", ("model", None, None)),
    (r".*/ffn/router/w$", ()),
    (r".*tok_embed$", ("model", None)),
    (r".*", ()),
]


def leaf_spec(path: str, shape: tuple[int, ...], mesh_shape: dict
              ) -> tuple:
    """The spec tell_tpu gives the leaf at `path`: the first matching
    rule's, or () (replicated) where the rule names more dims than the
    leaf has or a sharded dim does not divide by its axis."""
    for pattern, spec in _RULES:
        if re.fullmatch(pattern, path):
            if len(spec) > len(shape):
                return ()
            for dim, axis in enumerate(spec):
                if axis is not None and shape[dim] % mesh_shape[axis]:
                    return ()
            return spec
    return ()


def param_sharding_rules(params, mesh: Mesh) -> dict:
    """{path: spec} for every leaf of `params` by the rule table."""
    return {path: leaf_spec(path, tuple(leaf.shape), mesh.shape)
            for path, leaf in tree_leaves_with_path(params)
            if isinstance(leaf, torch.Tensor)}


def shard_params(params, mesh: Mesh):
    """The params as this rank holds them. Every rank holds every leaf
    whole: a mesh of model size 1 shards nothing (the rules give every
    leaf the replicated spec or a "model" axis of size 1); a larger model
    axis is refused, as tensor parallelism is not ported."""
    if mesh.shape.get("model", 1) != 1:
        from ..config import NotPortedError
        raise NotPortedError(
            f"tensor parallelism (a mesh with model size "
            f"{mesh.shape['model']}) is not ported yet (ROADMAP queue 1 "
            "item 10's rest)")
    return params


def check_rows_divisible(name: str, rows: int, n_data: int) -> None:
    """tell_tpu's check that a batch leaf's leading dim shards over
    "data", with its message (mesh.py:106-124)."""
    if rows % n_data:
        raise ValueError(
            f"batch leaf ['{name}'] leading dim {rows} is not divisible by "
            f"the 'data' mesh axis ({n_data}); set bucketing.max_batch (and "
            f"min_batch) to a multiple of trainer.n_data, or shrink n_data")


def batch_sharding(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of every batch leaf (rank i of "data" takes the
    i-th of n_data equal slices of the leading dim; 0-d leaves and
    non-array leaves are kept whole). Every leaf is checked first."""
    n = mesh.shape["data"]
    for name, leaf in batch.items():
        shape = getattr(leaf, "shape", ())
        if len(shape):
            check_rows_divisible(name, shape[0], n)
    i = mesh.index("data")

    def rows(leaf):
        shape = getattr(leaf, "shape", ())
        if not len(shape):
            return leaf
        k = shape[0] // n
        return leaf[i * k:(i + 1) * k]
    return {name: rows(leaf) for name, leaf in batch.items()}
