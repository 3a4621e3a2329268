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
divisibility and short-leaf fallbacks. shard_params keeps, on each rank,
the slice of every leaf that its spec names: the index("model")-th of
mesh.shape["model"] equal slices along the rule's dim; gather_params is
its inverse (one all_gather a sharded leaf over "model").

Tensor parallelism. Mesh.model_axis() is the grid's "model" axis as a
comm.ModelAxis, which the losses take as `tp` and pass down to the
forwards (models/decoder.py, models/llm_decoder.py, ops/adaptive.py,
ops/moe.py), as they take the "data" group. Attention heads, FFN
columns and rows, the experts and the vocabulary rows then split over
"model" as tell_tpu's rules (rules.py) split them, and every rank of a
"model" group computes the same loss. A leaf whose spec is replicated (a
dim that does not divide) is read whole, as the rules leave it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..bridge import _rebuild, tree_leaves_with_path
from .comm import ONE_RANK, ModelAxis, all_gather
from .comm import rank as _rank
from .comm import world_size
from .rules import leaf_spec


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

    def model_axis(self) -> ModelAxis:
        """The "model" axis as the tensor-parallel forwards take it (their
        `tp`): ONE_RANK where it has one rank."""
        n = self.shape.get("model", 1)
        if n == 1:
            return ONE_RANK
        return ModelAxis(self.group("model"), n, self.index("model"))

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


def param_sharding_rules(params, mesh: Mesh) -> dict:
    """{path: spec} for every leaf of `params` by the rule table."""
    return {path: leaf_spec(path, tuple(leaf.shape), mesh.shape)
            for path, leaf in tree_leaves_with_path(params)
            if isinstance(leaf, torch.Tensor)}


def _model_dim(spec: tuple) -> int | None:
    """The dim a spec shards over "model", or None."""
    return spec.index("model") if "model" in spec else None


def shard_params(params, mesh: Mesh, specs: dict | None = None):
    """The params as this rank holds them: each leaf whose spec names
    "model" cut to this rank's slice along that dim (a copy), every other
    leaf whole. specs: param_sharding_rules of the whole tree (default:
    computed from `params`, which must then be whole)."""
    n = mesh.shape.get("model", 1)
    if n == 1:
        return params
    if specs is None:
        specs = param_sharding_rules(params, mesh)
    i = mesh.index("model")

    def cut(path, leaf):
        dim = _model_dim(specs.get(path, ()))
        if dim is None:
            return leaf
        k = leaf.shape[dim] // n
        return leaf.narrow(dim, i * k, k).clone()
    return _map_with_path(cut, params)


def gather_params(params, mesh: Mesh, specs: dict):
    """The whole tree from every rank's shards (shard_params' inverse):
    one all_gather over "model" for each sharded leaf, on every rank."""
    if mesh.shape.get("model", 1) == 1:
        return params
    group = mesh.group("model")

    def whole(path, leaf):
        dim = _model_dim(specs.get(path, ()))
        if dim is None:
            return leaf
        parts = all_gather(leaf, group)
        return torch.cat(list(parts.unbind(0)), dim=dim)
    return _map_with_path(whole, params)


def _map_with_path(fn, tree, prefix: str = ""):
    """fn(path, leaf) over the tensor leaves of a tree of dicts and lists,
    paths as tree_leaves_with_path spells them; other leaves pass."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, (_map_with_path(fn, v, f"{prefix}{i}/")
                               for i, v in enumerate(tree)))
    if isinstance(tree, torch.Tensor):
        return fn(prefix[:-1], tree)
    return tree


def sharded_mask(params, specs: dict) -> list[bool]:
    """Whether each tensor leaf of `params` (tree_leaves order) is a
    "model" shard."""
    return [_model_dim(specs.get(path, ())) is not None
            for path, leaf in tree_leaves_with_path(params)
            if isinstance(leaf, torch.Tensor)]


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
