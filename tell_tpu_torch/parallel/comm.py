"""The collectives of the port's parallel paths, over torch.distributed.

tell_tpu's shard_map bodies call lax.psum, lax.all_to_all and
lax.ppermute, and XLA routes them; here each is a call on a process
group. Every function takes the group (None: the default group) and
returns a new tensor; the input is left as it was.

Host staging. NCCL refuses two ranks on one device, and gloo's
collectives on CUDA tensors are all_reduce and broadcast only. So where
the group's backend is not NCCL and a tensor lies on the card, the
exchange runs on a host copy and the result is copied back onto the
card. What decides it is the backend the caller initialised the group
with, never a failure: a failed collective raises.

Tensor parallelism (the rank grid's "model" axis, ModelAxis below, which
a tensor-parallel forward takes as its `tp` argument) uses three hops,
each a torch.autograd.Function:
Replicated (identity forward, all_reduce backward: a replicated tensor
entering rank-local work), SumOverRanks (all_reduce forward, identity
backward: the partial sums of a row-parallel product) and AllGather (the
shards concatenated along a dim, the backward taking this rank's slice:
a sharded table read whole by work every rank repeats). gather_counts is
the MoE's exchange of its small per-expert counts.

Autograd. torch's point-to-point calls are not differentiable, so each
hop of the ring and of the pipeline is a torch.autograd.Function whose
backward sends the gradient the other way, as lax.ppermute's transpose
is the reverse permutation (tell_tpu/parallel/pipeline.py:16-18,
ring.py:77-80). A rank runs its backward hops in the order of its
forward ones reversed; the pipeline threads a token through its hops so
that this order is fixed (pipeline.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .rules import leaf_spec


def grouped() -> bool:
    """Whether this process is in a process group (of any size: one rank
    still runs every collective through the group's backend)."""
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    """The group's size; 1 where no process group is initialised."""
    if not grouped():
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in the group; 0 where none is initialised."""
    if not grouped():
        return 0
    return dist.get_rank(group)


def global_rank(group, group_rank: int) -> int:
    """The default group's rank of the group's rank `group_rank`."""
    if group is None or group is dist.group.WORLD:
        return group_rank
    return dist.get_global_rank(group, group_rank)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) != "nccl"


def _host(t: torch.Tensor, group) -> torch.Tensor:
    return t.detach().to("cpu", copy=True) if _staged(t, group) \
        else t.detach().clone()


def _back(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return out.to(like.device) if out.device != like.device else out


def all_reduce(t: torch.Tensor, group=None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The elementwise reduction of `t` over the group."""
    if not grouped():
        return t.detach().clone()
    buf = _host(t.contiguous(), group)
    dist.all_reduce(buf, op=op, group=group)
    return _back(buf, t)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Group rank `src`'s `t` on every rank (`t` gives the shape and dtype
    elsewhere)."""
    if not grouped():
        return t.detach().clone()
    buf = _host(t.contiguous(), group)
    dist.broadcast(buf, global_rank(group, src), group=group)
    return _back(buf, t)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """[P, *t.shape]: every rank's `t`, in group rank order."""
    n = world_size(group)
    if not grouped():
        return t.detach().clone()[None]
    buf = _host(t.contiguous(), group)
    out = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(out, buf, group=group)
    return _back(torch.stack(out), t)


def gather_counts(t: torch.Tensor, group=None) -> torch.Tensor:
    """[P, n] int64: every rank's small integer vector `t` [n], in group
    rank order (one all_gather; the MoE's per-expert counts)."""
    return all_gather(t.reshape(-1).long(), group)


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """all_to_all_single: dim 0 in P equal chunks, chunk j to group rank
    j; the result's chunk i is what rank i sent this rank."""
    n = world_size(group)
    if not grouped():
        return t.detach().clone()
    if t.shape[0] % n:
        raise ValueError(f"all_to_all: leading dim {t.shape[0]} is not "
                         f"divisible by the group size {n}")
    buf = _host(t.contiguous(), group)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return _back(out, t)


def sendrecv(t: torch.Tensor, dst: int | None, src: int | None,
             group=None) -> torch.Tensor | None:
    """Send `t` to group rank `dst` and receive a tensor of t's shape and
    dtype from group rank `src`, as one batch of point-to-point calls
    (either may be None). Returns what was received, or None."""
    buf = _host(t.contiguous(), group) if dst is not None else None
    out = None
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, buf, global_rank(group, dst),
                              group))
    if src is not None:
        like = t.to("cpu") if _staged(t, group) else t
        out = torch.empty(t.shape, dtype=t.dtype, device=like.device)
        ops.append(dist.P2POp(dist.irecv, out, global_rank(group, src),
                              group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return None if out is None else _back(out, t)


class RingHop(torch.autograd.Function):
    """Each rank's tensors go to group rank (r + shift) mod P and it
    receives those of (r - shift) mod P; the backward sends the gradients
    back by -shift. One hop moves a tuple (K and V together), so every
    rank runs the same hops in the same order."""

    @staticmethod
    def forward(ctx, group, shift: int, *ts):
        ctx.group, ctx.shift = group, shift
        n, r = world_size(group), rank(group)
        return tuple(sendrecv(t, (r + shift) % n, (r - shift) % n, group)
                     for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        n, r = world_size(ctx.group), rank(ctx.group)
        s = ctx.shift
        return (None, None) + tuple(
            sendrecv(g.contiguous(), (r - s) % n, (r + s) % n, ctx.group)
            for g in grads)


class PipeSend(torch.autograd.Function):
    """Forward: send x to group rank dst and return the next token.
    Backward: receive x's gradient from dst."""

    @staticmethod
    def forward(ctx, x, token, dst: int, group):
        ctx.dst, ctx.group = dst, group
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        sendrecv(x, dst, None, group)
        return token.detach().clone()

    @staticmethod
    def backward(ctx, g_token):
        like = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        gx = sendrecv(like, None, ctx.dst, ctx.group)
        return gx, torch.zeros_like(g_token), None, None


class PipeRecv(torch.autograd.Function):
    """Forward: receive a tensor shaped like `like` from group rank src;
    returns it and the next token. Backward: send its gradient to src."""

    @staticmethod
    def forward(ctx, token, like, src: int, group):
        ctx.src, ctx.group = src, group
        x = sendrecv(like, None, src, group)
        return x, token.detach().clone()

    @staticmethod
    def backward(ctx, gx, g_token):
        sendrecv(gx.contiguous(), ctx.src, None, ctx.group)
        return torch.zeros_like(g_token), None, None, None


class Tie(torch.autograd.Function):
    """token -> token, with `ts` in its graph: their gradient from here is
    zero. A backward that asks for the gradients of any of `ts` (as
    torch.autograd.grad on the params does, running only the nodes on a
    path to them) then runs every hop of the chain, on every rank, and
    reaches `ts` through here only after the chain."""

    @staticmethod
    def forward(ctx, token, *ts):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in ts]
        return token.detach().clone()

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros((), dtype=d, device=v).expand(s)
                            for s, d, v in ctx.shapes)


class Replicated(torch.autograd.Function):
    """Identity forward on a tensor every rank of the group holds alike;
    the backward sums its gradient over the group (the transpose of a
    replicated input, as shard_map's is)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class SumOverRanks(torch.autograd.Function):
    """The sum of x over the group; the backward passes the gradient
    through unchanged, which is right where every rank computes the same
    loss from the sum (lax.psum inside shard_map with a replicated
    output)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class FromRank(torch.autograd.Function):
    """Group rank src's x on every rank (others pass a tensor shaped like
    it); the backward keeps src's own gradient and gives the other ranks'
    inputs none, which is right where every rank computes the same loss
    from the result."""

    @staticmethod
    def forward(ctx, x, token, src: int, group):
        ctx.src, ctx.group = src, group
        ctx.x_shape = x.shape
        ctx.token = (token.dtype, token.device)
        return broadcast(x, src, group)

    @staticmethod
    def backward(ctx, g):
        gx = g if rank(ctx.group) == ctx.src else \
            torch.zeros(ctx.x_shape, dtype=g.dtype, device=g.device)
        dtype, device = ctx.token
        return gx, torch.zeros((), dtype=dtype, device=device), None, None


class AllGather(torch.autograd.Function):
    """The group's shards of x concatenated along `dim` in group rank
    order; the backward keeps this rank's slice of the gradient, which is
    right where every rank of the group repeats the work that reads the
    whole (each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        ctx.n = x.shape[dim]
        parts = all_gather(x, group)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        r = rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class ModelAxis:
    """The "model" axis of the rank grid as a forward sees it (its `tp`
    argument, passed down as the "data" group is): its group, size and
    this rank's index, the hops between replicated and rank-local work,
    and which leaves tell_tpu's rules make shards. The axis of one rank
    (ONE_RANK, every forward's default) shards no leaf and its hops are
    identities, so a forward's one-rank run is its tensor-parallel code
    at size 1. Mesh.model_axis gives a grid's."""

    def __init__(self, group=None, size: int = 1, index: int = 0):
        self.group, self.size, self.index = group, size, index

    def split(self, path: str, shape: tuple[int, ...]) -> bool:
        """Whether the rules (parallel/rules.py) shard the leaf at `path`,
        whole shape `shape`, over this axis: never at size 1."""
        return self.size > 1 and "model" in leaf_spec(
            path, tuple(shape), {"model": self.size})

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor entering rank-local work (a column-parallel
        product, a head's slice): the backward sums the ranks' parts."""
        return x if self.size == 1 else Replicated.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial results, which every rank then
        uses alike (a row-parallel product's output)."""
        return x if self.size == 1 else SumOverRanks.apply(x, self.group)

    def whole(self, t: torch.Tensor, dim: int, sharded: bool
              ) -> torch.Tensor:
        """t whole along dim: gathered where it is a shard, else t."""
        return AllGather.apply(t, dim, self.group) if sharded else t

    def part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along dim of a replicated tensor that
        rank-local work reads (its gradient summed over the ranks)."""
        k = t.shape[dim] // self.size
        return self.enter(t).narrow(dim, self.index * k, k)

    def shard(self, dim: int) -> tuple[int, int, int] | None:
        """(dim, index, size): the dropout of a tensor whose dim is this
        rank's slice draws the whole mask and keeps its slice
        (ops/common.dropout), so the ranks' generators stay in step; None
        (the whole mask) at size 1."""
        return None if self.size == 1 else (dim, self.index, self.size)


ONE_RANK = ModelAxis()
