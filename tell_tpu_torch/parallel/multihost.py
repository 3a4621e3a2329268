"""Processes and hosts (counterpart of tell_tpu/parallel/multihost.py).

tell_tpu brings up JAX's distributed runtime and lets one program span
every host's chips. In the port one rank is one process that owns one
device, on torch.distributed: the backend follows the device, NCCL for
CUDA and gloo for the CPU.

* init_multihost: init_process_group over tcp://<coordinator> (or any
  init URL, a file:// store in the tests), with a timeout, so a rank that
  never arrives fails the others instead of hanging them; idempotent by
  a module flag, as tell_tpu's (multihost.py:35-54).
* is_primary: rank 0, which alone writes metrics.jsonl, the TensorBoard
  events and the checkpoints.
* global_any: an OR over ranks (an all_reduce of a 0/1 tensor); the
  trainer agrees a preemption stop through it.
* barrier.
* place_global_batch: a rank keeps its local rows on its device; the
  global batch is the concatenation of the ranks' rows in rank order, as
  make_array_from_process_local_data orders it (multihost.py:85-101).
* run_ranks: spawn `world` local ranks, each in a process of its own,
  run a function in each and collect what each returns; a deadline ends
  them all, and a rank that fails ends the others.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .comm import all_reduce, grouped, rank

DEFAULT_TIMEOUT_S = 600.0

_initialized = False


def backend_for(device) -> str:
    """The backend of a rank whose device is `device`."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (idempotent per process). coordinator:
    "host:port" of rank 0's store, or an init URL (tcp://..., file://...);
    backend: backend_for(the rank's device). Collectives that wait longer
    than timeout_s raise."""
    global _initialized
    if _initialized:
        return
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _initialized = True


def shutdown_multihost() -> None:
    """Leave the process group (so a process can join another)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_primary() -> bool:
    return rank() == 0


def _flag_device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_any(flag: bool) -> bool:
    """OR of a host-local bool over every rank (outside a process group:
    the flag). Every rank calls it at the same point of its batch
    schedule."""
    if not grouped():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_flag_device())
    return bool(all_reduce(t, op=dist.ReduceOp.MAX).item())


def barrier(name: str = "") -> None:
    """Every rank waits here for the others (no-op outside a process
    group)."""
    if not grouped():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def place_global_batch(batch: dict, device) -> dict:
    """This rank's local batch (its rows of the global one) on `device`:
    the global batch is the ranks' rows concatenated in rank order, so
    no rank holds or moves another's rows."""
    from ..data.prefetch import to_device
    return to_device(batch, torch.device(device))


def _rank_main(r: int, world: int, url: str, backend: str, fn, args,
               out_dir: str, timeout_s: float) -> None:
    """A spawned rank: join the group, run fn(rank, world, *args), save
    what it returns (or the traceback) where the parent reads it."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(r % torch.cuda.device_count())
        init_multihost(url, world, r, backend, timeout_s)
        result = fn(r, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{r}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{r}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        shutdown_multihost()


class Ranks:
    """`world` spawned processes running fn(rank, world, *args) in one
    process group (a file store in a fresh temporary directory); join()
    returns each rank's result, in rank order. fn must be importable by
    name (a module-level function). A rank that fails ends the others and
    join raises with its traceback; so does the deadline, when given,
    counted from the start."""

    def __init__(self, fn, world: int, args: tuple = (), *,
                 backend: str = "gloo", deadline_s: float | None = 300.0,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.fn, self.world, self.deadline_s = fn, world, deadline_s
        self.work = tempfile.mkdtemp(prefix="tnt_ranks_")
        url = "file://" + os.path.join(self.work, "store")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, url, backend, fn, args,
                                        self.work, timeout_s))
                      for r in range(world)]
        self.end = None if deadline_s is None else time.time() + deadline_s
        for p in self.procs:
            p.start()

    def join(self) -> list:
        try:
            return self._join()
        finally:
            shutil.rmtree(self.work, ignore_errors=True)

    def _join(self) -> list:
        procs, work = self.procs, self.work
        failed = None
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                failed = "rank"
                break
            if self.end is not None and time.time() > self.end:
                failed = "deadline"
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        name = getattr(self.fn, "__name__", str(self.fn))
        if failed == "deadline":
            raise TimeoutError(f"run_ranks: {self.world} ranks of {name} "
                               f"passed their {self.deadline_s} s deadline "
                               "and were killed")
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            # the first rank to fail is the cause; the others lost a peer
            errs = sorted((os.path.getmtime(os.path.join(work, f)),
                           int(f[4:-4]))
                          for f in os.listdir(work) if f.endswith(".err"))
            r = errs[0][1] if errs else bad[0]
            err = os.path.join(work, f"rank{r}.err")
            text = open(err).read() if os.path.exists(err) else \
                f"exit code {procs[r].exitcode}"
            raise RuntimeError(f"run_ranks: rank {r} of {name} failed:\n"
                               f"{text}")
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def run_ranks(fn, world: int, args: tuple = (), **kw) -> list:
    """Ranks(fn, world, args, **kw).join(): spawn, wait, collect."""
    return Ranks(fn, world, args, **kw).join()
