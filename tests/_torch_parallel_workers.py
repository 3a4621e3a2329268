"""Rank functions for the port's parallel tests (tests/test_torch_*.py).

Each runs in a process that run_ranks spawned, as one gloo rank on the
CPU, and imports neither JAX nor tell_tpu (the parent test computes the
JAX reference). Each returns plain tensors and numbers, which run_ranks
hands back in rank order.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from tell_tpu_torch.bridge import to_numpy, to_torch, tree_leaves, tree_map


def _grads(params, loss_fn):
    """loss and the gradients of a params tree (fp32 leaves)."""
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss = loss_fn(leaves)
    flat = tree_leaves(leaves)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(flat, gs)]
    it = iter(gs)
    return loss.detach(), tree_map(lambda _: next(it), params)


# -- multihost --------------------------------------------------------------

def multihost(rank, world):
    """tests/_multihost_worker.py's problem over gloo ranks: the numpy
    loss of a linear model on a 16-row batch whose rows the ranks hold."""
    from tell_tpu_torch.parallel import (barrier, global_any, is_primary,
                                         make_mesh, place_global_batch)
    from tell_tpu_torch.parallel.comm import all_gather, all_reduce
    mesh = make_mesh()
    B, D = 16, 8
    x = np.arange(B * D, dtype=np.float32).reshape(B, D) / (B * D)
    y = np.sin(np.arange(B, dtype=np.float32))[:, None]
    n = B // world
    lo = mesh.index("data") * n
    local = place_global_batch({"x": x[lo:lo + n], "y": y[lo:lo + n]},
                               "cpu")
    w = torch.full((D, 1), 0.1, requires_grad=True)
    part = ((local["x"] @ w - local["y"]) ** 2).sum() / B
    (g,) = torch.autograd.grad(part, [w])
    loss = all_reduce(part.detach())
    g = all_reduce(g)
    out = {"primary": is_primary(), "none": global_any(False),
           "one_sided": global_any(rank == 1),
           "gathered_x": all_gather(local["x"]).reshape(B, D),
           "loss": float(loss), "gnorm": float(g.norm())}
    barrier("done")
    return out


# -- sequence and ring encodes ---------------------------------------------

def encode(rank, world, params, cfg, ids, mode, all_hiddens, weight):
    """This rank's shard of the Ulysses ("ulysses") or ring ("ring")
    encode; with `weight` ([B, S, D]), also the gradients of
    sum(weight * h) (h the final hidden state) summed over the ranks."""
    from tell_tpu_torch.parallel import (roberta_encode_ring,
                                         roberta_encode_seq_parallel)
    from tell_tpu_torch.parallel.comm import all_reduce
    fn = roberta_encode_ring if mode == "ring" else \
        roberta_encode_seq_parallel
    params = to_torch(params, "cpu")
    ids = torch.as_tensor(ids)
    with torch.no_grad():
        out = fn(params, cfg, ids, None, return_all_hiddens=all_hiddens)
    res = {"out": out}
    if weight is not None:
        S_loc = ids.shape[1] // world
        w = torch.as_tensor(weight)[:, rank * S_loc:(rank + 1) * S_loc]

        def loss(p):
            h = fn(p, cfg, ids, None, return_all_hiddens=False)
            return (w * h.float()).sum()
        _, g = _grads(params, loss)
        res["grads"] = to_numpy(tree_map(all_reduce, g))
    return res


def refused(rank, world, params, cfg, ids, mode):
    """The error the Ulysses or ring encode raises, as a string."""
    from tell_tpu_torch.parallel import (roberta_encode_ring,
                                         roberta_encode_seq_parallel)
    fn = roberta_encode_ring if mode == "ring" else \
        roberta_encode_seq_parallel
    try:
        fn(to_torch(params, "cpu"), cfg, torch.as_tensor(ids), None)
    except (AssertionError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


# -- pipelines ---------------------------------------------------------------

def _tanh_layer(lp, x, extras):
    bias = extras[0] if extras and not isinstance(extras[0], tuple) else 0.0
    if extras and isinstance(extras[-1], torch.Tensor) and len(extras) > 1:
        bias = bias + extras[-1]
    return torch.tanh(x @ lp["w"] + lp["b"] + bias)


def _aux_layer(lp, x, extras):
    out = torch.tanh(x @ lp["w"] + lp["b"])
    return out, (out ** 2).sum()


def pipeline(rank, world, layers, x, n_stages, n_micro, case):
    """pipeline_apply over the default group (case "plain", "aux",
    "extras") or over a 2-stage pipe x data grid ("dp"); returns the
    output, the aux and the gradients of sum(out ** 2) (+ aux) with the
    stage params' summed over the data group."""
    from tell_tpu_torch.parallel import pipeline_apply, stack_stages
    from tell_tpu_torch.parallel.comm import all_reduce
    from tell_tpu_torch.parallel.mesh import Mesh
    layers = to_torch(layers, "cpu")
    x = torch.as_tensor(x)
    group = data_group = None
    if case == "dp":
        mesh = Mesh((n_stages, world // n_stages), ("pipe", "data"))
        group, data_group = mesh.group("pipe"), mesh.group("data")
    try:
        stacked = stack_stages(layers, n_stages)
    except AssertionError as e:
        return {"error": str(e)}
    fn = _aux_layer if case == "aux" else _tanh_layer
    extras = batched = None
    if case == "extras":
        extras = (torch.full((x.shape[1],), 0.05),)
        batched = torch.linspace(-0.2, 0.2, x.shape[0])[:, None].expand(
            x.shape).contiguous()

    def run(st, xx):
        return pipeline_apply(st, fn, xx, group, n_micro, extras=extras,
                              batched=batched, data_group=data_group,
                              layer_aux=case == "aux")

    try:
        with torch.no_grad():
            res = run(stacked, x)
    except AssertionError as e:
        return {"error": str(e)}
    out, aux = res if case == "aux" else (res, None)

    def loss(st):
        r = run(st, x)
        o, a = r if case == "aux" else (r, 0.0)
        return (o.float() ** 2).sum() + a
    lval, g = _grads(stacked, loss)
    if data_group is not None:
        g = tree_map(lambda t: all_reduce(t, data_group), g)
        lval = all_reduce(lval, data_group)
    return {"out": out, "aux": None if aux is None else float(aux),
            "loss": float(lval), "grads": to_numpy(g)}


# -- data-parallel training ------------------------------------------------

def _rows_of(batch: dict, rank: int, world: int) -> dict:
    k = len(batch["caption_ids"]) // world
    return {n: v[rank * k:(rank + 1) * k] for n, v in batch.items()}


def train_steps(rank, world, cfg, params, train, val, run_dir,
                sigterm_after=None):
    """A Trainer of `cfg` over this rank's rows of the global `train` and
    `val` batches (one epoch), from `params` (a numpy tree). Returns the
    params after the epoch, each step's loss, the epoch's metrics, and the
    number of checkpoints this rank wrote. sigterm_after: after that many
    steps rank 1 sends itself SIGTERM."""
    import signal
    from tell_tpu_torch.parallel.comm import world_size
    from tell_tpu_torch.training.checkpoint import CheckpointManager
    from tell_tpu_torch.training.trainer import Trainer, TrainerConfig
    torch.set_num_threads(1)
    world = world_size()
    tcfg = TrainerConfig(serialization_dir=run_dir, num_epochs=1,
                         n_data=world, summary_interval=1, warmup=0.0,
                         t_total=100, seed=3)
    local = [_rows_of(b, rank, world) for b in train]
    local_val = [_rows_of(b, rank, world) for b in val]
    trainer = Trainer(cfg, tcfg, lambda epoch: iter([dict(b) for b in local]),
                      lambda: iter([dict(b) for b in local_val]), None,
                      device="cpu")
    trainer.initialize()
    trainer.state["params"] = to_torch(params, "cpu")
    trainer.state["opt"] = trainer.optimizer.init(trainer.state["params"])
    losses, writes = [], []
    step = trainer._step

    def counted_step(batch):
        m = step(batch)
        losses.append(float(m["loss"]))
        if sigterm_after is not None and rank == 1 \
                and len(losses) == sigterm_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return m
    trainer._step = counted_step
    write = CheckpointManager._write

    def counted_write(self, *a, **kw):
        writes.append(a[0])
        return write(self, *a, **kw)
    CheckpointManager._write = counted_write
    try:
        result = trainer.train()
    finally:
        CheckpointManager._write = write
    return {"params": to_numpy(trainer.state["params"]), "losses": losses,
            "result": result, "metrics": trainer.metrics_history,
            "writes": writes, "step": trainer.state["step"]}


def train_cases(rank, world, cases):
    """train_steps for each (name, kwargs) of `cases`, in one spawn, and
    the Trainers of the families once refused on several ranks."""
    out = {name: train_steps(rank, world, **kw) for name, kw in cases}
    out["refused"] = trainer_refusals(rank, world)
    return out


def trainer_refusals(rank, world):
    """For the pointer models and the MoE LM, each once refused on
    `world` data-parallel ranks (ROADMAP item 10's rest): None where a
    Trainer over the ranks is built and initialised, else the error."""
    from tell_tpu_torch.config import LLMConfig, small_test_config
    from tell_tpu_torch.models.registry import get_model
    from tell_tpu_torch.training.trainer import Trainer, TrainerConfig
    out = {}
    for name, model_type, cfg in (
            ("pointer", "transformer_pointer", small_test_config()),
            ("pointer_2", "transformer_pointer_2", small_test_config()),
            ("moe", "transformer_modern", LLMConfig(
                moe_experts=4, dim=32, num_layers=1, num_heads=4,
                num_kv_heads=2, ffn_dim=48, vocab_size=300,
                contexts=small_test_config().decoder.contexts[:2]))):
        adapter = get_model(model_type, cfg)
        try:
            trainer = Trainer(adapter.config,
                              TrainerConfig(serialization_dir="unused"),
                              lambda epoch: iter(()), None, None,
                              device="cpu", adapter=adapter)
            trainer.initialize()
            out[name] = None if trainer.mesh.shape["data"] == world \
                else "not data-parallel"
        except Exception as e:  # noqa: BLE001 - reported to the test
            out[name] = f"{type(e).__name__}: {e}"
    return out


def rank_masks_reference(cfg, params, train, val, world, seed=3):
    """One process's account of train_steps on `world` ranks with dropout
    on, written apart from the train step's reduction: at each step, rank
    r's rows' loss under fold_in(the step's generator, r), each weighted
    by its sample size, summed over the ranks and divided by the summed
    sizes; its gradients and the Trainer's BertAdam; then the validation
    loss on the whole batch. (No tail capacity: a budget here would be
    each call's, not the global batch's.) Returns the params, each step's
    loss and the validation loss."""
    from tell_tpu_torch.models.captioner import captioner_loss
    from tell_tpu_torch.ops.common import fold_in
    from tell_tpu_torch.training.optimizer import apply_updates, bert_adam
    from tell_tpu_torch.training.trainer import TrainerConfig, step_generator
    assert cfg.decoder.tail_capacity_frac is None
    t = TrainerConfig(warmup=0.0, t_total=100, seed=seed)
    opt = bert_adam(lr=t.lr, b1=t.b1, b2=t.b2, weight_decay=t.weight_decay,
                    max_grad_norm=t.max_grad_norm, t_total=t.t_total,
                    warmup=t.warmup)
    p = to_torch(params, "cpu")
    state = opt.init(p)
    losses = []
    for step, b in enumerate(train):
        gen = step_generator(t.seed, step, "cpu")
        b = to_torch(b, "cpu")

        def global_loss(q):
            parts = [captioner_loss(q, cfg, _rows_of(b, r, world),
                                    fold_in(gen, r), deterministic=False)
                     for r in range(world)]
            sizes = [aux["sample_size"].float() for _, aux in parts]
            return sum(v * n for (v, _), n in zip(parts, sizes)) / sum(sizes)
        loss, grads = _grads(p, global_loss)
        with torch.no_grad():
            updates, state = opt.update(grads, state, p)
            p = apply_updates(p, updates)
        losses.append(float(loss))
    with torch.no_grad():
        val_loss = float(captioner_loss(p, cfg, to_torch(val[0], "cpu"))[0])
    return {"params": to_numpy(p), "losses": losses, "val_loss": val_loss}


# -- run_ranks' failure paths --------------------------------------------

def fail_on(rank, world, bad):
    """Rank `bad` raises; the others wait for it in a collective."""
    from tell_tpu_torch.parallel import barrier
    if rank == bad:
        raise KeyError(f"rank {rank} fails on purpose")
    barrier()
    return rank


def hang(rank, world):
    """Every rank waits in a collective that rank 0 never joins."""
    import time
    from tell_tpu_torch.parallel import barrier
    if rank == 0:
        time.sleep(600)
    barrier()


def jobs(rank, world, todo):
    """Run each (function name, args) of `todo` in these ranks, in order,
    and return their results: several checks for one spawn."""
    torch.set_num_threads(1)
    return [globals()[name](rank, world, *args) for name, args in todo]


def llm_pp(rank, world, cfg, params, batch, n_micro):
    """llm_loss_pp over a pipe group of every rank: the loss, the MoE aux
    and the gradients of the stacked tree (this rank's stage slice
    nonzero)."""
    from tell_tpu_torch.models.llm_decoder import (llm_loss_pp,
                                                   stack_llm_layers)
    stacked = stack_llm_layers(to_torch(params, "cpu"), world)
    batch = to_torch(batch, "cpu")
    aux_out = {}

    def loss(st):
        value, aux = llm_loss_pp(st, cfg, batch, None, n_micro)
        aux_out.update(aux)
        return value
    value, g = _grads(stacked, loss)
    return {"loss": float(value),
            "moe_aux": float(aux_out["moe_aux"]) if "moe_aux" in aux_out
            else None, "grads": to_numpy(g)}


def data_ranks_of(rank, world, bucketing):
    """training.trainer.data_ranks in a rank (raises SystemExit for a
    multi-shape config)."""
    from tell_tpu_torch.training.trainer import data_ranks
    try:
        return data_ranks(bucketing)
    except SystemExit as e:
        raise RuntimeError(str(e)) from None


# -- tensor parallelism, the MoE's and the pointer's global batch -----------

def _grid(world, n_model):
    from tell_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(world // n_model, n_model)


def tp_train(rank, world, n_model, cfg, params, train, val, run_dir,
             adapter=None):
    """A Trainer of `cfg` on a (world / n_model) x n_model grid from the
    whole `params` (numpy), over this rank's "data" rows of the global
    `train` and `val` batches (one epoch, dropout as cfg says). Returns
    this rank's shards of the initial params, the first step's gradients
    after the reduction and its first moments (BertAdam's m: the clipped
    gradients' share), both gathered whole, each step's loss, the
    validation loss and the params after the epoch (gathered whole)."""
    from tell_tpu_torch.models.registry import get_model
    from tell_tpu_torch.parallel.mesh import gather_params
    from tell_tpu_torch.training.trainer import Trainer, TrainerConfig
    torch.set_num_threads(1)
    n_data = world // n_model
    tcfg = TrainerConfig(serialization_dir=run_dir, num_epochs=1,
                         n_data=n_data, n_model=n_model, summary_interval=0,
                         warmup=0.0, t_total=100, seed=3)
    i = rank // n_model
    local = [_rows_of(b, i, n_data) for b in train]
    local_val = [_rows_of(b, i, n_data) for b in val]
    adapter = adapter or get_model("captioner", cfg)
    trainer = Trainer(cfg, tcfg, lambda epoch: iter([dict(b) for b in local]),
                      lambda: iter([dict(b) for b in local_val]), None,
                      device="cpu", adapter=adapter)
    trainer.initialize()
    trainer.load_params(to_torch(params, "cpu"))
    shards = to_numpy(trainer.state["params"])
    losses, grads = [], []
    step, update = trainer._step, trainer.optimizer.update

    def counted_step(batch):
        m = step(batch)
        losses.append(float(m["loss"]))
        return m

    def recorded_update(g, state, p, *rest):
        out = update(g, state, p, *rest)
        if not grads:
            grads.append((g, out[1].m))
        return out
    trainer._step = counted_step
    trainer.optimizer.update = recorded_update
    trainer.train()
    whole = trainer._whole
    return {"shards": shards, "grads": to_numpy(whole(grads[0][0])),
            "moments": to_numpy(whole(grads[0][1])), "losses": losses,
            "val_loss": trainer.metrics_history[0]["val_loss"],
            "params": to_numpy(whole(trainer.state["params"]))}


def tp_loss(rank, world, n_model, family, cfg, params, batch):
    """The loss (and its aux's floats) and the gradients (summed over
    "data", gathered whole) of `family`'s objective ("llm", "pointer" or
    "lstm") on a (world / n_model) x n_model grid, each rank on its
    "data" rows of `batch`, its params the rules' shards of `params`."""
    from tell_tpu_torch.models.llm_decoder import llm_loss
    from tell_tpu_torch.models.lstm_decoder import lstm_captioner_loss
    from tell_tpu_torch.models.pointer import pointer_loss
    from tell_tpu_torch.parallel.comm import all_reduce
    from tell_tpu_torch.parallel.mesh import (gather_params,
                                              param_sharding_rules,
                                              shard_params)
    torch.set_num_threads(1)
    mesh = _grid(world, n_model)
    n_data = world // n_model
    whole = to_torch(params, "cpu")
    specs = param_sharding_rules(whole, mesh)
    local = shard_params(whole, mesh, specs)
    rows = to_torch(_rows_of(batch, mesh.index("data"), n_data), "cpu")
    kw = {"group": mesh.group("data")} if n_data > 1 else {}
    kw["tp"] = mesh.model_axis()
    fn = {"llm": llm_loss, "pointer": pointer_loss,
          "lstm": lstm_captioner_loss}[family]
    aux_out = {}

    def loss(p):
        value, aux = fn(p, cfg, rows, **kw)
        aux_out.update(aux)
        return value
    value, g = _grads(local, loss)
    if n_data > 1:
        g = tree_map(lambda t: all_reduce(t, mesh.group("data")), g)
    return {"loss": float(value),
            "aux": {k: float(v.detach()) for k, v in aux_out.items()
                    if isinstance(v, torch.Tensor)},
            "grads": to_numpy(gather_params(g, mesh, specs)),
            "shards": to_numpy(local)}


def moe_dp(rank, world, params, x, mask, top_k, capacity_factor):
    """ops/moe.py's routing, output and aux of this rank's rows of x over
    the data-parallel group of every rank, and its routing of the same
    rows alone (group None)."""
    from tell_tpu_torch.ops.moe import moe_ffn, moe_routing
    from tell_tpu_torch.parallel.comm import world_size
    torch.set_num_threads(1)
    n = x.shape[0] // world_size()
    xs = torch.as_tensor(x[rank * n:(rank + 1) * n])
    ms = torch.as_tensor(mask[rank * n:(rank + 1) * n])
    p = to_torch(params, "cpu")
    out = {}
    for name, group in (("global", torch.distributed.group.WORLD),
                        ("local", None)):
        r = moe_routing(p, xs, top_k, capacity_factor, ms, group)
        out[name] = {"expert": r["flat_e"].numpy(), "pos": r["pos"].numpy(),
                     "keep": r["keep"].numpy(), "cap": r["cap"]}
    y, aux = moe_ffn(p, xs, top_k, capacity_factor, ms,
                     group=torch.distributed.group.WORLD)
    out["out"], out["aux"] = y.numpy(), float(aux)
    return out


def tp_resume(rank, world, n_model, cfg, params, train, run_dir,
              stop_after=None):
    """One epoch of a Trainer on a 1 x n_model grid over `train` (every
    rank the whole batches): from the whole `params` (numpy), or, with
    params None, recovered from run_dir's checkpoint; stopped by
    request_stop after `stop_after` steps. Returns the params (gathered
    whole), the state's step and each step's loss."""
    from tell_tpu_torch.training.trainer import Trainer, TrainerConfig
    torch.set_num_threads(1)
    tcfg = TrainerConfig(serialization_dir=run_dir, num_epochs=1,
                         n_data=world // n_model, n_model=n_model,
                         summary_interval=0, warmup=0.0, t_total=100,
                         seed=3)
    trainer = Trainer(cfg, tcfg, lambda epoch: iter([dict(b) for b in train]),
                      None, None, device="cpu")
    if params is None:
        assert trainer.recover()
    else:
        trainer.initialize()
        trainer.load_params(to_torch(params, "cpu"))
    losses, step = [], trainer._step

    def counted_step(batch):
        m = step(batch)
        losses.append(float(m["loss"]))
        if stop_after is not None and len(losses) == stop_after:
            trainer.request_stop()
        return m
    trainer._step = counted_step
    trainer.train()
    return {"params": to_numpy(trainer._whole(trainer.state["params"])),
            "step": trainer.state["step"], "losses": losses}
