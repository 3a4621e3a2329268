"""Parallelism over torch.distributed (counterpart of tell_tpu/parallel):
the rank grid and sharding rules (mesh, rules), processes and hosts
(multihost), the collectives with their autograd hops and the "model"
axis (comm), Ulysses sequence parallelism on kernel B (sequence), ring
attention (ring) and GPipe pipelines (pipeline).

The names below load their module at first use, so that the ops and
models can import comm without loading the modules that import them.
"""
import importlib

_WHERE = {
    "Mesh": "mesh", "batch_sharding": "mesh", "gather_params": "mesh",
    "make_mesh": "mesh", "param_sharding_rules": "mesh",
    "shard_params": "mesh", "ModelAxis": "comm", "ONE_RANK": "comm",
    "Ranks": "multihost", "barrier": "multihost", "global_any": "multihost",
    "init_multihost": "multihost", "is_primary": "multihost",
    "place_global_batch": "multihost", "run_ranks": "multihost",
    "pipeline_apply": "pipeline", "stack_stages": "pipeline",
    "roberta_encode_ring": "ring",
    "roberta_encode_seq_parallel": "sequence",
}
__all__ = sorted(_WHERE)


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f".{_WHERE[name]}", __name__),
                   name)
