"""Parallelism over torch.distributed (counterpart of tell_tpu/parallel):
the rank grid and sharding rules (mesh), processes and hosts
(multihost), the collectives with their autograd hops (comm), Ulysses
sequence parallelism on kernel B (sequence), ring attention (ring) and
GPipe pipelines (pipeline)."""
from .mesh import (Mesh, batch_sharding, make_mesh, param_sharding_rules,
                   shard_params)
from .multihost import (Ranks, barrier, global_any, init_multihost,
                        is_primary, place_global_batch, run_ranks)
from .pipeline import pipeline_apply, stack_stages
from .ring import roberta_encode_ring
from .sequence import roberta_encode_seq_parallel
