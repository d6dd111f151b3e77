"""Parallelism inside one volunteer (ported from
``distributedvolunteercomputing_tpu/parallel/``):

- ``mesh``       — device mesh construction ((dp, sp, pp, ep, tp) axes)
- ``sharding``   — parameter partition rules (Megatron-style TP, stacked
                   layers over pp, expert stacks over ep), the placement of
                   one leaf over the mesh, batch specs
- ``train_step`` — the sharded train step over dp, tp and ep, with ZeRO-1
                   and FSDP

Sequence parallelism (ring attention, Ulysses) and the pipeline come with a
later slice; the sharded step refuses sp and pp axes above 1.
"""

from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh
from distributedvolunteercomputing_tpu_torch.parallel.sharding import (
    batch_sharding,
    make_fsdp_param_shardings,
    make_param_shardings,
    make_zero1_opt_shardings,
    partition_spec_for_path,
)
from distributedvolunteercomputing_tpu_torch.parallel.train_step import (
    make_sharded_train_step,
    shard_train_state,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "make_fsdp_param_shardings",
    "make_param_shardings",
    "make_zero1_opt_shardings",
    "partition_spec_for_path",
    "make_sharded_train_step",
    "shard_train_state",
]
