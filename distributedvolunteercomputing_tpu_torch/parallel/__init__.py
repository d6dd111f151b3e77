"""Parallelism inside one volunteer: its local device mesh and the
data-parallel train step over it (ported from
``distributedvolunteercomputing_tpu/parallel/``)."""
