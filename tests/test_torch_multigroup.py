"""The reference's multi-group schedule cases on the port's copies.

``tests/test_multigroup.py`` runs on the port (``tests/torch_reference_cases.py``):
the rotating grid partition, the mixing bound, group-scoped rounds,
group-local failover, direct joins, the per-group rollups and the bench
smoke. The smoke imports ``experiments/group_scale_bench.py``, which imports
no JAX itself: it runs as that script's text with its import root rewritten
to the port (``ported_experiments.group_scale_bench``).
"""

from torch_reference_cases import count_cases, device_codec, port_cases  # noqa: F401

REFERENCE = port_cases("test_multigroup.py", globals(), experiments=("group_scale_bench",))


def test_reference_cases_bind_the_port():
    import sys

    from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager
    from distributedvolunteercomputing_tpu_torch.swarm.matchmaking import GroupSchedule

    assert REFERENCE["SyncAverager"] is SyncAverager and REFERENCE["GroupSchedule"] is GroupSchedule
    assert sys.modules["ported_experiments.group_scale_bench"].GroupSchedule is GroupSchedule
    assert count_cases(REFERENCE) == 21
