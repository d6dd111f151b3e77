"""The reference's hierarchical (zone-aware) scheduling cases on the port's
copies.

``tests/test_hierarchy.py`` runs on the port (``tests/torch_reference_cases.py``):
the two-level grid, per-level mixing, bandwidth-weighted leader election,
the transport's bandwidth advertisement, the chaos link model, the
per-zone rollups, real two-zone rounds (zone-local averaging, convergence
to the global mean, zone-local failover, undersized zones) and the bench
smoke. The smoke imports ``experiments/hierarchy_bench.py``, which imports
no JAX itself: it runs as that script's text with its import root rewritten
to the port (``ported_experiments.hierarchy_bench``).
"""

from torch_reference_cases import count_cases, device_codec, port_cases  # noqa: F401

REFERENCE = port_cases("test_hierarchy.py", globals(), experiments=("hierarchy_bench",))


def test_reference_cases_bind_the_port():
    import sys

    from distributedvolunteercomputing_tpu_torch.swarm.chaos import ChaosTransport
    from distributedvolunteercomputing_tpu_torch.swarm.coordinator import Coordinator

    assert REFERENCE["ChaosTransport"] is ChaosTransport and REFERENCE["Coordinator"] is Coordinator
    assert sys.modules["ported_experiments.hierarchy_bench"].ChaosTransport is ChaosTransport
    assert count_cases(REFERENCE) == 33
