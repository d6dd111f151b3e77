"""``streaming == dense`` and hedged tile recovery on the port's
``StreamingAggregator`` with a device-backend ``MeshCodec``.

From ``tests/test_agg_stream.py`` (``tests/torch_reference_cases.py``):
``TestStreamingEquivalence`` (all seven robust methods, ``n_peers`` 3, 5 and
8, the deadline subsets, early tiles, aborts, fences) and
``TestHedgedRecovery`` (hedge-then-original and original-then-hedge folded
once, the silent straggler completed by hedges, the property that any
interleaving folds each tile exactly once by (peer, tile, fence)), and
``TestAggregationBenchSmoke``, whose ``experiments/aggregation_bench.py``
runs as its text with the import root rewritten to the port. Every
aggregator of the first two classes takes the process codec, here the
device backend on CPU tensors (the smoke's: the port's CPU default, host
numpy, as the reference's smoke runs its own default):
the mean folds run the port's staged device folder (on the f32 wire these
cases use, one ``add_`` per chunk; on bf16 K5's plain version) and the
robust windows the device path's torch.
"""

import pytest
from torch_reference_cases import count_cases, device_codec, port_cases  # noqa: F401

CLASSES = ("TestStreamingEquivalence", "TestHedgedRecovery", "TestAggregationBenchSmoke")
REFERENCE = port_cases("test_agg_stream.py", globals(), experiments=("aggregation_bench",), keep=CLASSES)


class _BenchCodec:
    @pytest.fixture(autouse=True)
    def _auto_codec(self, device_codec):  # noqa: F811
        """The bench smoke times streaming against materializing on this CPU:
        it runs the codec the port selects here (``backend="auto"``, host
        numpy on the CPU), as the reference's smoke runs its own default. The
        device path's per-tile torch on CPU tensors is not what its latency
        bar is about."""
        from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc

        mc.configure(device="cpu", backend="auto")
        yield


TestAggregationBenchSmoke._auto_codec = _BenchCodec.__dict__["_auto_codec"]  # noqa: F821


def test_reference_cases_bind_the_port(device_codec):  # noqa: F811
    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.swarm.agg_stream import StreamingAggregator

    assert REFERENCE["StreamingAggregator"] is StreamingAggregator
    assert mc.get_default() is device_codec and device_codec.backend == "device"
    assert count_cases({c: REFERENCE[c] for c in CLASSES}) == 11 + 10 + 2
    assert mc.get_default() is device_codec
