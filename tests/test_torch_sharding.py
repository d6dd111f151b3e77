"""The reference's zone-sharding cases on the port's copies.

``tests/test_sharding.py`` runs on the port (``tests/torch_reference_cases.py``):
shard ranges, the HRW ``ShardMap`` and its content-digest fence, the
``ShardStore``, the manager's fencing, re-shard and recovery ladder,
demotion linger, maintenance debounce, the shard-scoped group schedule,
mass accounting by shard, sharded training memory, sharded rounds on port
averagers, the shard bench smoke (``experiments/shard_bench.py`` rewritten to
the port), control-plane snapshot deltas, the shard observability surfaces
and the shard snapshots of ``training/checkpoint.py``.

Two cases do not run as is: ``TestRingLoweringGauge`` tests the reference's
Pallas ring VMEM fallback (``RingMeanFolder._lower_for`` re-lowering the
compiled kernel to XLA when its working set passes the VMEM estimate, with a
gauge and a one-time warning). The port's ring has no such fallback: K6 and
K7 pick their design from where the ranks live (``_card_layout``), never from
a failure, and the codec never degrades. Their replacements test what the
port does instead: ``test_ring_design_follows_the_rank_layout`` and
``test_ring_gauges_count_flushes_and_results``.
"""

import numpy as np
import torch
from torch_reference_cases import count_cases, device_codec, port_cases  # noqa: F401

from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
from distributedvolunteercomputing_tpu_torch.ops import mesh_collective as mcol
from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh

REPLACED = {
    "TestRingLoweringGauge.test_vmem_fallback_surfaces_in_stats":
        "the port's ring has no VMEM re-lowering: replaced by test_ring_design_follows_the_rank_layout",
    "TestRingLoweringGauge.test_warning_fires_once_per_codec":
        "no fallback, so no fallback warning: replaced by test_ring_gauges_count_flushes_and_results",
}
REFERENCE = port_cases("test_sharding.py", globals(), drop=REPLACED, experiments=("shard_bench", "doctor_report"))


def test_reference_cases_bind_the_port():
    from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager
    from distributedvolunteercomputing_tpu_torch.swarm.sharding import ShardManager

    assert REFERENCE["SyncAverager"] is SyncAverager and REFERENCE["ShardManager"] is ShardManager
    assert count_cases(REFERENCE) + len(REPLACED) == 53


def test_ring_design_follows_the_rank_layout():
    """Where the reference's ring re-lowers on a VMEM estimate, the port's
    picks its design from the ranks' layout: every rank on one card (up to 8)
    is the one-launch design, ranks across cards the stepwise one, and the
    codec's stats say which collective it runs; the choice is made before any
    launch, so no fallback exists to surface."""
    one_card = (torch.device("cuda", 0),) * 4
    assert mcol.card_groups(one_card) == [[0, 1, 2, 3]]
    assert mcol.card_groups(tuple(torch.device("cuda", i) for i in range(4))) == [[0], [1], [2], [3]]
    assert mcol.card_groups((torch.device("cuda", 0),) * (mcol.FOLD_MAX_RANKS + 1))[-1] == [mcol.FOLD_MAX_RANKS]
    codec = mc.MeshCodec(device="cpu", backend="device", mesh=make_mesh(dp=2, devices=["cpu", "cpu"]),
                         collective="ring")
    st = codec.stats()
    assert (st["collective"], st["devices"], st["backend"]) == ("ring", 2, "device")
    assert "ring_lower" not in st and "ring_vmem_fallbacks" not in st
    folder = codec.mean_folder(n_elems=96, tile_elems=32, n_tiles=3, wire="bf16")
    assert isinstance(folder, mcol.RingMeanFolder)
    # One rank, or the host backend, or an odd tile: no ring folder.
    assert isinstance(mc.MeshCodec(device="cpu", backend="device").mean_folder(96, 32, 3, "bf16"), mc.MeshMeanFolder)
    assert mc.MeshCodec(device="cpu", backend="host").mean_folder(96, 32, 3, "bf16") is None
    assert codec.mean_folder(n_elems=96, tile_elems=33, n_tiles=3, wire="bf16") is None


def test_ring_gauges_count_flushes_and_results():
    """The port's ring gauges in ``stats()``: flushes folded and results
    gathered, over every folder of the codec, and the fold's result is the
    weighted mean of what was staged (the plain versions on CPU tensors)."""
    from distributedvolunteercomputing_tpu_torch import native

    codec = mc.MeshCodec(device="cpu", backend="device", mesh=make_mesh(dp=2, devices=["cpu", "cpu"]),
                         collective="ring")
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(96).astype(np.float32) for _ in range(2)]
    for _ in range(2):
        folder = codec.mean_folder(n_elems=96, tile_elems=32, n_tiles=3, wire="bf16")
        for w, x in zip((1.0, 3.0), xs):
            bits = native.f32_to_bf16(x)
            for t in range(3):
                folder.add(t, w, bits[32 * t : 32 * (t + 1)].tobytes())
        got = folder.result()
        dec = [native.bf16_to_f32(native.f32_to_bf16(x)).astype(np.float64) for x in xs]
        np.testing.assert_allclose(got, dec[0] + 3.0 * dec[1], rtol=1e-6, atol=1e-6)
    st = codec.stats()
    assert st["ring_flushes"] >= 2 and st["ring_results"] == 2
