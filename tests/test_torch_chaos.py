"""The reference's fault-injection cases on the port's ``swarm/chaos.py``.

``tests/test_chaos.py`` runs on the port (``tests/torch_reference_cases.py``):
CRC-caught corruption, scheduled corruption, drops, delays, lossy peers,
fault schedules, partitions and the asyncio loop invariants, on port
averagers over ``ChaosTransport``s with the device codec on CPU tensors.

One case does not run as is, on purpose:
``test_mesh_shrink_mid_training_falls_back_to_host_codec`` expects a codec
that degrades to the host for good after a failed device op. The port's codec
never degrades (``ops/mesh_codec.py``, "No degrade"; ROADMAP "No codec
degrade"), and it has no ``"mesh"`` backend name. Its counterpart here,
``test_mesh_shrink_mid_training_fails_the_round_then_commits_on_device``:
the failed device op raises, that round fails, and the next round commits on
the device backend with no host op.
"""

import asyncio

import numpy as np
import pytest
from torch_reference_cases import count_cases, device_codec, port_cases  # noqa: F401

from distributedvolunteercomputing_tpu_torch.ops import mesh_codec
from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager
from distributedvolunteercomputing_tpu_torch.swarm.chaos import ChaosTransport
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm.telemetry import Telemetry

REPLACED = {
    "test_mesh_shrink_mid_training_falls_back_to_host_codec":
        "expects the reference's degrade to the host codec, which the port does not do on purpose",
}
REFERENCE = port_cases("test_chaos.py", globals(), drop=REPLACED)


def test_reference_cases_bind_the_port():
    assert REFERENCE["ChaosTransport"] is ChaosTransport and REFERENCE["SyncAverager"] is SyncAverager
    assert count_cases(REFERENCE) + len(REPLACED) == 14


@pytest.mark.mesh_codec
def test_mesh_shrink_mid_training_fails_the_round_then_commits_on_device():
    """The port's counterpart of the reference's mesh-shrink case: one
    volunteer's device op fails between rounds. The op raises, that round
    fails on it (and its leader, short of a member, skips), and the next
    round commits on the device backend again. The health probe is off, so
    the injected failure lands on the round's own encode: with it on, the
    probe's sampled encode takes the failure and its gauge swallows it."""

    async def scenario():
        async def make_node(peer_id, codec, boot=None):
            t = ChaosTransport(seed=5)
            dht = DHTNode(t)
            await dht.start(bootstrap=[boot] if boot else None)
            mem = SwarmMembership(dht, peer_id, ttl=10.0)
            await mem.join()
            avg = SyncAverager(
                t, dht, mem, join_timeout=4.0, gather_timeout=3.0, wire="bf16", mesh_codec=codec,
                telemetry=Telemetry(peer_id=peer_id, health_enabled=False),
            )
            return t, avg

        codec_a = mesh_codec.MeshCodec(device="cpu", backend="device")
        codec_b = mesh_codec.MeshCodec(device="cpu", backend="device")
        ta, avg_a = await make_node("ma", codec_a)
        tb, avg_b = await make_node("mb", codec_b, boot=ta.addr)
        n = 20_000  # crosses the chunking threshold, so the round streams
        tree_a = {"w": np.full((n,), 1.0, np.float32)}
        tree_b = {"w": np.full((n,), 3.0, np.float32)}
        try:
            r0 = await asyncio.gather(avg_a.average(tree_a, 0), avg_b.average(tree_b, 0))
            assert r0[0] is not None and r0[1] is not None
            np.testing.assert_allclose(r0[0]["w"], 2.0, rtol=1e-2)

            # The member's card fails its next device op: its push's encode.
            codec_b.inject_failure(1)
            r1 = await asyncio.gather(
                avg_a.average(tree_a, 1), avg_b.average(tree_b, 1), return_exceptions=True
            )
            assert isinstance(r1[1], mesh_codec.MeshCodecError), r1[1]
            assert r1[0] is None, "the leader must skip a round its only member could not feed"

            r2 = await asyncio.gather(avg_a.average(tree_a, 2), avg_b.average(tree_b, 2))
            assert r2[0] is not None and r2[1] is not None
            np.testing.assert_allclose(r2[0]["w"], 2.0, rtol=1e-2)
            np.testing.assert_allclose(r2[1]["w"], 2.0, rtol=1e-2)
            for avg, codec in ((avg_a, codec_a), (avg_b, codec_b)):
                st = avg.stats()["mesh_codec"]
                assert st["backend"] == "device" and st["ops_host"] == 0 and st["ops_mesh"] > 0
                assert codec.backend == "device" and not hasattr(codec, "degraded")
        finally:
            await ta.close()
            await tb.close()

    asyncio.run(asyncio.wait_for(scenario(), timeout=90))
