"""The reference's tail-optimal aggregation cases on the port's copies.

``tests/test_tailopt.py`` runs unchanged on the port
(``tests/torch_reference_cases.py``): the hedged round against a silent
straggler and its drop baseline, the hedged-vs-drop bench smoke, the
summand-redundancy sidecar, the replica-holder refetch, the AIMD hedge
budget, per-peer tail quantiles, the heavy-tailed link model, the doctor's
hedge demotion (``experiments/doctor_report.py``, which imports no package)
and the watchdog's annotation, on port averagers over ``ChaosTransport``s
with the device codec on CPU tensors: the leader folds the refetched tile
ranges in its device folder.
"""

from torch_reference_cases import count_cases, device_codec, port_cases  # noqa: F401

REFERENCE = port_cases("test_tailopt.py", globals())


def test_reference_cases_bind_the_port(device_codec):  # noqa: F811
    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager
    from distributedvolunteercomputing_tpu_torch.swarm.chaos import ChaosTransport

    assert REFERENCE["SyncAverager"] is SyncAverager and REFERENCE["ChaosTransport"] is ChaosTransport
    assert mc.get_default() is device_codec and device_codec.backend == "device"
    assert count_cases(REFERENCE) == 19


def test_refetched_range_is_the_pushs_bytes_on_a_device_codec(device_codec):  # noqa: F811
    """A contributor serves a hedged range re-encoded from its retained f32
    buffer (``_encode_range``: refetch, redundancy shares, sidecars). On a
    device codec it is the codec's own encode, so every tile is the bytes
    the push carried, NaN payloads included, and it runs on the codec (K4
    on a card). The host encoder keeps NaN payload bits that K4
    canonicalizes (ROADMAP Queue 3, the re-encode fix)."""
    import numpy as np

    from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager
    from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
    from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
    from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport

    t = Transport(chunk_bytes=4096)
    dht = DHTNode(t)
    avg = SyncAverager(t, dht, SwarmMembership(dht, "m0", ttl=10.0), wire="bf16", mesh_codec=device_codec)
    buf = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    buf.view(np.uint32)[:6] = [0x7FA00000, 0xFFA00001, 0x7F800001, 0x7F800000, 0xFF800000, 0x80000000]
    pushed = b"".join(avg._wire_stream(buf).factory())
    ops = device_codec.ops_mesh
    tile = 4096 // 2
    for t0 in range(0, buf.size, tile):
        assert avg._encode_range(buf, t0, min(t0 + tile, buf.size)) == pushed[2 * t0 : 2 * (t0 + tile)]
    assert avg._encode_range(buf, 0, buf.size) == pushed
    assert device_codec.ops_mesh > ops and device_codec.ops_host == 0
