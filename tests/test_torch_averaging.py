"""The port's sync averaging round over localhost TCP, and against the JAX
package's averager in one mixed round.

Every round here runs the port's codec on the device backend over CPU
tensors (the plain versions of K4/K5), as the volunteer runs it on the card.
Every close is bounded so that a regression of the transport's close fails
instead of hanging.
"""

import asyncio
import time
import types

import numpy as np
import pytest

from distributedvolunteercomputing_tpu.ops import mesh_codec as jax_mc
from distributedvolunteercomputing_tpu.swarm.averager import SyncAverager as JaxSyncAverager
from distributedvolunteercomputing_tpu.swarm.dht import DHTNode as JaxDHTNode
from distributedvolunteercomputing_tpu.swarm.membership import SwarmMembership as JaxMembership
from distributedvolunteercomputing_tpu.swarm.transport import Transport as JaxTransport
from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager, make_averager
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.matchmaking import Group
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport

BF16_U = 2.0**-8  # bf16 unit roundoff (8-bit significand)
KW = {"join_timeout": 6.0, "gather_timeout": 8.0, "min_group": 2}


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    assert native.ensure_built()


def make_tree(value: float, rng=None):
    w = np.full((4, 3), value, np.float32)
    if rng is not None:
        w = w + rng.standard_normal((4, 3)).astype(np.float32)
    return {"w": w, "b": {"x": np.full((5,), value * 2, np.float32)}}


async def _node(pkg: str, peer_id: str, boot=None, **avg_kw):
    if pkg == "port":
        t = Transport(**avg_kw.pop("transport_kw", {}))
        dht, mem_cls, avg_cls = DHTNode(t), SwarmMembership, SyncAverager
        codec = mc.MeshCodec(device="cpu", backend="device")
    else:
        t = JaxTransport()
        dht, mem_cls, avg_cls = JaxDHTNode(t), JaxMembership, JaxSyncAverager
        codec = jax_mc.MeshCodec(backend="host")
    await dht.start(bootstrap=[boot] if boot else None)
    mem = mem_cls(dht, peer_id, ttl=10.0)
    await mem.join()
    return t, mem, avg_cls(t, dht, mem, mesh_codec=codec, **{**KW, **avg_kw})


async def _teardown(nodes):
    # Port nodes first: with them gone, the reference's close (which waits
    # for its inbound connections) returns at once.
    for t, mem, _ in sorted(nodes, key=lambda n: not isinstance(n[0], Transport)):
        try:
            await asyncio.wait_for(mem.leave(), 5)
        except Exception:
            pass
        await asyncio.wait_for(t.close(), 5)


def _bf16_close(got, want, scale, rounds=1):
    """|got - want| within ``rounds`` bf16 roundings of ``scale`` (plus the
    f32 floor)."""
    np.testing.assert_array_less(np.abs(got - want), rounds * BF16_U * scale + 4 * 2.0**-24 * scale + 1e-30)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("weights", [(1.0, 1.0), (3.0, 1.0)], ids=["uniform", "weighted"])
def test_two_port_volunteers_average(wire, weights):
    async def main():
        a = await _node("port", "vol0", wire=wire)
        b = await _node("port", "vol1", boot=a[0].addr, wire=wire)
        try:
            return await asyncio.gather(
                a[2].average(make_tree(0.0), 1, weight=weights[0]),
                b[2].average(make_tree(4.0), 1, weight=weights[1]),
            ), [n[2].stats() for n in (a, b)]
        finally:
            await _teardown([a, b])

    results, stats = run(main())
    mean = 4.0 * weights[1] / sum(weights)
    for r in results:
        assert r is not None and isinstance(r["w"], np.ndarray) and r["w"].dtype == np.float32
        np.testing.assert_allclose(r["w"], mean, rtol=1e-5)
        np.testing.assert_allclose(r["b"]["x"], 2 * mean, rtol=1e-5)
    for st in stats:
        assert st["rounds_ok"] == 1 and st["mesh_codec"]["backend"] == "device"
        assert st["mesh_codec"]["ops_host"] == 0


def test_streamed_round_folds_through_the_device_folder():
    """A leader armed before the members push: their chunked bf16 payloads
    stream into the aggregator and fold through MeshMeanFolder (the staged
    flush that runs K5 on the card), three chunks each at chunk_bytes=4096."""
    n = 5000
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]

    async def main():
        nodes = []
        for pid in ("leader", "m0", "m1"):
            t = Transport(chunk_bytes=4096)
            await t.start()
            dht = DHTNode(t)
            mem = SwarmMembership(dht, pid, ttl=10.0)
            avg = SyncAverager(t, dht, mem, wire="bf16", mesh_codec=mc.MeshCodec(device="cpu", backend="device"),
                               gather_timeout=6.0)
            nodes.append((t, mem, avg))
        (lt, _, leader), members = nodes[0], nodes[1:]
        try:
            buf = leader._pack({"w": vals[0]})
            tokens = {"leader": "ltok", "m0": "tok0", "m1": "tok1"}
            group = Group(
                epoch="round-1", members=[("leader", lt.addr)] + [(f"m{i}", m[0].addr) for i, m in enumerate(members)],
                my_index=0, token="ltok", member_tokens=tokens, deadline=time.time() + 4.0, budget=4.0,
            )
            lead = asyncio.create_task(leader._lead_round(group, leader._wire_roundtrip(buf), 1.0))
            await asyncio.sleep(0.15)  # armed by now

            async def push(i):
                t, _, avg = members[i]
                payload = avg._wire_stream(avg._pack({"w": vals[i + 1]}))
                await t.call(lt.addr, "sync.contribute", {
                    "epoch": "round-1", "peer": f"m{i}", "weight": float(i + 1),
                    "schema": leader._schema, "token": f"tok{i}",
                }, payload, timeout=5.0)

            await asyncio.gather(push(0), push(1))
            return await asyncio.wait_for(lead, 8.0), leader.stats()
        finally:
            for t, _, _ in nodes:
                await asyncio.wait_for(t.close(), 5)

    result, stats = run(main())
    agg = stats["aggregation"]
    assert agg["streamed_contribs"] == 2 and agg["folder_kind"] == "staged" and agg["folder_flushes"] > 0
    assert agg["codec_backend"] == "device" and stats["mesh_codec"]["ops_host"] == 0
    q = [native.bf16_to_f32(native.f32_to_bf16(v)) for v in vals]
    want = (1.0 * q[0] + 1.0 * q[1] + 2.0 * q[2]) / 4.0
    np.testing.assert_allclose(result["w"], want, rtol=1e-5, atol=1e-6)


def test_codec_failure_fails_the_round_and_keeps_local_state():
    """A device failure in the leader's codec fails the round on both peers
    (the leader's average raises, the member's returns None), neither input
    changes, and the next round on the same codec commits: the codec stays on
    the device and nothing falls back to the host."""

    async def main():
        a = await _node("port", "vol0", wire="bf16")
        b = await _node("port", "vol1", boot=a[0].addr, wire="bf16")
        codec = a[2].mesh_codec
        try:
            codec.inject_failure(10**6)  # every device op of this round
            trees = make_tree(0.0), make_tree(4.0)
            failed = await asyncio.gather(
                a[2].average(trees[0], 1, weight=1.0), b[2].average(trees[1], 1, weight=1.0),
                return_exceptions=True,
            )
            codec._fail_injected = 0
            ok = await asyncio.gather(
                a[2].average(make_tree(0.0), 2, weight=1.0), b[2].average(make_tree(4.0), 2, weight=1.0)
            )
            return failed, trees, ok, [n[2].stats() for n in (a, b)]
        finally:
            await _teardown([a, b])

    failed, trees, ok, stats = run(main())
    assert isinstance(failed[0], mc.MeshCodecError) and failed[1] is None
    np.testing.assert_array_equal(trees[0]["w"], 0.0)
    np.testing.assert_array_equal(trees[1]["w"], 4.0)
    for r in ok:
        np.testing.assert_allclose(r["w"], 2.0, rtol=1e-5)
    assert [st["rounds_ok"] for st in stats] == [1, 1]
    assert stats[0]["mesh_codec"]["backend"] == "device" and stats[0]["mesh_codec"]["ops_host"] == 0


def test_close_returns_with_a_peer_connected():
    """The port's close fix: a peer's pooled connection stays open after an
    RPC, and close() must not wait for it (the reference's waits)."""

    async def main():
        server, client = Transport(), Transport()
        async def ping(args, payload):
            return {"pong": True}, b""

        server.register("ping", ping)
        await server.start()
        await client.start()
        try:
            assert (await client.call(server.addr, "ping", {}, timeout=5.0))[0]["pong"]
            t0 = time.monotonic()
            await asyncio.wait_for(server.close(), 2.0)
            return time.monotonic() - t0
        finally:
            await asyncio.wait_for(client.close(), 5)

    assert run(main()) < 2.0


def test_mixed_round_with_the_reference():
    """One reference SyncAverager and one port SyncAverager on localhost with
    the bf16 wire: same schema hash, byte-equal wire, and a committed round
    whose results hold the weighted mean within bf16 rounding.

    The port leads (with no bandwidth advertised yet, the smaller peer id
    does): the reference's leader can commit before an inline push it
    already holds is folded (ROADMAP Queue 3), which the port's copy fixes."""
    rng = np.random.default_rng(1)
    trees = [make_tree(0.0, rng), make_tree(4.0, rng)]
    weights = (3.0, 1.0)

    async def main():
        ref = await _node("ref", "vol-ref", wire="bf16")
        port = await _node("port", "vol-a-port", boot=ref[0].addr, wire="bf16")
        try:
            results = await asyncio.gather(
                ref[2].average(trees[0], 1, weight=weights[0]),
                port[2].average(trees[1], 1, weight=weights[1]),
            )
            probe = rng.standard_normal(3000).astype(np.float32)
            wires = (ref[2]._to_wire(probe), port[2]._to_wire(probe))
            return results, (ref[2]._schema, port[2]._schema), wires, port[2].stats()
        finally:
            await _teardown([ref, port])

    results, schemas, wires, port_stats = run(main())
    assert port_stats["aggregation"]["rounds_streamed"] == 1  # the port led
    assert schemas[0] is not None and schemas[0] == schemas[1]
    assert wires[0] == wires[1]
    for key in ("w",):
        xs = [t[key] for t in trees]
        want = (weights[0] * xs[0] + weights[1] * xs[1]) / sum(weights)
        scale = np.maximum(np.abs(xs[0]), np.abs(xs[1]))
        for r in results:
            assert r is not None
            _bf16_close(np.asarray(r[key], np.float32), want, scale, rounds=2)


def test_unported_modes_and_wires_raise():
    """Every mode builds its port averager, on every wire of the reference
    and with a shard manager (all ported now); what the reference refuses
    (an unknown wire, a gradient compressor under a pairwise mode) raises
    its ValueError, and the resilience collaborators are accepted."""
    from distributedvolunteercomputing_tpu_torch.swarm import averager as avg_mod
    from distributedvolunteercomputing_tpu_torch.swarm.resilience import ResiliencePolicy

    async def main():
        t = Transport()
        dht = DHTNode(t)
        mem = SwarmMembership(dht, "solo", ttl=10.0)
        for mode, cls in (("gossip", avg_mod.GossipAverager), ("butterfly", avg_mod.ButterflyAverager),
                          ("byzantine", avg_mod.ByzantineAverager)):
            assert type(make_averager(mode, t, dht, mem)) is cls
        for wire in ("f32", "bf16", "q8", "topk", "powersgd", "sign"):
            assert SyncAverager(t, dht, mem, wire=wire).wire == wire
        with pytest.raises(ValueError, match="unknown wire dtype"):
            SyncAverager(t, dht, mem, wire="q4")
        with pytest.raises(ValueError, match="not supported for gossip"):
            make_averager("gossip", t, dht, mem, wire="topk")
        sm = types.SimpleNamespace(summary=dict, telemetry=None)
        avg = SyncAverager(t, dht, mem, shard_manager=sm)
        assert avg.shard_manager is sm and sm.telemetry is avg.telemetry
        policy = ResiliencePolicy()
        assert SyncAverager(t, dht, mem, resilience=policy).resilience is policy
        await asyncio.wait_for(t.close(), 5)

    run(main())


def test_two_mesh_volunteers_fold_on_the_ring(monkeypatch):
    """Two CPU volunteers, each training the tiny gpt2 data-parallel on a
    dp=2 mesh with the ring collective: the leader's rounds fold through
    RingMeanFolder, and each committed round's result is the weighted mean of
    the two payloads within bf16 rounding. "auto" puts a CPU codec on the
    host, so the codec is forced onto its (CPU) ranks, where the ring's plain
    versions run."""
    from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh
    from distributedvolunteercomputing_tpu_torch.swarm.volunteer import Volunteer, VolunteerConfig
    from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

    tiny = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=256, max_len=32, xent_chunk=16, remat=False)
    base = dict(
        model="gpt2_small", model_overrides=tiny, batch_size=4, averaging="sync", wire="bf16", average_every=2,
        overlap=False, steps=4, device="cpu", join_timeout=5.0, gather_timeout=5.0,
        mesh=make_mesh(dp=2, devices=["cpu", "cpu"]), mesh_collective="ring",
    )
    configure = mc.configure
    monkeypatch.setattr(mc, "configure", lambda **kw: configure(**{**kw, "backend": "device"}))
    rounds = [[], []]

    def recording(vol, i):
        inner = vol._averager_callback

        def cb(params, step):
            result = inner(params, step)
            if result is not None:
                weight = vol.cfg.batch_size * max(1, vol.trainer.steps_since_merge)
                rounds[i].append((step, weight, flatten_to_buffer(params)[0], flatten_to_buffer(result)[0]))
            return result

        vol.trainer.averager = cb

    async def main():
        v0 = Volunteer(VolunteerConfig(peer_id="v0", seed=1, **base))
        await v0.start()
        v1 = Volunteer(VolunteerConfig(peer_id="v1", seed=2, coordinator="%s:%d" % v0.transport.addr, **base))
        try:
            await v1.start()
            recording(v0, 0), recording(v1, 1)
            return await asyncio.gather(v0.train(), v1.train())
        finally:
            await asyncio.gather(v0.stop(), v1.stop())

    summaries = run(main(), timeout=60)
    assert all(s["rounds_ok"] >= 1 and np.isfinite(s["final_loss"]) and s["steps"] == 4 for s in summaries)
    assert any(s.get("aggregation", {}).get("folder_kind") == "ring" for s in summaries)
    codec = summaries[0]["mesh_codec"]
    assert codec["devices"] == 2 and codec["collective"] == "ring" and codec["ops_host"] == 0
    assert codec["ring_results"] >= 1
    by_step = [{r[0]: r for r in rs} for rs in rounds]
    common = sorted(set(by_step[0]) & set(by_step[1]))
    assert common
    for step in common:
        (_, w0, x0, r0), (_, w1, x1, r1) = by_step[0][step], by_step[1][step]
        want = (w0 * x0.astype(np.float64) + w1 * x1.astype(np.float64)) / (w0 + w1)
        scale = np.maximum(np.abs(x0), np.abs(x1))
        for r in (r0, r1):
            _bf16_close(r.astype(np.float64), want, scale, rounds=2)
