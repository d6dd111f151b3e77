"""The port's gossip, butterfly and Byzantine averagers over localhost TCP:
the reference's own cases (``tests/test_averaging.py``: ``TestGossip``,
``TestButterfly``, ``TestByzantine``, the Byzantine identity guards,
``TestButterflyStageCap``, ``TestDerivedTrimFloor``) run on port averagers,
and one mixed round per protocol against the JAX package's averagers.

Every port averager runs its codec on the device backend over CPU tensors
(the plain versions of K4), as the volunteer runs it on the card. Mixed
rounds hold the results bit-equal on the f32 wire and within ``AVG_TOL`` (one
bf16 rounding of the inputs' scale at each mixing stage, plus an f32 floor)
on the bf16 wire. Port transports close first: the reference's close waits
for its open inbound connections.
"""

import asyncio

import numpy as np
import pytest

from distributedvolunteercomputing_tpu.ops import mesh_codec as jax_mc
from distributedvolunteercomputing_tpu.swarm import averager as jax_avg
from distributedvolunteercomputing_tpu.swarm.dht import DHTNode as JaxDHTNode
from distributedvolunteercomputing_tpu.swarm.membership import SwarmMembership as JaxMembership
from distributedvolunteercomputing_tpu.swarm.transport import Transport as JaxTransport
from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
from distributedvolunteercomputing_tpu_torch.swarm.averager import (
    ButterflyAverager,
    ByzantineAverager,
    GossipAverager,
    SyncAverager,
    _Round,
)
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm.transport import RPCError, Transport

# Mixed rounds on the bf16 wire: each mixing stage rounds its inputs to bf16
# once (unit roundoff 2^-8 of the inputs' scale), the mix itself adds a few
# f32 ulps; ``stages`` is the number of such stages a result went through.
AVG_TOL = {"bf16_u": 2.0**-8, "f32_ulps": 4 * 2.0**-24, "floor": 2.0**-126}


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    assert native.ensure_built()


def make_tree(value: float):
    return {"w": np.full((4, 3), value, np.float32), "b": {"x": np.full((5,), value * 2, np.float32)}}


def codec():
    return mc.MeshCodec(device="cpu", backend="device")


async def spawn_volunteers(n, averager_cls, **avg_kw):
    """n port volunteers: [0] is also the DHT bootstrap node."""
    vols = []
    boot = None
    kw = {"join_timeout": 6.0, "gather_timeout": 8.0, **avg_kw}
    for i in range(n):
        t = Transport()
        dht = DHTNode(t)
        await dht.start(bootstrap=[boot] if boot else None)
        boot = boot or t.addr
        mem = SwarmMembership(dht, f"vol{i}", ttl=10.0)
        await mem.join()
        vols.append((t, dht, mem, averager_cls(t, dht, mem, mesh_codec=codec(), **kw)))
    return vols


async def teardown(vols):
    # Port transports first: with them gone the reference's close returns.
    # Two reference nodes hold pooled connections to each other, and each
    # one's close waits for the other's: drop their client pools first.
    refs = [v[0] for v in vols if not isinstance(v[0], Transport)]
    if len(refs) > 1:
        from distributedvolunteercomputing_tpu.swarm.transport import _Conn

        for t in refs:
            for entry in list(t._conns.values()):
                entry.close() if isinstance(entry, _Conn) else entry.cancel()
            t._conns.clear()
        await asyncio.sleep(0.05)
    for t, _, mem, _ in sorted(vols, key=lambda v: not isinstance(v[0], Transport)):
        try:
            await asyncio.wait_for(mem.leave(), 5)
        except Exception:
            pass
        await asyncio.wait_for(t.close(), 5)


async def _solo_stack(peer_id):
    t = Transport()
    dht = DHTNode(t)
    await dht.start()
    mem = SwarmMembership(dht, peer_id, ttl=10.0)
    await mem.join()
    return t, dht, mem


def leaves_close(tree, expected_value, factor=(1.0, 2.0)):
    np.testing.assert_allclose(tree["w"], expected_value * factor[0], rtol=1e-5)
    np.testing.assert_allclose(tree["b"]["x"], expected_value * factor[1], rtol=1e-5)


class TestGossip:
    def test_pairwise_mix(self):
        async def main():
            vols = await spawn_volunteers(2, GossipAverager)
            try:
                a, b = vols[0][3], vols[1][3]
                rb = await b.average(make_tree(2.0), 1)
                ra = await a.average(make_tree(0.0), 2)
                return ra, rb
            finally:
                await teardown(vols)

        ra, _ = run(main())
        assert ra is not None
        leaves_close(ra, 1.0)

    def test_inbox_folded_next_round(self):
        async def main():
            vols = await spawn_volunteers(2, GossipAverager)
            try:
                a, b = vols[0][3], vols[1][3]
                await b.average(make_tree(4.0), 1)  # publish b
                await a.average(make_tree(0.0), 2)  # a gossips with b; b banks a's buf
                return await b.average(make_tree(4.0), 3)  # b folds its inbox
            finally:
                await teardown(vols)

        rb2 = run(main())
        assert rb2 is not None
        assert float(rb2["w"].mean()) < 4.0

    def test_publish_serves_exchanges_before_first_round(self):
        async def main():
            vols = await spawn_volunteers(2, GossipAverager)
            try:
                a, b = vols[0][3], vols[1][3]
                b.publish(make_tree(4.0))  # b is still starting
                return await a.average(make_tree(0.0), 1)
            finally:
                await teardown(vols)

        ra = run(main())
        assert ra is not None
        leaves_close(ra, 2.0)

    def test_replayed_exchange_never_banks_twice(self):
        async def main():
            vols = await spawn_volunteers(2, GossipAverager)
            try:
                b = vols[1][3]
                await b.average(make_tree(2.0), 1)  # publish b's params
                buf = b._pack(make_tree(0.0))
                args = {"peer": "a", "weight": 1.0, "schema": b._schema, "xid": "fixed-xid-1"}
                wire = b._to_wire(buf)
                await b._rpc_exchange(dict(args), wire)  # original: accepted
                ret, _ = await b._rpc_exchange(dict(args), wire)  # replay: served, not banked
                try:
                    await b._rpc_exchange({"peer": "a", "weight": 1.0, "schema": b._schema}, wire)
                    missing = "accepted"
                except RPCError:
                    missing = "rejected"
                return len(b._inbox), ret, missing
            finally:
                await teardown(vols)

        inbox_len, replay_ret, missing = run(main())
        assert inbox_len == 1
        assert "weight" in replay_ret
        assert missing == "rejected"

    def test_namespaced_partner_selection(self):
        async def spawn(peer_id, ns, extra_info, boot):
            t = Transport()
            dht = DHTNode(t)
            await dht.start(bootstrap=[boot] if boot else None)
            mem = SwarmMembership(dht, peer_id, ttl=10.0, extra_info=extra_info)
            await mem.join()
            return t, dht, mem, GossipAverager(
                t, dht, mem, namespace=ns, join_timeout=6.0, gather_timeout=8.0, mesh_codec=codec()
            )

        async def main():
            ns = "m/params"
            a = await spawn("va", ns, {"model": "m", "avg_ns": ns}, None)
            boot = a[0].addr
            b = await spawn("vb", ns, {"model": "m", "avg_ns": ns}, boot)
            grads = await spawn("vgrads", "m/grads", {"model": "m", "avg_ns": "m/grads"}, boot)
            try:
                await b[3].average(make_tree(2.0), 1)
                ra = await a[3].average(make_tree(0.0), 2)
                rg = await grads[3].average(make_tree(9.0), 1)
                return ra, rg
            finally:
                await teardown([a, b, grads])

        ra, rg = run(main())
        assert ra is not None
        leaves_close(ra, 1.0)
        assert rg is None


class TestButterfly:
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_power_of_two_full_average(self, n):
        async def main():
            vols = await spawn_volunteers(n, ButterflyAverager, min_group=n)
            try:
                return await asyncio.gather(
                    *(avg.average(make_tree(float(i)), 1) for i, (_, _, _, avg) in enumerate(vols))
                )
            finally:
                await teardown(vols)

        results = run(main())
        expected = sum(range(len(results))) / len(results)
        for r in results:
            assert r is not None
            leaves_close(r, expected)

    def test_non_power_of_two_partial_contracts(self):
        async def main():
            vols = await spawn_volunteers(3, ButterflyAverager, min_group=3)
            try:
                return await asyncio.gather(
                    *(avg.average(make_tree(float(i)), 1) for i, (_, _, _, avg) in enumerate(vols))
                )
            finally:
                await teardown(vols)

        vals = [float(r["w"].mean()) for r in run(main()) if r is not None]
        assert len(vals) >= 2
        assert np.var(vals) < np.var([0.0, 1.0, 2.0])

    def test_heterogeneous_weights(self):
        async def main():
            vols = await spawn_volunteers(2, ButterflyAverager, min_group=2)
            try:
                return await asyncio.gather(
                    vols[0][3].average(make_tree(0.0), 1, weight=3.0),
                    vols[1][3].average(make_tree(4.0), 1, weight=1.0),
                )
            finally:
                await teardown(vols)

        for r in run(main()):
            leaves_close(r, 1.0)

    def test_partner_death_mid_round_skips_stage(self):
        async def main():
            vols = await spawn_volunteers(4, ButterflyAverager, min_group=2, stage_timeout=3.0)
            try:
                async def die_soon():
                    await asyncio.sleep(0.3)
                    await vols[3][0].close()

                results = await asyncio.gather(
                    *(vols[i][3].average(make_tree(float(i)), 1) for i in range(3)), die_soon()
                )
                return results[:3]
            finally:
                await teardown(vols[:3])

        assert all(r is not None for r in run(main()))


class TestByzantine:
    def test_full_mesh_mean_equals_trimmed(self):
        async def main():
            vols = await spawn_volunteers(4, ByzantineAverager, min_group=4)
            try:
                return await asyncio.gather(
                    *(avg.average(make_tree(float(i)), 1) for i, (_, _, _, avg) in enumerate(vols))
                ), [v[3].mesh_codec.stats() for v in vols]
            finally:
                await teardown(vols)

        results, stats = run(main())
        for r in results:
            assert r is not None
            leaves_close(r, 1.5)  # trim 1: the mean of the middle two of [0, 1, 2, 3]
        # The robust aggregate ran on the device path.
        assert all(s["ops_mesh"] > 0 and s["ops_host"] == 0 for s in stats)

    def test_malicious_contribution_bounded(self):
        async def main():
            vols = await spawn_volunteers(4, ByzantineAverager, min_group=4)
            try:
                return await asyncio.gather(
                    *(vols[i][3].average(make_tree(v), 1) for i, v in enumerate((0.0, 1.0, 2.0, 1e9)))
                )
            finally:
                await teardown(vols)

        for r in run(main())[:3]:
            assert r is not None
            assert np.abs(np.asarray(r["w"])).max() < 10.0, "attacker leaked through"

    @pytest.mark.parametrize(
        "method,method_kw,attacker",
        [("krum", {"n_byzantine": 1}, 500.0), ("centered_clip", None, 1e9)],
        ids=["krum", "centered_clip"],
    )
    def test_robust_method(self, method, method_kw, attacker):
        kw = {"method": method} if method_kw is None else {"method": method, "method_kw": method_kw}

        async def main():
            vols = await spawn_volunteers(4, ByzantineAverager, min_group=4, **kw)
            try:
                return await asyncio.gather(
                    *(vols[i][3].average(make_tree(v), 1) for i, v in enumerate((1.0, 1.01, 0.99, attacker)))
                )
            finally:
                await teardown(vols)

        for r in run(main())[:3]:
            assert r is not None
            assert 0.9 < float(r["w"].mean()) < 1.1

    def test_bulyan_method_at_guarantee_scale(self):
        honest_vals = (1.0, 1.02, 0.98, 1.01, 0.99, 1.03)

        async def main():
            vols = await spawn_volunteers(
                7, ByzantineAverager, min_group=7, max_group=7, method="bulyan",
                method_kw={"n_byzantine": 1}, join_timeout=15.0, gather_timeout=20.0,
            )
            try:
                return await asyncio.gather(
                    *(vols[i][3].average(make_tree(honest_vals[i]), 1) for i in range(6)),
                    vols[6][3].average(make_tree(500.0), 1),
                )
            finally:
                await teardown(vols)

        for r in run(main())[:6]:
            assert r is not None
            assert 0.9 < float(r["w"].mean()) < 1.1


class TestIdentityGuards:
    def test_byzantine_parked_contribution_cap(self):
        async def main():
            receiver = ByzantineAverager(*await _solo_stack("recv"), mesh_codec=codec())
            receiver.MAX_PARKED_CONTRIBS = 4
            sender = Transport()
            await sender.start()
            try:
                buf = np.full(17, 1.0, np.float32).tobytes()
                for i in range(4):
                    await sender.call(receiver.transport.addr, "byz.contribute",
                                      {"epoch": "e1", "peer": f"flood-{i}", "weight": 1.0, "schema": None}, buf)
                with pytest.raises(RPCError):
                    await sender.call(receiver.transport.addr, "byz.contribute",
                                      {"epoch": "e1", "peer": "flood-4", "weight": 1.0, "schema": None}, buf)
                assert len(receiver._rounds["e1"].contribs) == 4
            finally:
                await sender.close()
                await receiver.transport.close()

        run(main())

    def test_byzantine_first_write_wins(self):
        async def main():
            receiver = ByzantineAverager(*await _solo_stack("recv"), mesh_codec=codec())
            sender = Transport()
            await sender.start()
            try:
                honest = np.full(17, 1.0, np.float32)
                forged = np.full(17, 999.0, np.float32)
                args = {"epoch": "e1", "peer": "volX", "weight": 1.0, "schema": None}
                await sender.call(receiver.transport.addr, "byz.contribute", args, honest.tobytes())
                with pytest.raises(RPCError):
                    await sender.call(receiver.transport.addr, "byz.contribute", args, forged.tobytes())
                with pytest.raises(RPCError):  # claims the receiver's own id
                    await sender.call(receiver.transport.addr, "byz.contribute", {**args, "peer": "recv"},
                                      forged.tobytes())
                assert isinstance(receiver._rounds["e1"], _Round)
                _, buf = receiver._rounds["e1"].contribs["volX"]
                assert float(buf[0]) == 1.0
            finally:
                await sender.close()
                await receiver.transport.close()

        run(main())


class TestButterflyStageCap:
    def test_parked_stage_cap_bounds_remote_allocations(self):
        async def main():
            t, dht, mem = await _solo_stack("solo")
            bf = ButterflyAverager(t, dht, mem, stage_timeout=0.3, mesh_codec=codec())
            payload = np.zeros(4, np.float32).tobytes()

            async def fire(i):
                try:
                    await bf._rpc_exchange({"epoch": f"bogus{i}", "stage": 0, "peer": "evil", "weight": 1.0},
                                           payload)
                    return "ok"
                except RPCError as e:
                    return "capped" if "cap" in str(e) else "rpc"
                except asyncio.TimeoutError:
                    return "parked"

            try:
                n_extra = 16
                results = await asyncio.gather(*(fire(i) for i in range(bf.MAX_PARKED_ROUNDS + n_extra)))
                assert results.count("capped") == n_extra, results
                assert results.count("parked") == bf.MAX_PARKED_ROUNDS
                assert len(bf._stages) <= bf.MAX_PARKED_ROUNDS
            finally:
                await t.close()

        run(main())


class TestDerivedTrimFloor:
    @pytest.mark.parametrize("cls", [ByzantineAverager, SyncAverager], ids=["byzantine", "sync"])
    def test_three_peer_group_still_trims(self, cls):
        """Derived trim 1 at n = 3 is the coordinate median: the attacker's
        row cannot move the result past the honest values (the reference's
        byzantine case, and its sync twin ``test_sync_robust_derived_trim_bounds_attacker``)."""

        async def main():
            vols = await spawn_volunteers(3, cls, min_group=3, method="trimmed_mean")
            try:
                return await asyncio.gather(
                    *(vols[i][3].average(make_tree(v), 1) for i, v in enumerate((1.0, 1.2, -900.0)))
                )
            finally:
                await teardown(vols)

        results = run(main())
        if cls is ByzantineAverager:  # no leader: every honest member commits
            assert all(r is not None for r in results[:2])
        done = [r for r in results if r is not None][:2]
        assert done
        for r in done:
            assert 0.9 < float(np.asarray(r["w"]).mean()) < 1.3, "attacker leaked"

    def test_sync_robust_small_group_does_not_crash(self):
        async def main():
            vols = await spawn_volunteers(2, SyncAverager, method="trimmed_mean")
            try:
                return await asyncio.gather(
                    vols[0][3].average(make_tree(1.0), 1), vols[1][3].average(make_tree(3.0), 1)
                )
            finally:
                await teardown(vols)

        r0, r1 = run(main())
        assert r0 is not None and r1 is not None
        np.testing.assert_allclose(np.asarray(r0["w"]), 2.0, rtol=1e-5)


# -- mixed rounds against the reference ---------------------------------------


async def _mixed(kinds, port_cls, ref_cls, wire, **kw):
    """One volunteer per entry of ``kinds`` ("port" or "ref"), in that order,
    all on one DHT."""
    vols, boot = [], None
    for i, kind in enumerate(kinds):
        if kind == "port":
            t = Transport()
            dht, mem_cls, avg_cls, cdc = DHTNode(t), SwarmMembership, port_cls, codec()
        else:
            t = JaxTransport()
            dht, mem_cls, avg_cls, cdc = JaxDHTNode(t), JaxMembership, ref_cls, jax_mc.MeshCodec(backend="host")
        await dht.start(bootstrap=[boot] if boot else None)
        boot = boot or t.addr
        mem = mem_cls(dht, f"vol{i}-{kind}", ttl=10.0)
        await mem.join()
        vols.append((t, dht, mem, avg_cls(t, dht, mem, wire=wire, mesh_codec=cdc, join_timeout=6.0,
                                          gather_timeout=8.0, **kw)))
    return vols


def _within(got, want, scale, stages):
    tol = AVG_TOL
    lim = (stages * tol["bf16_u"] + tol["f32_ulps"]) * scale + tol["floor"]
    assert np.all(np.abs(got.astype(np.float64) - want) <= lim), float(np.max(np.abs(got - want) - lim))


def _flat(tree):
    return np.concatenate([tree["w"].ravel(), tree["b"]["x"].ravel()])


def _random_tree(rng, n_w=(64, 33), n_x=(257,)):
    return {"w": rng.standard_normal(n_w).astype(np.float32), "b": {"x": rng.standard_normal(n_x).astype(np.float32)}}


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_mixed_butterfly_pair(wire):
    """A butterfly pair of one port and one reference averager: both hold the
    same result (the mix is one expression on both sides over the same
    wire-rounded pair), bit-equal on f32 to the weighted mean as numpy
    computes it and within one bf16 rounding of the exact mean on bf16."""
    rng = np.random.default_rng(3)
    trees = [_random_tree(rng), _random_tree(rng)]
    weights = (3.0, 1.0)

    async def main():
        vols = await _mixed(("port", "ref"), ButterflyAverager, jax_avg.ButterflyAverager, wire, min_group=2)
        try:
            return await asyncio.gather(*(v[3].average(trees[i], 1, weight=weights[i]) for i, v in enumerate(vols)))
        finally:
            await teardown(vols)

    results = run(main())
    got = [_flat(r) for r in results]
    assert got[0].dtype == got[1].dtype == np.float32
    assert got[0].tobytes() == got[1].tobytes()
    xs = [_flat(t) for t in trees]
    if wire == "f32":
        _, want = jax_avg.ButterflyAverager._mix(weights[0], xs[0], weights[1], xs[1])
        assert got[0].tobytes() == want.tobytes()
    else:
        want = (weights[0] * xs[0].astype(np.float64) + weights[1] * xs[1]) / sum(weights)
        _within(got[0], want, np.maximum(np.abs(xs[0]), np.abs(xs[1])), stages=1)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_mixed_byzantine_trio(wire):
    """A Byzantine trio of one port and two reference averagers, trimmed
    mean with the derived trim of 1 (the coordinate median): every member's
    result is the median of the three wire-rounded payloads, bit-equal
    across members and, on f32, to numpy's median; within one bf16 rounding
    of the exact median on bf16."""
    rng = np.random.default_rng(4)
    trees = [_random_tree(rng) for _ in range(3)]

    async def main():
        vols = await _mixed(("port", "ref", "ref"), ByzantineAverager, jax_avg.ByzantineAverager, wire, min_group=3)
        try:
            return await asyncio.gather(*(v[3].average(trees[i], 1) for i, v in enumerate(vols))), \
                vols[0][3].mesh_codec.stats()
        finally:
            await teardown(vols)

    results, port_codec = run(main())
    got = [_flat(r) for r in results]
    assert all(g.tobytes() == got[0].tobytes() for g in got)
    xs = np.stack([_flat(t) for t in trees])
    want = np.median(xs, axis=0)
    if wire == "f32":
        assert got[0].tobytes() == want.astype(np.float32).tobytes()
    else:
        _within(got[0], want.astype(np.float64), np.abs(xs).max(axis=0), stages=1)
    assert port_codec["ops_mesh"] > 0 and port_codec["ops_host"] == 0
