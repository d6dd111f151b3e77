"""Zoned group schedules and leader failover on the port against the JAX
package, on identical inputs.

- ``GroupSchedule.assign``: the reference's and the port's schedule give the
  same assignment for the same ids, zones, rotation and ``cross_zone_every_k``,
  on intra and cross rotations alike.
- One mixed two-zone swarm: two reference and two port ``SyncAverager``s on
  localhost, zones ``a`` and ``b`` each holding one of each, groups of 2,
  ``cross_zone_every_k`` 2, through one intra rotation and one cross rotation.
  Every member averages with the group the schedule gives it; on the f32 wire
  each result is the dense weighted mean of its group to within ``F32_RTOL``
  of the group's inputs' scale (not bit-equal: see ``F32_RTOL``), on the
  bf16 wire within ``AVG_TOL``; on the intra
  rotation no averaging byte crosses a zone, and ``zone_traffic()`` shows no
  cross-zone byte at all.
- One mixed failover round: a port leader killed at ``mid_stream`` through
  ``_phase_hooks``; the port member and the reference member recover the
  round, whose result is the weighted mean of the survivors' pushes within
  the reference's failover tolerance (``tests/test_failover.py``, rtol 1e-6),
  taken on the inputs' scale as on the f32 wire above.

Port averagers run the device codec on CPU tensors (the plain versions of K4
and K5); reference averagers the host codec. Port peer ids sort first, so a
port averager leads every mixed group (the reference's sync leader can skip a
round on a late inline push: ROADMAP Queue 3), and port transports close
first (the reference's close waits for its open inbound connections).
"""

import asyncio
import dataclasses
import itertools

import numpy as np
import pytest

from distributedvolunteercomputing_tpu.ops import mesh_codec as jax_mc
from distributedvolunteercomputing_tpu.swarm import averager as jax_avg
from distributedvolunteercomputing_tpu.swarm.dht import DHTNode as JaxDHTNode
from distributedvolunteercomputing_tpu.swarm.matchmaking import GroupSchedule as JaxGroupSchedule
from distributedvolunteercomputing_tpu.swarm.membership import SwarmMembership as JaxMembership
from distributedvolunteercomputing_tpu.swarm.transport import Transport as JaxTransport
from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.matchmaking import GroupSchedule
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport

AVG_TOL = {"bf16_u": 2.0**-8, "f32_ulps": 4 * 2.0**-24, "floor": 2.0**-126}
# The f32 wire is not bit-equal to numpy's dense weighted mean: the port's
# leader folds each contribution with torch's ``add_(x, alpha=w)``, which on
# the CPU fuses w·x + acc into one rounding, in arrival order, then scales by
# 1/Σw; numpy rounds w·x and the sum apart. The two differ by an f32 rounding
# of the sum, which is up to ~1e-7 of the inputs' scale (and far more of an
# element whose two terms cancel): the bound is on the inputs' scale.
F32_RTOL = 1e-6
ZONES = {"p0": "a", "r0": "a", "p1": "b", "r1": "b"}  # "p" (port) sorts before "r" (reference)
K = 2
N = 20_000  # 80 KB of f32: several 64 KiB wire chunks, so pushes stream


def run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    assert native.ensure_built()


# -- the schedule ----------------------------------------------------------------


def _fields(asg):
    return None if asg is None else dataclasses.asdict(asg)


@pytest.mark.parametrize("k", [0, 2, 3])
@pytest.mark.parametrize("target", [2, 3])
def test_group_schedule_assign_matches_reference(k, target):
    ids = [f"v{i}" for i in range(9)] + ["lone"]
    zones = {pid: ("dc", "home", "")[i % 3] for i, pid in enumerate(ids)}
    zones["lone"] = "edge"  # a singleton zone
    levels = set()
    for rot in range(12):
        for view in (ids, ids[:5]):
            ref = JaxGroupSchedule(target_size=target, min_size=2, cross_zone_every_k=k)
            port = GroupSchedule(target_size=target, min_size=2, cross_zone_every_k=k)
            for pid in view:
                want = _fields(ref.assign(view, pid, rot=rot, zones=zones))
                got = _fields(port.assign(view, pid, rot=rot, zones=zones))
                assert got == want, (rot, pid)
                levels.add(None if want is None else want["level"])
            # Without zone advertisements the grid is flat.
            assert _fields(port.assign(view, view[0], rot=rot)) == _fields(ref.assign(view, view[0], rot=rot))
    assert levels >= ({"intra", "cross"} if k else {"flat"})


# -- one mixed two-zone swarm ------------------------------------------------------


def _pinned(cls, rot_cell):
    return cls(target_size=2, rotation_s=1000.0, min_size=2, cross_zone_every_k=K,
               clock=lambda: rot_cell["rot"] * 1000.0 + 0.5)


def _mixed_rotations():
    """An intra rotation and a cross rotation whose groups each pair a port
    averager with a reference one (so a port averager leads each)."""
    sched = GroupSchedule(target_size=2, min_size=2, cross_zone_every_k=K)
    ids = sorted(ZONES)

    def groups(rot):
        return {tuple(sched.assign(ids, pid, rot=rot, zones=ZONES).members) for pid in ids}

    def mixed(rot):
        return all(sorted(p[0] for p in g) == ["p", "r"] for g in groups(rot))

    intra = next(r for r in itertools.count(1) if r % K and mixed(r))
    cross = next(r for r in itertools.count(K, K) if mixed(r))
    return intra, cross, sched


async def _zoned_swarm(wire, rot_cell):
    vols, boot = [], None
    for pid in sorted(ZONES):
        port = pid.startswith("p")
        if port:
            t = Transport()
            dht, mem_cls, avg_cls, sched_cls = DHTNode(t), SwarmMembership, SyncAverager, GroupSchedule
            codec = mc.MeshCodec(device="cpu", backend="device")
        else:
            t = JaxTransport()
            dht, mem_cls, avg_cls, sched_cls = JaxDHTNode(t), JaxMembership, jax_avg.SyncAverager, JaxGroupSchedule
            codec = jax_mc.MeshCodec(backend="host")
        await dht.start(bootstrap=[boot] if boot else None)
        boot = boot or t.addr
        mem = mem_cls(dht, pid, ttl=30.0, extra_info={"zone": ZONES[pid]})
        await mem.join()
        avg = avg_cls(t, dht, mem, wire=wire, mesh_codec=codec, join_timeout=6.0, gather_timeout=8.0,
                      min_group=2, max_group=6, group_schedule=_pinned(sched_cls, rot_cell))
        vols.append({"pid": pid, "t": t, "dht": dht, "mem": mem, "avg": avg, "port": port})
    for v in vols:  # every snapshot sees the whole swarm and its zones
        await v["mem"].alive_peers()
    return vols


async def _teardown(vols):
    from distributedvolunteercomputing_tpu.swarm.transport import _Conn

    # Drop the reference nodes' client pools (two reference nodes each wait
    # for the other's connection otherwise), then close the port first.
    for v in vols:
        if not v["port"]:
            for entry in list(v["t"]._conns.values()):
                entry.close() if isinstance(entry, _Conn) else entry.cancel()
            v["t"]._conns.clear()
    await asyncio.sleep(0.05)
    for v in sorted(vols, key=lambda v: not v["port"]):
        try:
            await asyncio.wait_for(v["mem"].leave(), 5)
        except Exception:
            pass
        await asyncio.wait_for(v["t"].close(), 5)


def _sync_bytes_by_zone(vol):
    """Wrap ``vol``'s transport so the request and response payload bytes of
    its ``sync.*`` calls are summed by the destination's zone locality."""
    t, mine, seen = vol["t"], ZONES[vol["pid"]], {"cross": 0, "intra": 0}
    call = t.call

    async def counting(addr, method, args=None, payload=b"", *a, **kw):
        out = await call(addr, method, args, payload, *a, **kw)
        if method.startswith("sync."):
            zmap = vol["mem"].zone_by_addr()
            side = "intra" if zmap.get((str(addr[0]), int(addr[1]))) == mine else "cross"
            reply = out[1] if isinstance(out, tuple) and len(out) == 2 else b""
            seen[side] += len(payload or b"") + len(reply or b"")
        return out

    t.call = counting
    return seen


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_mixed_two_zone_swarm(wire):
    intra, cross, sched = _mixed_rotations()
    rng = np.random.default_rng(11)
    ids = sorted(ZONES)
    trees = {pid: {"w": rng.standard_normal(N).astype(np.float32)} for pid in ids}
    weights = {"p0": 1.0, "p1": 3.0, "r0": 2.0, "r1": 5.0}
    rot_cell = {"rot": 0}

    async def main():
        vols = await _zoned_swarm(wire, rot_cell)
        try:
            seen = {v["pid"]: _sync_bytes_by_zone(v) for v in vols}
            out = {}
            for rot in (intra, cross):
                rot_cell["rot"] = rot
                before = {v["pid"]: v["avg"].zone_traffic() for v in vols}
                counted = {pid: dict(s) for pid, s in seen.items()}
                results = await asyncio.gather(*(
                    v["avg"].average(trees[v["pid"]], round_no=rot, weight=weights[v["pid"]]) for v in vols
                ))
                after = {v["pid"]: v["avg"].zone_traffic() for v in vols}
                out[rot] = {
                    "results": dict(zip(ids, results)),
                    "group_ids": {v["pid"]: v["avg"].group_stats()["group_id"] for v in vols},
                    "sync_cross": {pid: seen[pid]["cross"] - counted[pid]["cross"] for pid in ids},
                    "sync_intra": {pid: seen[pid]["intra"] - counted[pid]["intra"] for pid in ids},
                    "cross_bytes": {pid: sum(after[pid][f"cross_zone_bytes_{d}"] - before[pid][f"cross_zone_bytes_{d}"]
                                             for d in ("sent", "received")) for pid in ids},
                }
            return out
        finally:
            await _teardown(vols)

    out = run(main())
    for rot, level in ((intra, "intra"), (cross, "cross")):
        rec = out[rot]
        for pid in ids:
            asg = sched.assign(ids, pid, rot=rot, zones=ZONES)
            assert asg.level == level and rec["group_ids"][pid] == asg.group_id, (rot, pid, rec["group_ids"])
            group = asg.members
            assert len(group) == 2 and (len({ZONES[g] for g in group}) == 1) == (level == "intra")
            got = rec["results"][pid]
            assert got is not None, f"{pid} skipped rotation {rot}"
            got = np.asarray(got["w"])
            xs = [trees[g]["w"].astype(np.float64) for g in group]
            ws = [weights[g] for g in group]
            want = sum(w * x for w, x in zip(ws, xs)) / sum(ws)
            scale = np.maximum(np.abs(xs[0]), np.abs(xs[1]))
            if wire == "f32":
                assert np.all(np.abs(got - want) <= F32_RTOL * scale), (rot, pid)
            else:
                # Two roundings: the pushes' and, for a member, the result's.
                lim = (2 * AVG_TOL["bf16_u"] + AVG_TOL["f32_ulps"]) * scale + AVG_TOL["floor"]
                assert np.all(np.abs(got - want) <= lim), (rot, pid)
        payload = N * (4 if wire == "f32" else 2)
        if level == "intra":
            assert all(v == 0 for v in rec["sync_cross"].values()), rec["sync_cross"]
            assert all(v == 0 for v in rec["cross_bytes"].values()), rec["cross_bytes"]
            assert sum(rec["sync_intra"].values()) >= 2 * payload
        else:
            assert sum(rec["sync_cross"].values()) >= 2 * payload, rec["sync_cross"]


# -- one mixed failover round ---------------------------------------------------


def test_mixed_failover_round_recovers_on_the_survivors():
    rng = np.random.default_rng(12)
    kinds = {"p0": "port", "p1": "port", "r2": "ref"}  # p0 leads; p1 succeeds it
    trees = {pid: {"w": rng.standard_normal(4096).astype(np.float32)} for pid in kinds}
    weights = {"p0": 1.0, "p1": 2.0, "r2": 3.0}

    async def main():
        vols, boot = [], None
        for pid, kind in kinds.items():
            if kind == "port":
                t = Transport()
                dht, mem_cls, avg_cls = DHTNode(t), SwarmMembership, SyncAverager
                codec = mc.MeshCodec(device="cpu", backend="device")
            else:
                t = JaxTransport()
                dht, mem_cls, avg_cls = JaxDHTNode(t), JaxMembership, jax_avg.SyncAverager
                codec = jax_mc.MeshCodec(backend="host")
            await dht.start(bootstrap=[boot] if boot else None)
            boot = boot or t.addr
            mem = mem_cls(dht, pid, ttl=10.0)
            await mem.join()
            avg = avg_cls(t, dht, mem, mesh_codec=codec, join_timeout=6.0, gather_timeout=8.0, min_group=2)
            vols.append({"pid": pid, "t": t, "dht": dht, "mem": mem, "avg": avg, "port": kind == "port"})
        leader = vols[0]

        async def die():
            await leader["t"].close()
            raise RuntimeError("chaos: leader killed")

        leader["avg"]._phase_hooks["mid_stream"] = die
        try:
            results = await asyncio.gather(*(
                v["avg"].average(trees[v["pid"]], round_no=1, weight=weights[v["pid"]]) for v in vols
            ), return_exceptions=True)
            return results, [v["avg"].failover_stats() for v in vols]
        finally:
            await _teardown(vols)

    results, stats = run(main())
    assert isinstance(results[0], RuntimeError)
    want = (2.0 * trees["p1"]["w"].astype(np.float64) + 3.0 * trees["r2"]["w"]) / 5.0
    # The reference's rtol 1e-6, on the inputs' scale (random inputs cancel: F32_RTOL).
    scale = np.maximum(np.abs(trees["p1"]["w"]), np.abs(trees["r2"]["w"]))
    for i in (1, 2):
        r = results[i]
        assert r is not None and not isinstance(r, BaseException), f"survivor {i}: {r!r}"
        assert np.all(np.abs(np.asarray(r["w"]) - want) <= F32_RTOL * scale), f"survivor {i}"
        assert stats[i]["leaders_deposed"] == 1 and stats[i]["rounds_recovered"] == 1
