"""The compressed wires (q8, topk, powersgd, sign) and zone sharding on the
port, held to the reference.

The reference's own cases run on the port (``tests/torch_reference_cases.py``):
the q8, topk and sign codec classes of ``tests/test_native.py`` (their wire
cases end to end with error feedback, and sign under a robust estimator),
the topk cases of ``tests/test_averaging.py`` (scope, warmup, the degraded
round's residual) and ``tests/test_mesh_codec.py``'s ``TestPowerSGDOnMesh``
with the port's codec on CPU tensors (the device path: ``torch.linalg.qr``
and matmuls).

Parity with the JAX package, on the same buffers:

- every compressed wire's contribution bytes, error-feedback residual and
  result bytes are equal to the reference averager's, over two rounds (the
  second carries the residual and PowerSGD's warm Q); PowerSGD on the host
  backend of both codecs. The schema hash is equal for each wire.
- PowerSGD on the port's device path: the power iteration's P·Q'ᵀ and each
  round's reconstruction within relative l2 ``PSGD_DEVICE_RTOL`` of the
  reference's host path (a QR may flip a column's sign, and Q' flips with
  it, so the wire bytes may differ; P·Q'ᵀ does not);
- one mixed port/JAX sync round per wire, the port leading;
- ``shard_ranges`` and the ``ShardMap``'s HRW holders, fences and replicas
  for the same members, and a mixed zone whose port and reference shard
  holders pull each other's shards over ``shard.fetch``.

Port transports close first: the reference's close waits for its open
inbound connections (ROADMAP constraints).
"""

import asyncio

import numpy as np
import pytest
from torch_reference_cases import count_cases, device_codec, port_cases  # noqa: F401

from distributedvolunteercomputing_tpu.ops import mesh_codec as jax_mc
from distributedvolunteercomputing_tpu.swarm import averager as jax_avg
from distributedvolunteercomputing_tpu.swarm import sharding as jax_sharding
from distributedvolunteercomputing_tpu.swarm.dht import DHTNode as JaxDHTNode
from distributedvolunteercomputing_tpu.swarm.membership import SwarmMembership as JaxMembership
from distributedvolunteercomputing_tpu.swarm.transport import Transport as JaxTransport
from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
from distributedvolunteercomputing_tpu_torch.swarm import averager as port_avg
from distributedvolunteercomputing_tpu_torch.swarm import powersgd
from distributedvolunteercomputing_tpu_torch.swarm import sharding
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport

NATIVE = port_cases("test_native.py", globals(), keep=("TestQ8Codec", "TestTopkCodec", "TestSignCodec"),
                    test_modules=("test_averaging",))
lib = NATIVE["lib"]  # the reference file's fixture, on the port's native
AVERAGING = port_cases("test_averaging.py", globals(),
                       keep=("TestTopkScope", "TestTopkWarmup", "TestSyncTopkEFDegraded"))
MESH_CODEC = port_cases("test_mesh_codec.py", globals(), keep=("TestPowerSGDOnMesh",))

# PowerSGD's device path against the reference's host path: relative l2 of
# the reconstruction (f32 QR and products; numpy's LAPACK and torch's differ
# by rounding and column signs only).
PSGD_DEVICE_RTOL = 1e-5
COMPRESSED = ["q8", "topk", "sign", "powersgd"]
AVG_KW = {"join_timeout": 6.0, "gather_timeout": 8.0, "min_group": 2}


@pytest.fixture
def codec():
    """``TestPowerSGDOnMesh``'s device codec: the port's, on CPU tensors."""
    return mc.MeshCodec(device="cpu", backend="device")


@pytest.fixture
def np_rng():
    return np.random.default_rng(7)  # the reference file's seed


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


def test_reference_cases_bind_the_port():
    assert NATIVE["native"] is native
    assert AVERAGING["SyncAverager"] is port_avg.SyncAverager
    assert count_cases({k: NATIVE[k] for k in ("TestQ8Codec", "TestTopkCodec", "TestSignCodec")}) == 20
    assert count_cases({k: AVERAGING[k] for k in ("TestTopkScope", "TestTopkWarmup", "TestSyncTopkEFDegraded")}) == 6
    assert count_cases({"TestPowerSGDOnMesh": MESH_CODEC["TestPowerSGDOnMesh"]}) == 2


def grad_tree(rng, scale=1.0):
    """One matrix PowerSGD compresses, one it ships dense, one vector."""
    return {
        "w": (scale * rng.standard_normal((48, 24))).astype(np.float32),
        "v": (scale * rng.standard_normal((6, 4))).astype(np.float32),
        "b": (scale * rng.standard_normal(9)).astype(np.float32),
    }


async def _stack(pkg, peer_id, boot=None):
    t = Transport() if pkg == "port" else JaxTransport()
    dht = (DHTNode if pkg == "port" else JaxDHTNode)(t)
    await dht.start(bootstrap=[boot] if boot else None)
    mem = (SwarmMembership if pkg == "port" else JaxMembership)(dht, peer_id, ttl=10.0, extra_info={"zone": "a"})
    await mem.join()
    return t, dht, mem


async def _close(stacks):
    # Port transports first: with them gone the reference's close returns.
    for t, _, mem in sorted(stacks, key=lambda s: not isinstance(s[0], Transport)):
        try:
            await asyncio.wait_for(mem.leave(), 5)
        except Exception:
            pass
        await asyncio.wait_for(t.close(), 5)


def _averager(pkg, stack, wire, backend="host", cls="SyncAverager", **kw):
    mod = port_avg if pkg == "port" else jax_avg
    codec = mc.MeshCodec(device="cpu", backend=backend) if pkg == "port" else jax_mc.MeshCodec(backend="host")
    return getattr(mod, cls)(*stack, wire=wire, mesh_codec=codec, **{**AVG_KW, **kw})


def _two_rounds(avg, trees):
    """Contribution bytes, staged residual and result bytes of two rounds,
    the first committed (its residual banked for the second)."""
    out = []
    for tree in trees:
        buf = avg._pack(tree)
        wire, sent = avg._compress_contribution(buf)
        wire = bytes(wire)
        res = np.asarray(sent(), np.float32)
        pending = None if avg._ef_pending is None else avg._ef_pending.copy()
        avg._commit_ef(True)
        out.append({"wire": wire, "sent": res, "pending": pending, "result": bytes(avg._to_wire(buf)),
                    "schema": avg._schema})
    return out


@pytest.mark.parametrize("wire", COMPRESSED)
def test_contribution_and_result_bytes_equal_the_reference(wire):
    """q8, topk and sign through ``native`` (a byte-identical copy of the
    reference's C++) and PowerSGD through both host backends: the same bytes
    on both legs, the same residual, the same schema hash."""
    rng = np.random.default_rng(11)
    trees = [grad_tree(rng), grad_tree(rng, 2.0)]

    async def main():
        stacks = [await _stack("ref", "ref"), await _stack("port", "port")]
        try:
            kw = {"topk_frac": 0.05} if wire == "topk" else {"powersgd_rank": 3} if wire == "powersgd" else {}
            ref = _averager("ref", stacks[0], wire, **kw)
            port = _averager("port", stacks[1], wire, **kw)
            return _two_rounds(ref, trees), _two_rounds(port, trees)
        finally:
            await _close(stacks)

    ref, port = run(main())
    for r, p in zip(ref, port):
        assert r["schema"] is not None and p["schema"] == r["schema"]
        assert p["wire"] == r["wire"] and p["result"] == r["result"]
        assert p["sent"].tobytes() == r["sent"].tobytes()
        if wire == "q8":
            assert p["pending"] is None and r["pending"] is None
        else:
            assert p["pending"].tobytes() == r["pending"].tobytes()
    if wire == "sign":
        assert ref[0]["result"][:3] == port_avg._SIGN_RESULT_MAGIC == jax_avg._SIGN_RESULT_MAGIC


def _rejection_round(avg, trees):
    """One Byzantine round's estimator input and the reference's rejection
    rule, through ``avg``'s own codec paths: each tree packed, compressed and
    decoded as peers decode it (first-round semantics: no residual banked),
    the trimmed mean (trim 1) of the three rows, each row's squared distance
    to it, and the rows past 9 times the median row distance squared."""
    from distributedvolunteercomputing_tpu.swarm import health

    wires = []
    for tree in trees:
        wire, _ = avg._compress_contribution(avg._pack(tree))
        avg._commit_ef(False)
        wires.append(bytes(wire))
    stack = np.stack([avg._buf_from_payload(w) for w in wires])
    agg = avg.mesh_codec.aggregate(stack, "trimmed_mean", trim=1)
    d2 = health.row_d2(stack, agg)
    med2 = float(np.median(np.sqrt(d2))) ** 2
    return {"wires": wires, "agg": np.asarray(agg, np.float32), "d2": d2, "ratio": d2[2] / med2,
            "rejected": [int(i) for i in np.nonzero(d2 > 9.0 * med2)[0]]}


@pytest.mark.parametrize("wire,grad_scale", [("sign", 1.0), ("sign", 1.5), ("powersgd", 1.0)])
def test_rejection_rule_on_compressed_rows_matches_the_reference(wire, grad_scale):
    """Config 8's Byzantine arm in one round: two honest gradient trees and
    an attacker's, ``grad_scale`` times as large and scaled by -3
    (``DVC_CHAOS_CONTRIB_SCALE``), through a ``ByzantineAverager`` of each
    package (host codecs): the same wire bytes, aggregate, row distances and
    rejections. On the sign wire, with honest signs independent, the
    attacker's ratio to the median row distance squared is k² − k + 1 for k
    its RMS over the honest rows' (3 · ``grad_scale``): about 7 at equal
    gradient scales, under the reference's bar of 9, so neither package
    rejects it; about 17.75 at 1.5, and both do."""
    rng = np.random.default_rng(21)
    big = {"w": (48, 24), "v": (6, 4), "b": (1 << 15,)}
    trees = [{k: rng.standard_normal(s).astype(np.float32) for k, s in big.items()} for _ in range(3)]
    trees[2] = {k: (np.float32(-3.0 * grad_scale) * x).astype(np.float32) for k, x in trees[2].items()}
    kw = {"method": "trimmed_mean", "method_kw": {"trim": 1}, "cls": "ByzantineAverager"}
    kw.update({"powersgd_rank": 3} if wire == "powersgd" else {})

    async def main():
        stacks = [await _stack("ref", "ref"), await _stack("port", "port")]
        try:
            return [_rejection_round(_averager(pkg, st, wire, **kw), trees) for pkg, st in zip(("ref", "port"), stacks)]
        finally:
            await _close(stacks)

    ref, port = run(main())
    assert port["wires"] == ref["wires"]
    assert port["agg"].tobytes() == ref["agg"].tobytes()
    assert port["d2"].tobytes() == ref["d2"].tobytes() and port["rejected"] == ref["rejected"]
    if wire == "sign":
        k = 3.0 * grad_scale
        assert abs(port["ratio"] - (k * k - k + 1)) < 0.05 * (k * k - k + 1)
        assert port["rejected"] == ([] if grad_scale == 1.0 else [2])


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_powersgd_device_path_within_tolerance_of_the_reference():
    """The port's averager with its device codec on CPU tensors against the
    reference's on the host, over two warm-started rounds: each round's
    reconstruction and residual within ``PSGD_DEVICE_RTOL`` (relative l2);
    the low-rank ops counted on the device, none on the host."""
    rng = np.random.default_rng(12)
    trees = [grad_tree(rng), grad_tree(rng, 0.5)]

    async def main():
        stacks = [await _stack("ref", "ref"), await _stack("port", "port")]
        try:
            ref = _averager("ref", stacks[0], "powersgd", cls="ByzantineAverager", powersgd_rank=4)
            port = _averager("port", stacks[1], "powersgd", backend="device", cls="ByzantineAverager",
                             powersgd_rank=4)
            mc.reset_launch_counts()
            got = _two_rounds(port, trees)
            calls = dict(port.mesh_codec.stats()["launches"])
            return _two_rounds(ref, trees), got, calls
        finally:
            await _close(stacks)

    ref, port, calls = run(main())
    for r, p in zip(ref, port):
        assert p["schema"] == r["schema"]
        assert _rel_l2(p["sent"], r["sent"]) <= PSGD_DEVICE_RTOL
        assert _rel_l2(p["pending"], r["pending"]) <= PSGD_DEVICE_RTOL
        # Results ship dense: byte-equal on both paths.
        assert p["result"] == r["result"]
        # The container's layout is the reference's: the same entries and
        # sizes, only the factors' values may differ.
        assert len(p["wire"]) == len(r["wire"])
    # One planned matrix ("w"), two rounds: an iteration and the own
    # round trip's reconstruction each.
    assert calls["low_rank_iterate"] == 2 and calls["lowrank_reconstruct"] == 2


def test_low_rank_ops_on_the_device_match_the_host():
    """``MeshCodec.low_rank_iterate`` and ``lowrank_reconstruct``: the device
    path's P is orthonormal and P·Q'ᵀ equals the host path's (numpy, the
    reference's text) within ``PSGD_DEVICE_RTOL``; Q' equals the host's up to
    each column's sign. Host calls are not counted as device calls, and each
    codec counts its own device calls."""
    rng = np.random.default_rng(13)
    mat = rng.standard_normal((96, 40)).astype(np.float32)
    q = rng.standard_normal((40, 4)).astype(np.float32)
    dev, host = mc.MeshCodec(device="cpu", backend="device"), mc.MeshCodec(device="cpu", backend="host")
    ref = jax_mc.MeshCodec(backend="host")
    mc.reset_launch_counts()
    p_d, q_d = dev.low_rank_iterate(mat, q)
    p_h, q_h = host.low_rank_iterate(mat, q)
    p_r, q_r = ref.low_rank_iterate(mat, q)
    assert p_h.tobytes() == p_r.tobytes() and q_h.tobytes() == q_r.tobytes()
    assert p_d.dtype == q_d.dtype == np.float32 and p_d.shape == (96, 4) and q_d.shape == (40, 4)
    np.testing.assert_allclose(p_d.T @ p_d, np.eye(4), atol=1e-5)
    signs = np.sign(np.sum(p_d * p_r, axis=0))
    assert _rel_l2(q_d * signs, q_r) <= PSGD_DEVICE_RTOL
    assert _rel_l2(p_d @ q_d.T, p_r @ q_r.T) <= PSGD_DEVICE_RTOL
    rec = dev.lowrank_reconstruct(p_r, q_r)
    assert _rel_l2(rec, ref.lowrank_reconstruct(p_r, q_r)) <= PSGD_DEVICE_RTOL
    assert host.lowrank_reconstruct(p_r, q_r).tobytes() == (p_r @ q_r.T).ravel().tobytes()
    assert mc.LOW_RANK_CALLS == {"low_rank_iterate": 1, "lowrank_reconstruct": 1}
    assert dev.low_rank_calls == mc.LOW_RANK_CALLS and host.low_rank_calls == {"low_rank_iterate": 0,
                                                                              "lowrank_reconstruct": 0}
    assert dev.stats()["launches"]["low_rank_iterate"] == 1
    dev.inject_failure()
    with pytest.raises(mc.MeshCodecError):
        dev.low_rank_iterate(mat, q)  # no host fallback
    assert mc.LOW_RANK_CALLS["low_rank_iterate"] == dev.low_rank_calls["low_rank_iterate"] == 1


def _decoded(wire, buf, **kw):
    """A contribution as every peer decodes it (no residual yet)."""
    if wire == "q8":
        return native.q8_decode(native.q8_encode(buf))
    if wire == "topk":
        return native.topk_decode(native.topk_encode(buf, frac=kw["topk_frac"]), max_floats=buf.size)
    if wire == "sign":
        return native.sign_decode(native.sign_encode(buf), max_floats=buf.size)
    return powersgd.decode(powersgd.PowerSGDCodec(kw["specs"], rank=kw["powersgd_rank"]).encode(buf))


@pytest.mark.parametrize("wire", COMPRESSED)
def test_mixed_sync_round_with_the_reference(wire):
    """One reference SyncAverager and one port SyncAverager (device codec on
    CPU tensors) average a gradient tree on each compressed wire; the port
    leads. Both results are the weighted mean of the contributions as peers
    decode them, within the result leg's own rounding: q8 (and sign's q8
    result leg) one step of 1/127 of a chunk's largest magnitude; topk an
    exact dense result (f32 rounding of the fold); powersgd within
    ``PSGD_DEVICE_RTOL`` (relative l2), since the port's contribution and
    its reconstructions run on the device path."""
    from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

    rng = np.random.default_rng(21)
    trees = [grad_tree(rng), grad_tree(rng, 3.0)]
    weights = (1.0, 3.0)
    kw = {"topk_frac": 0.25} if wire == "topk" else {"powersgd_rank": 4} if wire == "powersgd" else {}

    async def main():
        ref_stack = await _stack("ref", "vol-ref")
        port_stack = await _stack("port", "vol-a-port", boot=ref_stack[0].addr)
        try:
            ref = _averager("ref", ref_stack, wire, **kw)
            port = _averager("port", port_stack, wire, backend="device", **kw)
            results = await asyncio.gather(
                ref.average(trees[0], 1, weight=weights[0]),
                port.average(trees[1], 1, weight=weights[1]),
            )
            return results, port.stats(), (ref._schema, port._schema)
        finally:
            await _close([port_stack, ref_stack])

    results, port_stats, schemas = run(main())
    assert schemas[0] == schemas[1] is not None
    assert port_stats["rounds_ok"] == 1
    bufs = [flatten_to_buffer(t)[0] for t in trees]
    specs = flatten_to_buffer(trees[0])[1]
    dec = [_decoded(wire, b, specs=specs, **kw).astype(np.float64) for b in bufs]
    want = (weights[0] * dec[0] + weights[1] * dec[1]) / sum(weights)
    got = [flatten_to_buffer(r)[0] for r in results]
    if wire == "powersgd":
        for g in got:
            assert _rel_l2(g, want) <= PSGD_DEVICE_RTOL
        return
    tol = np.abs(want).max() / 127.0 + 1e-6 if wire in ("q8", "sign") else 4 * 2.0**-24 * np.abs(want).max() + 1e-7
    for g in got:
        assert np.abs(g - want).max() <= tol


@pytest.mark.parametrize("n,k", [(0, 1), (10, 3), (1000, 4), (124_439_808, 2), (7, 7)])
def test_shard_ranges_equal_the_reference(n, k):
    assert sharding.shard_ranges(n, k) == jax_sharding.shard_ranges(n, k)


@pytest.mark.parametrize("members,k", [(("a",), 2), (("a", "b"), 2), (("v0", "v1", "v2", "v3"), 4),
                                       (tuple(f"vol-{i:02d}" for i in range(9)), 3)])
def test_shard_map_holders_equal_the_reference(members, k):
    for gen, domain in ((0, "a|gpt2_small/params"), (3, "zone-b|ns")):
        port = sharding.ShardMap(members=members, k=k, gen=gen, domain=domain)
        ref = jax_sharding.ShardMap(members=members, k=k, gen=gen, domain=domain)
        assert port.fence == ref.fence
        for s in range(k):
            assert port.ranking(s) == ref.ranking(s)
            assert (port.holder_of(s), port.replica_of(s)) == (ref.holder_of(s), ref.replica_of(s))
        for pid in members:
            assert port.shards_of(pid) == ref.shards_of(pid)
            assert port.primary_shard_of(pid) == ref.primary_shard_of(pid)


def _split_pair(domain):
    for t in range(4000):
        a, b = f"a{t:03d}", f"b{t:03d}"
        m = sharding.ShardMap(members=(a, b), k=2, gen=0, domain=domain)
        if m.shards_of(a) == [0] and m.shards_of(b) == [1]:
            return a, b
    raise AssertionError("no balanced pair")


def test_mixed_zone_holders_serve_each_other():
    """A zone of one reference and one port shard holder (K = 2): both adopt
    the same fenced map, and each pulls the other's shard as its runner-up
    replica over ``shard.fetch``, bit for bit."""
    ns, n = "mixed/grads", 1000
    a, b = _split_pair(f"a|{ns}")
    base = np.random.default_rng(4).standard_normal(n).astype(np.float32)

    async def main():
        ref_stack = await _stack("ref", a)
        port_stack = await _stack("port", b, boot=ref_stack[0].addr)
        try:
            sms = []
            for mod, (t, dht, mem) in ((jax_sharding, ref_stack), (sharding, port_stack)):
                sm = mod.ShardManager(t, dht, mem, mem.peer_id, n_elems=n, k=2, namespace=ns, zone="a")
                await sm.reshard(members=[a, b], recover=False)
                for s in sm.owned():
                    sm.store.put(s, mod.shard_slice(base, sm.ranges, s).copy())
                sms.append(sm)
            for _, _, mem in (ref_stack, port_stack):
                await mem.alive_peers(include_self=True)
            got = [await sm.refresh_replicas() for sm in sms]
            held = [{s: sm.store.get(s).copy() for s in range(2)} for sm in sms]
            return [sm.map.fence for sm in sms], [sm.owned() for sm in sms], got, held
        finally:
            await _close([port_stack, ref_stack])

    fences, owned, got, held = run(main())
    assert fences[0] == fences[1] and owned == [[0], [1]]
    assert got == [[1], [0]]
    ranges = sharding.shard_ranges(n, 2)
    for h in held:
        for s, (lo, hi) in enumerate(ranges):
            assert h[s].tobytes() == base[lo:hi].tobytes()
