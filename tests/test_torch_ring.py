"""The port's ring fold (``ops/mesh_collective.py``) against the JAX package's.

The reference's Pallas ring kernels do not run in interpret mode under the
installed jax (``pl.load`` / ``pl.store`` are gone), so the port is held
against the three folds of the reference that do run on its 8 virtual CPU
devices: the xla-lowered ``RingMeanFolder`` (pallas off: an ``all_to_all`` of
the raw bits, then a column fold, the same function as K6), the staged
``MeshMeanFolder`` on the same mesh, and ``native``'s host fold. The port's
ranks are CPU devices, so its kernel wrappers take their plain versions.
Limits: rtol 1e-5 / atol 1e-6, the reference's own for its ring
(``tests/test_mesh_collective.py``); the ring adds in ring order, the others
in batch order. K7's plain all-gather is bit-equal to the reference's.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu import native as jax_native
from distributedvolunteercomputing_tpu.ops import mesh_codec as jax_mc
from distributedvolunteercomputing_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
from distributedvolunteercomputing_tpu_torch.ops import mesh_collective as mcol
from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh
from distributedvolunteercomputing_tpu_torch.swarm.agg_stream import StreamingAggregator, TilePool
from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport

RTOL, ATOL = 1e-5, 1e-6
CONFIGS = [(2048, 4, 8000), (1024, 3, 3010), (512, 7, 3500)]  # (tile, n_tiles, n_elems): ragged tails
WEIGHTS = [0.5, 1.75, 0.0, 2.25, 1.0]


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    assert native.ensure_built() and jax_native.ensure_built()


def port_codec(nd, collective="ring"):
    return mc.MeshCodec(backend="device", mesh=make_mesh(dp=nd, devices=["cpu"] * nd), collective=collective)


def ref_codec(nd, collective="ring"):
    return jax_mc.MeshCodec(mesh=jax_make_mesh(dp=nd), backend="mesh", pallas="off", collective=collective)


def host_ref(bufs, weights, n_elems):
    ref = np.zeros(n_elems, np.float32)
    for buf, w in zip(bufs, weights):
        native.weighted_sum_inplace(ref, native.bf16_to_f32(native.f32_to_bf16(buf)), float(w))
    return ref


def feed(folder, bufs, weights, tile, n_elems):
    for buf, w in zip(bufs, weights):
        bits = native.f32_to_bf16(buf)
        for e0 in range(0, n_elems, tile):
            if folder.add(e0 // tile, float(w), bits[e0 : e0 + tile].tobytes()):
                folder.flush()


@pytest.mark.parametrize("nd", [2, 8])
@pytest.mark.parametrize("tile,n_tiles,n_elems", CONFIGS)
def test_ring_matches_reference_folds(nd, tile, n_tiles, n_elems):
    rng = np.random.default_rng(18)
    bufs = rng.standard_normal((5, n_elems)).astype(np.float32)
    port = port_codec(nd).mean_folder(n_elems, tile, n_tiles, "bf16")
    assert port.kind == "ring"
    port.flush_bytes = 3 * tile * 2  # several flushes: later ones add into a live accumulator
    ring = ref_codec(nd).mean_folder(n_elems, tile, n_tiles, "bf16")
    assert ring.kind == "ring" and ring._lower_cfg == "xla"
    staged = ref_codec(nd, "off").mean_folder(n_elems, tile, n_tiles, "bf16")
    assert staged.kind == "staged"
    for folder in (port, ring, staged):
        feed(folder, bufs, WEIGHTS, tile, n_elems)
    got = port.result()
    assert port.ring_flushes == port.flushes >= 3 and port.codec.stats()["ring_results"] == 1
    np.testing.assert_allclose(got, ring.result(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, staged.result(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, host_ref(bufs, WEIGHTS, n_elems), rtol=RTOL, atol=ATOL)


def test_dense_feeds_and_one_big_batch():
    """A flush whose tiles repeat within and across ranks (one batch of
    every chunk), then a dense feed, against the reference's staged folder
    and the host fold."""
    rng = np.random.default_rng(3)
    tile, n_tiles, n_elems = 2048, 4, 8000
    bufs = rng.standard_normal((5, n_elems)).astype(np.float32)
    dense = rng.standard_normal(n_elems).astype(np.float32)
    port = port_codec(2).mean_folder(n_elems, tile, n_tiles, "bf16")
    staged = ref_codec(2, "off").mean_folder(n_elems, tile, n_tiles, "bf16")
    for folder in (port, staged):
        folder.flush_bytes = 1 << 30
        feed(folder, bufs, WEIGHTS, tile, n_elems)
        folder.flush()
        folder.add_dense(dense, 1.5)
    ref = host_ref(bufs, WEIGHTS, n_elems)
    native.weighted_sum_inplace(ref, dense, 1.5)
    got = port.result()
    assert port.ring_flushes == 1
    np.testing.assert_allclose(got, staged.result(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


class TestFolderSelection:
    """Ported from the reference's ``TestFolderSelection``, plus the port's
    ``auto`` rule: ring only with two or more CUDA ranks."""

    def test_one_device_falls_back_to_staged(self):
        c = mc.MeshCodec(device="cpu", backend="device", collective="ring")
        assert c.mean_folder(8192, 2048, 4, "bf16").kind == "staged"
        assert not mcol.ring_available(c)

    def test_two_devices_select_ring(self):
        c = port_codec(2)
        assert c.mean_folder(8192, 2048, 4, "bf16").kind == "ring"
        assert c.stats()["collective"] == "ring" and c.stats()["devices"] == 2 and mcol.ring_available(c)
        assert ref_codec(2).mean_folder(8192, 2048, 4, "bf16").kind == "ring"

    def test_f32_wire_stays_staged(self):
        assert port_codec(2).mean_folder(8192, 2048, 4, "f32").kind == "staged"

    def test_collective_off_and_cpu_auto_stay_staged(self):
        assert port_codec(2, "off").mean_folder(8192, 2048, 4, "bf16").kind == "staged"
        auto = port_codec(2, "auto")
        assert auto.collective == "off" and auto.mean_folder(8192, 2048, 4, "bf16").kind == "staged"

    def test_indivisible_tile_has_no_folder(self):
        assert port_codec(8).mean_folder(8188, 2047, 4, "bf16") is None
        with pytest.raises(ValueError, match="split"):
            mcol.RingMeanFolder(port_codec(8), 8188, 2047, 4, "bf16")
        with pytest.raises(ValueError, match="bf16"):
            mcol.RingMeanFolder(port_codec(2), 8192, 2048, 4, "f32")
        with pytest.raises(ValueError, match="collective"):
            port_codec(2, "xla")


def test_nan_propagates_like_the_host_fold():
    rng = np.random.default_rng(18)
    tile, n_tiles, n_elems = 1024, 4, 4096
    bufs = rng.standard_normal((3, n_elems)).astype(np.float32)
    bufs[1, 100:200] = np.nan
    ws = [1.0, 1.0, 0.5]
    want = host_ref(bufs, ws, n_elems)
    for folder in (port_codec(2).mean_folder(n_elems, tile, n_tiles, "bf16"),
                   ref_codec(2).mean_folder(n_elems, tile, n_tiles, "bf16")):
        feed(folder, bufs, ws, tile, n_elems)
        got = folder.result()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nd", [2, 8])
def test_short_tail_chunk_pads_with_zeros(nd):
    rng = np.random.default_rng(4)
    tile, n_tiles, n_elems = 1024, 2, 1030  # the tail chunk holds 6 elements
    bufs = rng.standard_normal((2, n_elems)).astype(np.float32)
    port = port_codec(nd).mean_folder(n_elems, tile, n_tiles, "bf16")
    ring = ref_codec(nd).mean_folder(n_elems, tile, n_tiles, "bf16")
    for folder in (port, ring):
        feed(folder, bufs, [1.0, 3.0], tile, n_elems)
    got = port.result()
    np.testing.assert_allclose(got, ring.result(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, host_ref(bufs, [1.0, 3.0], n_elems), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nd", [2, 8])
def test_allgather_plain_matches_reference_gather(nd):
    """K7's plain version against the reference ring folder's own gather of
    the same element-split accumulator (``all_gather`` over the codec axis):
    bit-equal on every rank."""
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(5)
    tile, n_tiles = 1024, 3
    acc = rng.standard_normal((n_tiles, tile)).astype(np.float32)
    acc[0, :4] = [np.nan, np.inf, -0.0, 1e-40]
    ref = ref_codec(nd).mean_folder(n_tiles * tile, tile, n_tiles, "bf16")
    sharded = jax.device_put(acc, ref.codec._sharding(P(None, "codec")))
    want = np.asarray(ref._build_gather()(sharded))
    shard = tile // nd
    accs = [torch.from_numpy(acc[:, r * shard : (r + 1) * shard].copy()) for r in range(nd)]
    outs = mcol.ring_allgather(accs)  # CPU tensors: the plain version
    assert len(outs) == nd
    for out in outs:
        assert np.array_equal(out.numpy().view(np.int32), want.view(np.int32))
    assert np.array_equal(np.asarray(sharded).view(np.int32), acc.view(np.int32))


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    before = dict(mcol.LAUNCHES)
    accs = [torch.zeros(2, 8), torch.zeros(2, 8)]
    bits = [torch.zeros(1, 16, dtype=torch.int16), torch.zeros(0, 16, dtype=torch.int16)]
    mcol.ring_fold(accs, bits, [[1], []], [[1.0], []], mcol.RingPartials())
    mcol.ring_allgather(accs)
    assert mcol.LAUNCHES == before  # plain versions: nothing launched
    meta = [torch.zeros(2, 8, device="meta")] * 2
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mcol.ring_allgather(meta)
    with pytest.raises(ValueError, match="2 ranks"):
        mcol.ring_allgather(accs[:1])
    with pytest.raises(ValueError, match="tile index"):
        mcol.ring_fold(accs, bits, [[2], []], [[1.0], []], mcol.RingPartials())
    # The flush's slot layout: distinct tiles, each rank's chunks by slot.
    uniq, metas = mcol.ring_slots([[5, 2, 5], [2]], [[1.0, 2.0, 3.0], [4.0]], 8)
    assert uniq == [2, 5]
    np.testing.assert_array_equal(metas[0][:3 + 3 + 2], [0, 1, 3, 1, 0, 2, 2, 5])
    np.testing.assert_array_equal(metas[0][8:].view(np.float32), [1.0, 2.0, 3.0])


def test_streaming_round_with_ring_matches_host():
    """The copied StreamingAggregator with the ring folder underneath, against
    the host codec (ported from the reference's ``TestAggregatorParity``)."""
    rng = np.random.default_rng(6)
    n_peers, n_elems, chunk = 4, 24000, 1 << 14
    bufs = rng.standard_normal((n_peers, n_elems)).astype(np.float32)
    ws = rng.uniform(0.5, 2.0, n_peers)

    async def one(codec):
        peers = [f"p{i}" for i in range(n_peers)]
        agg = StreamingAggregator(n_elems, peers, "mean", "bf16", chunk, kw_fn=lambda n: {}, pool=TilePool(),
                                  codec=codec)
        wires = [native.f32_to_bf16(bufs[p]).tobytes() for p in range(n_peers)]
        sinks = [agg.make_sink(peers[p], float(ws[p]), n_elems * 2) for p in range(n_peers)]
        for off in range(0, n_elems * 2, chunk):
            for p in range(n_peers):
                sinks[p](off, n_elems * 2, wires[p][off : off + chunk])
            await asyncio.sleep(0)
        for s in sinks:
            s.close(True)
        return await agg.finalize(peers), agg.gauges()

    ring_out, ring_g = asyncio.run(asyncio.wait_for(one(port_codec(2)), 60))
    host_out, host_g = asyncio.run(asyncio.wait_for(one(mc.MeshCodec(device="cpu", backend="host")), 60))
    np.testing.assert_allclose(ring_out, host_out, rtol=2e-5, atol=1e-5)
    assert ring_g["folder_kind"] == "ring" and ring_g["ring_flushes"] >= 1
    assert host_g["folder_kind"] in ("", "staged")


def test_failure_fails_the_round_and_keeps_local_state():
    """An injected failure on a ring codec raises out of the flush and the
    result (no host replay); in a sync round it fails the round on both
    peers with their inputs unchanged, and the next round commits through
    the ring folder. Replaces the reference's degrade tests."""
    codec = port_codec(2)
    folder = codec.mean_folder(4096, 1024, 4, "bf16")
    bits = native.f32_to_bf16(np.ones(4096, np.float32))
    folder.add(0, 1.0, bits[:1024].tobytes())
    codec.inject_failure()
    with pytest.raises(mc.MeshCodecError, match="injected"):
        folder.flush()
    folder.add(1, 1.0, bits[:1024].tobytes())
    codec.inject_failure()
    with pytest.raises(mc.MeshCodecError, match="injected"):
        folder.result()
    assert codec.stats()["backend"] == "device" and codec.stats()["ops_host"] == 0

    kw = {"join_timeout": 6.0, "gather_timeout": 8.0, "min_group": 2, "wire": "bf16"}

    async def node(peer_id, boot=None):
        t = Transport()
        dht = DHTNode(t)
        await dht.start(bootstrap=[boot] if boot else None)
        mem = SwarmMembership(dht, peer_id, ttl=10.0)
        await mem.join()
        return t, mem, SyncAverager(t, dht, mem, mesh_codec=port_codec(2), **kw)

    def tree(v):
        return {"w": np.full((4, 3), v, np.float32)}

    async def main():
        a = await node("vol0")
        b = await node("vol1", boot=a[0].addr)
        try:
            a[2].mesh_codec.inject_failure(10**6)  # every device op of the leader's round
            trees = tree(0.0), tree(4.0)
            failed = await asyncio.gather(a[2].average(trees[0], 1, weight=1.0), b[2].average(trees[1], 1, weight=1.0),
                                          return_exceptions=True)
            a[2].mesh_codec._fail_injected = 0
            ok = await asyncio.gather(a[2].average(tree(0.0), 2, weight=1.0), b[2].average(tree(4.0), 2, weight=1.0))
            return failed, trees, ok, [n[2].stats() for n in (a, b)]
        finally:
            for t, mem, _ in (a, b):
                await asyncio.wait_for(mem.leave(), 5)
                await asyncio.wait_for(t.close(), 5)

    failed, trees, ok, stats = asyncio.run(asyncio.wait_for(main(), 60))
    assert isinstance(failed[0], mc.MeshCodecError) and failed[1] is None
    np.testing.assert_array_equal(trees[0]["w"], 0.0)
    np.testing.assert_array_equal(trees[1]["w"], 4.0)
    for r in ok:
        np.testing.assert_allclose(r["w"], 2.0, rtol=1e-5)
    assert [st["rounds_ok"] for st in stats] == [1, 1]
    assert stats[0]["aggregation"]["folder_kind"] == "ring" and stats[0]["mesh_codec"]["ops_host"] == 0


# ---------------------------------------------------------------------------
# K6's host side: the by-value metadata, whole-slot groups, launches per card
# ---------------------------------------------------------------------------


def _flush(nd, k, n_tiles, tile, seed):
    """A flush of k chunks with repeated tiles, split over nd ranks as the
    ring folder splits a batch (contiguous runs): per-rank bits, tiles,
    weights (one zero), and random accumulator shards."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, n_tiles, k).tolist()
    ws = rng.uniform(0.25, 2.0, k).astype(np.float32).tolist()
    ws[k // 2] = 0.0
    bits = torch.from_numpy(native.f32_to_bf16(rng.standard_normal(k * tile).astype(np.float32)).view(np.int16))
    bits = bits.view(k, tile)
    per = -(-k // nd)
    own = [slice(min(d * per, k), min((d + 1) * per, k)) for d in range(nd)]
    shard = tile // nd
    acc = torch.from_numpy(rng.standard_normal((n_tiles, tile)).astype(np.float32))
    accs = [acc[:, d * shard : (d + 1) * shard].contiguous() for d in range(nd)]
    return accs, [bits[sl].contiguous() for sl in own], [ts[sl] for sl in own], [ws[sl] for sl in own]


def _emulate_k6(group, cards, accs, bits):
    """What the K6 launches of one group compute, read from the packed
    metadata alone (row | per rank slot_ptr, chunk, weight bits): one ring
    step per card per step, multiply and add rounded separately."""
    nd, shard = len(accs), accs[0].shape[1]
    n = len(group.rows)
    slots = [torch.zeros(2, n, shard) for _ in range(nd)]
    metas = [(np.asarray(words), offs) for words, offs in (group.meta(ranks) for ranks in cards)]
    for s in range(nd):
        for ranks, (words, offs) in zip(cards, metas):
            rows = words[:n].tolist()
            for d, off in zip(ranks, offs):
                k = len(group.chunks[d])
                ptr = words[off : off + n + 1]
                chunk = words[off + n + 1 : off + n + 1 + k]
                w = words[off + n + 1 + k : off + n + 1 + 2 * k].view(np.float32)
                cols = slice((d - s - 1) % nd * shard, ((d - s - 1) % nd + 1) * shard)
                for u in range(n):
                    p = torch.zeros(shard)
                    for j in range(ptr[u], ptr[u + 1]):
                        p = p + torch.tensor(w[j]) * mc.widen_bf16(bits[d][chunk[j], cols])
                    if s > 0:
                        p = slots[(d - 1) % nd][(s - 1) % 2][u] + p
                    if s == nd - 1:
                        accs[d][rows[u]] = accs[d][rows[u]] + p
                    else:
                        slots[d][s % 2][u] = p


@pytest.mark.parametrize("nd,k", [(2, 16), (4, 9), (3, 1)])
def test_fold_meta_round_trips_to_ring_slots(nd, k):
    """A flush that fits one launch: K6's by-value metadata holds exactly
    what ``ring_slots`` lays out (slot_ptr, chunk order, rows), with each
    chunk's weight at its position."""
    _, _, tiles, weights = _flush(nd, k, 7, 8 * nd, seed=nd + k)
    uniq, ref = mcol.ring_slots(tiles, weights, 7)
    (group,) = mcol.fold_plan(tiles, weights, 7)
    assert group.rows == uniq
    words, offs = group.meta(range(nd))
    words = np.asarray(words)
    u = len(uniq)
    np.testing.assert_array_equal(words[:u], uniq)
    for d in range(nd):
        kd = len(tiles[d])
        m, off = ref[d], offs[d]
        np.testing.assert_array_equal(words[off : off + u + 1], m[: u + 1])
        np.testing.assert_array_equal(words[off + u + 1 : off + u + 1 + kd], m[u + 1 : u + 1 + kd])
        np.testing.assert_array_equal(m[u + 1 + kd : 2 * u + 1 + kd], uniq)
        w_by_chunk = m[2 * u + 1 + kd :].view(np.float32)
        np.testing.assert_array_equal(words[off + u + 1 + kd : off + u + 1 + 2 * kd].view(np.float32),
                                      w_by_chunk[m[u + 1 : u + 1 + kd]])
    assert len(words) <= mcol.FOLD_META_WORDS


@pytest.mark.parametrize("nd,cap", [(2, 40), (3, 64), (4, 120)])
def test_oversized_flush_splits_into_whole_slot_groups(nd, cap, monkeypatch):
    """A flush whose metadata passes the cap folds as several rings of
    whole slots: one after the other they give ``ring_fold_plain``'s result
    on the whole flush bit for bit, and so does K6's arithmetic read from
    each group's packed metadata."""
    accs, bits, tiles, weights = _flush(nd, 40, 23, 8 * nd, seed=cap)
    want = [a.clone() for a in accs]
    mcol.ring_fold_plain(want, bits, tiles, weights)
    monkeypatch.setattr(mcol, "FOLD_META_WORDS", cap)
    plan = mcol.fold_plan(tiles, weights, 23)
    assert len(plan) > 1 and [t for g in plan for t in g.rows] == sorted({t for ts in tiles for t in ts})
    by_groups, emulated = [a.clone() for a in accs], [a.clone() for a in accs]
    for group in plan:
        assert len(group.meta(range(nd))[0]) <= cap
        sub_tiles = [[tiles[d][i] for i in group.chunks[d]] for d in range(nd)]
        mcol.ring_fold_plain(by_groups, [bits[d][group.chunks[d]] for d in range(nd)], sub_tiles, group.weights)
        _emulate_k6(group, mcol.card_groups([torch.device("cuda", 0)] * nd), emulated, bits)
    for got in (by_groups, emulated):
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(ValueError, match="metadata words"):
        mcol.fold_plan([[3] * 60] + [[]] * (nd - 1), [[1.0] * 60] + [[]] * (nd - 1), 23)


@pytest.mark.parametrize("cards,want,per_flush", [
    ([0, 0], [[0, 1]], 2),
    ([0, 0, 0, 0], [[0, 1, 2, 3]], 4),
    ([0, 1, 2, 3], [[0], [1], [2], [3]], 16),
    ([0, 1, 0, 1], [[0, 2], [1, 3]], 8),
    ([0] * 10, [list(range(8)), [8, 9]], 20),
])
def test_card_groups_give_one_launch_per_card_per_step(cards, want, per_flush):
    """nd ranks on one card: one K6 launch per ring step, nd per flush; on
    distinct cards one per rank, nd² per flush; at most FOLD_MAX_RANKS ranks
    per launch. The emulated launches of a two-card placement compute what
    one card's do."""
    devs = [torch.device("cuda", c) for c in cards]
    groups = mcol.card_groups(devs)
    assert groups == want
    nd = len(devs)
    assert nd * len(groups) == per_flush  # nd ring steps, one launch per group each
    if nd == 4:
        accs, bits, tiles, weights = _flush(nd, 11, 5, 32, seed=7)
        (group,) = mcol.fold_plan(tiles, weights, 5)
        one, spread = [a.clone() for a in accs], [a.clone() for a in accs]
        _emulate_k6(group, [[0, 1, 2, 3]], one, bits)
        _emulate_k6(group, groups, spread, bits)
        for a, b in zip(one, spread):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The one-card designs: K6's and K7's packed arguments, read as the kernels
# read them
# ---------------------------------------------------------------------------

K6_BATCH = 4  # csrc/ring_collective.cu kFoldBatch: chunk loads issued before they fold


def _widen(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _read_card_fold(rec, meta, n_slots, shard, mem):
    """What one ``card_ring_fold_kernel`` launch computes, read from its
    packed arguments alone. ``mem`` maps each pointer of ``rec`` to its numpy
    array (bits uint16 [k, tile], accumulator f32 [n_tiles, shard]). Every
    (slot u, shard b) block walks the slot's chunks as the kernel does:
    ranks b + 1, ..., b, each rank's chunks in staging order, up to
    ``K6_BATCH`` loads before they fold, each rank's partial closed into v
    when the walk passes it, the accumulator row loaded first and stored
    last. The columns, the kernel's threads, fold as one vector."""
    rec = np.frombuffer(rec, np.int64).reshape(-1, 4)
    meta = np.frombuffer(meta, np.int32)
    nd = len(rec)
    for b in range(nd):
        cols = slice(b * shard, (b + 1) * shard)
        for u in range(n_slots):
            acc = mem[rec[b, 1]][meta[u]].copy()

            def walk():  # RingWalk::next: (ring position, bits row, weight)
                r = (b + 1) % nd
                for step in range(nd):
                    bits, _, off, k = rec[r]
                    for j in range(meta[off + u], meta[off + u + 1]):
                        chunk = meta[off + n_slots + 1 + j]
                        yield step, mem[bits][chunk], meta[off + n_slots + 1 + k + j : off + n_slots + 2 + k + j].view(
                            np.float32)[0]
                    r = (r + 1) % nd

            chunks = walk()
            p, v, closed = np.zeros(shard, np.float32), None, 0

            def close():
                nonlocal p, v, closed
                v = p if closed == 0 else v + p
                p, closed = np.zeros(shard, np.float32), closed + 1

            while True:
                batch = [c for _, c in zip(range(K6_BATCH), chunks)]
                loaded = [(at, _widen(row[cols]), np.float32(w)) for at, row, w in batch]
                for at, x, w in loaded:
                    while closed < at:
                        close()
                    p = p + w * x
                if len(batch) < K6_BATCH:
                    break
            while closed < nd:
                close()
            mem[rec[b, 1]][meta[u]] = acc + v


def _special_bits(bits, rng):
    """Random bit patterns (every exponent: subnormals, inf, NaN) with the
    special values up front in every chunk."""
    sp = np.array([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81, 0x0001, 0x8001, 0x7F7F], np.uint16)
    out = rng.integers(0, 1 << 16, bits.shape, dtype=np.uint16)
    out[:, : len(sp)] = sp
    return torch.from_numpy(out.view(np.int16))


def _assert_bit_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert np.array_equal(got.view(np.int32)[fin], want.view(np.int32)[fin])
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[np.isinf(want)], want[np.isinf(want)])


@pytest.mark.parametrize("case", ["repeats", "special", "ragged", "split", "empty_rank"])
@pytest.mark.parametrize("nd", [2, 3, 4])
def test_card_fold_pack_read_as_the_kernel_matches_plain(nd, case, monkeypatch):
    """K6 on a card that holds every rank: the launches ``card_fold_pack``
    packs (records and metadata words), read as ``card_ring_fold_kernel``
    walks them, give ``ring_fold_plain``'s result bit for bit on finite lanes
    (inf and NaN lanes matching): repeated tiles within and across ranks, a
    zero weight, special bit patterns, a width that is not a multiple of 8
    (the kernel's scalar path), a flush that splits into several rings of
    whole slots, and a rank with no chunk."""
    k, n_tiles, tile = {"split": (40, 23, 8 * nd), "empty_rank": (nd - 1, 5, 8 * nd)}.get(case, (13, 7, 8 * nd))
    if case == "ragged":
        tile = 13 * nd
    accs, bits, tiles, weights = _flush(nd, k, n_tiles, tile, seed=nd * 10 + len(case))
    if case == "special":
        rng = np.random.default_rng(nd)
        bits = [_special_bits(x.numpy(), rng) for x in bits]
    if case == "split":
        monkeypatch.setattr(mcol, "FOLD_META_WORDS", 40 + 8 * nd)
    shard = tile // nd
    want = [a.clone() for a in accs]
    mcol.ring_fold_plain(want, bits, tiles, weights)
    mem = {}
    for d in range(nd):
        mem[1000 + d] = bits[d].numpy().view(np.uint16)
        mem[2000 + d] = accs[d].numpy().copy()
    ptrs = [(1000 + d if len(tiles[d]) else 0, 2000 + d) for d in range(nd)]
    launches = mcol.card_fold_pack(ptrs, tiles, weights, n_tiles)
    assert len(launches) == len(mcol.fold_plan(tiles, weights, n_tiles))
    assert (len(launches) > 1) == (case == "split")
    if case == "empty_rank":
        assert not tiles[-1]
    rows = []
    for rec, meta, n_slots in launches:
        assert len(meta) <= mcol.FOLD_META_WORDS and len(rec) == 4 * nd
        rows += list(meta[:n_slots])
        with np.errstate(all="ignore"):
            _read_card_fold(rec, meta, n_slots, shard, mem)
    assert rows == sorted({t for ts in tiles for t in ts})
    for d in range(nd):
        _assert_bit_equal(mem[2000 + d], want[d].numpy())


def test_card_fold_pack_of_an_empty_flush_launches_nothing():
    assert mcol.card_fold_pack([(0, 1), (0, 2)], [[], []], [[], []], 4) == []
    with pytest.raises(ValueError, match="tile index"):
        mcol.card_fold_pack([(1, 1), (0, 2)], [[4], []], [[1.0], []], 4)


def _read_card_gather(ptrs, rows, shard, mem):
    """What one ``card_ring_allgather_kernel`` launch computes from its
    packed pointers: block (x, row, b) reads shard b's row once and stores it
    into columns [b·shard, (b+1)·shard) of every copy."""
    ptrs = np.frombuffer(ptrs, np.int64)
    nd = len(ptrs) // 2
    for b in range(nd):
        for row in range(rows):
            x = mem[ptrs[b]][row].copy()
            for d in range(nd):
                mem[ptrs[nd + d]][row, b * shard : (b + 1) * shard] = x


@pytest.mark.parametrize("shard", [8, 13])
@pytest.mark.parametrize("nd", [2, 3, 4])
def test_card_gather_pack_read_as_the_kernel_matches_plain(nd, shard):
    """K7 on a card that holds every rank: its one launch's packed pointers,
    read as ``card_ring_allgather_kernel`` reads them, give
    ``ring_allgather_plain``'s copies bit for bit (special values included;
    a shard width of 13 takes the kernel's scalar path)."""
    rng = np.random.default_rng(nd * shard)
    rows = 5
    accs = [torch.from_numpy(rng.standard_normal((rows, shard)).astype(np.float32)) for _ in range(nd)]
    accs[0][0, :4] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40])
    want = mcol.ring_allgather_plain(accs)
    mem = {100 + d: a.numpy() for d, a in enumerate(accs)}
    mem.update({200 + d: np.full((rows, nd * shard), np.nan, np.float32) for d in range(nd)})
    ptrs = mcol.card_gather_pack([100 + d for d in range(nd)], [200 + d for d in range(nd)])
    assert list(ptrs) == [100 + d for d in range(nd)] + [200 + d for d in range(nd)]
    _read_card_gather(ptrs, rows, shard, mem)
    for d in range(nd):
        assert np.array_equal(mem[200 + d].view(np.int32), want[d].numpy().view(np.int32))


@pytest.mark.parametrize("name", ["batch1", "batch8", "unroll2", "unroll8"])
def test_ring_variant_patches_apply_to_the_source(name):
    """``experiments/torch_ring_variants.py`` patches
    ``csrc/ring_collective.cu`` by text: every patch must find its line in
    the shipped source exactly once (an edit that moves one breaks the
    experiment, and this says so on the CPU)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "experiments" / "torch_ring_variants.py"
    spec = importlib.util.spec_from_file_location("torch_ring_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = mod.patched_source(name)
    assert text != mod.RING.read_text()


@pytest.mark.parametrize("nd", [2, 4])
def test_stepwise_entry_points_take_the_plain_version_on_the_cpu(nd):
    """``ring_fold_stepwise`` / ``ring_allgather_stepwise`` (the design across
    cards, by name) give the plain versions' bits on CPU tensors and launch
    nothing."""
    accs, bits, tiles, weights = _flush(nd, 9, 5, 8 * nd, seed=nd)
    want = [a.clone() for a in accs]
    mcol.ring_fold_plain(want, bits, tiles, weights)
    before = dict(mcol.LAUNCHES)
    mcol.ring_fold_stepwise(accs, bits, tiles, weights, mcol.RingPartials())
    outs = mcol.ring_allgather_stepwise(accs)
    assert mcol.LAUNCHES == before
    for a, b in zip(accs, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for out, ref in zip(outs, mcol.ring_allgather_plain(want)):
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
