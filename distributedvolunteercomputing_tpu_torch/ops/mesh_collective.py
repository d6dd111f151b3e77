"""The ring fold over a volunteer's codec ranks (ported from
``distributedvolunteercomputing_tpu/ops/mesh_collective.py``).

When a volunteer's codec has two or more ranks (``ops/mesh_codec.py``), the
sync leader's bf16 mean fold runs as a ring instead of the staged
element-split fold: each flush places the staged chunks WHOLE on the ranks
(rank d takes a contiguous run of the batch), and a ring reduce-scatter
decodes and folds them into the element-split accumulator that the staged
folder keeps, ``[n_tiles, tile_elems / nd]`` per rank. ``result()`` gathers
that accumulator with a ring all-gather and fetches it to the host once.
Staging, the accumulator's layout and the aggregator's re-normalization are
the staged folder's; the aggregator tells the two apart only by ``kind`` and
the ``ring_flushes`` gauge.

Two hand-written CUDA kernels (``csrc/ring_collective.cu``) replace the
reference's Pallas TPU kernels:

=====  ======================  =======================================
kernel TPU kernel it replaces   wrapper / plain version
=====  ======================  =======================================
K6     ``_ring_fold_kernel``    ``ring_fold`` / ``ring_fold_plain``
K7     ``_ring_ag_kernel``      ``ring_allgather`` / ``ring_allgather_plain``
=====  ======================  =======================================

Each wrapper runs the whole ring schedule, never ordered by a flag a
kernel spins on, so ranks that share a card cannot deadlock, and is
ordered like any other op on the current stream. Which design runs follows
from where the ranks live (``_card_layout``), never from a failure:

- **One card holds every rank** (at most ``FOLD_MAX_RANKS``; how a
  one-GPU machine runs a multi-rank volunteer): K6 is one launch per ring
  group of a flush
  (``card_fold_pack``: one group unless the flush's metadata passes
  ``FOLD_META_WORDS``), which walks each slot's chunks in the ring's order
  in registers: no partial slot, no step. K7 is one launch per result
  (``card_gather_pack``), each shard read once. Both run on the card's
  current stream, with no fork, event or join, their arguments passed by
  value in the kernel's parameter block.
- **The ranks span cards**: K6 takes nd steps of one launch per card
  (``card_groups``: its grid's y covers that card's ranks), each card's
  steps on the stream of its first rank (``MeshCodec.streams``), ordered by
  CUDA events; the flush's metadata is passed by value (``fold_plan``) and
  the partial slots are kept across flushes (``RingPartials``). K7 takes
  nd − 1 hops of one launch per rank, each on the rank's own stream,
  ordered by events (nd·(nd − 1) launches per result). Streams other than
  the current one first wait for the callers' current streams, and the
  current streams wait for them at the end. ``ring_fold_stepwise`` and
  ``ring_allgather_stepwise`` are this design by name: they also run with
  every rank on one card, where a one-GPU machine checks their kernels.

``LAUNCHES`` counts the launches. Given CPU tensors a wrapper computes its
plain version; given CUDA tensors it launches its kernels or raises — there
is no fallback.

Sum order: shard b's partial starts on rank b + 1 and travels the ring, each
rank adding its own chunks' partial (``recv + p``), and the last step adds
it to the accumulator (``acc + v``). Within a rank, chunks of one tile fold
in staging order, multiply and add rounded separately. ``ring_fold_plain``
takes the same order, so the kernel is bit-equal to it; the staged folder
and the host fold add in batch order instead, within rtol 1e-5 / atol 1e-6
(the reference's tolerance for its ring).

Left out of the reference, each for a reason:

- the ``xla`` and eager lowerings and ``_resolve_lower``: the port has one
  lowering, the kernels; a plain re-lowering on a CUDA codec would be a
  fallback, which the port does not have;
- the VMEM cap (``DVC_RING_VMEM_MB``, ``_VMEM_CAP_BYTES``) and its
  ``ring_lower*`` / ``ring_vmem_fallbacks`` gauges: a TPU limit, not part of
  what the function means; the kernels take every size;
- the degraded-slice replay: a failed flush or result raises (the codec's
  no-degrade contract), so the round fails and the trainer keeps its params.
"""

from __future__ import annotations

import array
import functools
import itertools
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.ops.mesh_codec import (
    MeshCodec,
    MeshMeanFolder,
    _launch,
    _launch_lock,
    widen_bf16,
)

LAUNCHES: Dict[str, int] = {"ring_fold": 0, "ring_allgather": 0}
_count_lock = threading.Lock()
# K6's parameter block (csrc/ring_collective.cu): ranks per launch
# (kFoldMaxRanks) and int32 metadata words per launch (kFoldMetaWords). Both
# must equal the kernel's: the launcher refuses anything larger.
FOLD_MAX_RANKS = 8
FOLD_META_WORDS = 896


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ring_available(codec: MeshCodec) -> bool:
    """True when ``codec`` routes bf16 mean folds through the ring (device
    backend, ring selected, two or more ranks)."""
    return codec.active and codec.collective == "ring" and codec.nd >= 2


# ---------------------------------------------------------------------------
# argument checks and the flush's slot layout
# ---------------------------------------------------------------------------


def _check_accs(accs: Sequence[torch.Tensor]) -> Tuple[int, int, int]:
    """(nd, n_tiles, shard) of per-rank accumulator shards."""
    nd = len(accs)
    if nd < 2:
        raise ValueError(f"a ring needs >= 2 ranks, got {nd}")
    types = {a.device.type for a in accs}
    if not (types <= {"cpu"} or types <= {"cuda"}):
        raise ValueError(f"ring: expected CUDA or CPU tensors, got {sorted(types)}")
    shape = tuple(accs[0].shape)
    for a in accs:
        if a.dtype != torch.float32 or a.dim() != 2 or tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"ring: accumulator shards must be contiguous f32 {shape}, got {a.dtype} {tuple(a.shape)}")
    return nd, shape[0], shape[1]


def _check_chunks(accs, bits, tiles, weights, nd: int, shard: int) -> None:
    if not len(bits) == len(tiles) == len(weights) == nd:
        raise ValueError(f"ring: {nd} ranks but {len(bits)} bits, {len(tiles)} tiles, {len(weights)} weights")
    for acc, x, ts, ws in zip(accs, bits, tiles, weights):
        if x.device != acc.device or x.dtype != torch.int16 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"ring: chunk bits must be contiguous int16 [k, tile] on {acc.device}")
        if x.shape[1] != nd * shard or not x.shape[0] == len(ts) == len(ws):
            raise ValueError(f"ring: chunk bits {tuple(x.shape)} for {len(ts)} tiles, tile {nd * shard}")


def _check_streams(streams, accs) -> List[torch.cuda.Stream]:
    if streams is None or len(streams) != len(accs):
        raise ValueError("ring: CUDA tensors need one stream per rank")
    for st, a in zip(streams, accs):
        if st is None or st.device != a.device:
            raise ValueError(f"ring: a rank on {a.device} needs a stream on its device")
    return list(streams)


def ring_slots(tiles: Sequence[Sequence[int]], weights, n_tiles: int) -> Tuple[List[int], List[np.ndarray]]:
    """The flush's distinct tiles (one partial row each, sorted) and, per
    rank, its K6 metadata as int32: slot_ptr [U + 1] | chunk [k] | row [U] |
    weight bits [k], the rank's chunks grouped by slot in staging order."""
    flat = [int(t) for ts in tiles for t in ts]
    if any(t < 0 or t >= n_tiles for t in flat):
        raise ValueError(f"ring: tile index out of [0, {n_tiles})")
    uniq = sorted(set(flat))
    slot = {t: u for u, t in enumerate(uniq)}
    metas = []
    for ts, ws in zip(tiles, weights):
        slots = np.array([slot[int(t)] for t in ts], np.int64)
        ptr = np.zeros(len(uniq) + 1, np.int64)
        ptr[1:] = np.cumsum(np.bincount(slots, minlength=len(uniq)))
        metas.append(np.concatenate([
            ptr.astype(np.int32),
            np.argsort(slots, kind="stable").astype(np.int32),
            np.asarray(uniq, np.int32),
            np.asarray(ws, np.float32).view(np.int32),
        ]))
    return uniq, metas


class FoldGroup:
    """Whole slots of one flush that K6 folds as one ring: ``rows`` their
    tiles, and per rank ``slot_ptr`` [len(rows) + 1], ``chunks`` (rows of
    the rank's bits, grouped by slot in staging order) and ``weights`` (one
    per position of ``chunks``)."""

    __slots__ = ("rows", "slot_ptr", "chunks", "weights")

    def __init__(self, rows, slot_ptr, chunks, weights):
        self.rows, self.slot_ptr, self.chunks, self.weights = rows, slot_ptr, chunks, weights

    def meta(self, ranks: Sequence[int]) -> Tuple[array.array, List[int]]:
        """K6's metadata for one launch over ``ranks`` (int32: row [U], then
        per rank slot_ptr | chunk | weight bits) and each rank's offset."""
        words, offs = list(self.rows), []
        for d in ranks:
            ws = self.weights[d]
            offs.append(len(words))
            words += self.slot_ptr[d]
            words += self.chunks[d]
            words += struct.unpack(f"<{len(ws)}i", struct.pack(f"<{len(ws)}f", *ws))
        return array.array("i", words), offs


def fold_plan(tiles: Sequence[Sequence[int]], weights, n_tiles: int) -> List[FoldGroup]:
    """The flush's distinct tiles (sorted) split into groups of whole slots
    whose metadata for all ranks fits ``FOLD_META_WORDS`` int32 words. Each
    tile's chunks stay in one group in staging order, so folding the groups
    one after the other adds every element in the order one ring over the
    whole flush does. A slot whose chunks alone need more words raises."""
    nd, cap = len(tiles), FOLD_META_WORDS
    uniq = sorted({int(t) for ts in tiles for t in ts})
    if uniq and (uniq[0] < 0 or uniq[-1] >= n_tiles):
        raise ValueError(f"ring: tile index out of [0, {n_tiles})")
    n = len(uniq)
    slot = {t: u for u, t in enumerate(uniq)}
    orders, ptrs = [], []
    for ts in tiles:
        sl = [slot[t] for t in ts]
        orders.append(sorted(range(len(sl)), key=sl.__getitem__))  # stable: staging order within a slot
        counts = [0] * (n + 1)
        for u in sl:
            counts[u + 1] += 1
        ptrs.append(list(itertools.accumulate(counts)))

    def words(u0: int, u1: int) -> int:  # row and slot_ptr per slot, closing slot_ptr, chunk and weight
        return (u1 - u0) * (1 + nd) + nd + 2 * sum(ptr[u1] - ptr[u0] for ptr in ptrs)

    groups, u0 = [], 0
    while u0 < n:
        u1 = n
        if words(u0, n) > cap:
            u1 = u0
            while u1 < n and words(u0, u1 + 1) <= cap:
                u1 += 1
            if u1 == u0:
                raise ValueError(f"ring: the chunks of tile {uniq[u0]} need more than {cap} metadata words")
        whole = u0 == 0 and u1 == n
        runs = orders if whole else [order[ptr[u0] : ptr[u1]] for order, ptr in zip(orders, ptrs)]
        groups.append(FoldGroup(
            uniq if whole else uniq[u0:u1],
            ptrs if whole else [[p - ptr[u0] for p in ptr[u0 : u1 + 1]] for ptr in ptrs],
            runs,
            [[float(weights[d][i]) for i in run] for d, run in enumerate(runs)],
        ))
        u0 = u1
    return groups


@functools.lru_cache(maxsize=64)
def _card_layout(devs: Tuple[torch.device, ...]) -> Tuple[List[List[int]], Dict[int, int]]:
    """(``card_groups(devs)``, rank -> index of its group), once per placement."""
    cards = card_groups(devs)
    return cards, {d: c for c, ranks in enumerate(cards) for d in ranks}


def card_groups(devs: Sequence[torch.device]) -> List[List[int]]:
    """Rank indices by card, in rank order, at most ``FOLD_MAX_RANKS`` each:
    one K6 launch per group per ring step (nd ranks on one card: one launch)."""
    by_card: Dict[torch.device, List[int]] = {}
    for d, dev in enumerate(devs):
        by_card.setdefault(dev, []).append(d)
    m = FOLD_MAX_RANKS
    return [ranks[i : i + m] for ranks in by_card.values() for i in range(0, len(ranks), m)]


def card_fold_pack(
    ptrs: Sequence[Tuple[int, int]], tiles: Sequence[Sequence[int]], weights, n_tiles: int
) -> List[Tuple[array.array, array.array, int]]:
    """K6's launches on a card that holds every rank: one per ring group of
    ``fold_plan``, as (records, meta, n_slots). ``ptrs[d]``: rank d's (bits,
    accumulator) pointers. records: per rank int64 (bits, accumulator, meta
    offset, chunks); meta: the group's ``FoldGroup.meta`` over every rank
    (``FoldParams`` in ``csrc/ring_collective.cu``)."""
    out = []
    for group in fold_plan(tiles, weights, n_tiles):
        meta, offs = group.meta(range(len(tiles)))
        rec = array.array("q")
        for (bits, acc), off, chunks in zip(ptrs, offs, group.chunks):
            rec.extend((bits, acc, off, len(chunks)))
        out.append((rec, meta, len(group.rows)))
    return out


def card_gather_pack(srcs: Sequence[int], dsts: Sequence[int]) -> array.array:
    """K7's one launch on a card that holds every rank: int64 shard
    pointers (rank order), then the full copies' pointers."""
    return array.array("q", [*srcs, *dsts])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def ring_fold_plain(
    accs: Sequence[torch.Tensor],
    bits: Sequence[torch.Tensor],
    tiles: Sequence[Sequence[int]],
    weights: Sequence[Sequence[float]],
) -> None:
    """K6's function, in place on ``accs``: for every shard b, the rank's
    partial p_d = Σ w·widen(bits) per tile over rank d's chunks (from 0, in
    staging order), then v = p_{b+1}, v = v + p_{b+2}, …, v = v + p_b around
    the ring, and acc_b[tile] = acc_b[tile] + v."""
    nd, n_tiles, shard = _check_accs(accs)
    _check_chunks(accs, bits, tiles, weights, nd, shard)
    uniq, _ = ring_slots(tiles, weights, n_tiles)
    if not uniq:
        return
    slot = {t: u for u, t in enumerate(uniq)}
    parts = []
    for acc, x, ts, ws in zip(accs, bits, tiles, weights):
        p = torch.zeros((len(uniq), nd * shard), dtype=torch.float32, device=acc.device)
        for i, (t, w) in enumerate(zip(ts, ws)):
            u = slot[int(t)]
            p[u] = p[u] + torch.tensor(w, dtype=torch.float32, device=acc.device) * widen_bf16(x[i])
        parts.append(p)
    for b, acc in enumerate(accs):
        cols = slice(b * shard, (b + 1) * shard)
        v = parts[(b + 1) % nd][:, cols].to(acc.device)
        for j in range(2, nd + 1):
            v = v + parts[(b + j) % nd][:, cols].to(acc.device)
        rows = torch.tensor(uniq, dtype=torch.long, device=acc.device)
        acc.index_copy_(0, rows, acc.index_select(0, rows) + v)


def ring_allgather_plain(accs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K7's function: every rank's copy of the full accumulator
    [n_tiles, nd * shard], rank r's shard in columns [r·shard, (r+1)·shard)."""
    _check_accs(accs)
    return [torch.cat([a.to(dst.device) for a in accs], dim=1) for dst in accs]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _fork(streams: List[torch.cuda.Stream], devs: List[torch.device]) -> None:
    """Every rank stream waits for the current stream of every rank device:
    a rank reads its neighbour's buffers (K7's hop 0 reads the neighbour's
    accumulator shard with no event guarding it), so work queued on any
    rank's card before the call must land first."""
    for dev in dict.fromkeys(devs):
        cur = torch.cuda.current_stream(dev)
        for st in streams:
            st.wait_stream(cur)


def _join(streams: List[torch.cuda.Stream], devs: List[torch.device]) -> None:
    """Every rank device's current stream waits for every rank stream: a
    buffer one rank read from its neighbour may be freed on return."""
    for dev in dict.fromkeys(devs):
        cur = torch.cuda.current_stream(dev)
        for st in streams:
            cur.wait_stream(st)


def _record(stream: torch.cuda.Stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


class RingPartials:
    """K6's partial slots, per rank [2, n_slots, shard] f32: step s writes
    slot s % 2 and the right neighbour reads it at step s + 1. Kept across
    flushes by their owner (the ring folder), grown when a flush needs more
    slots; the wrappers' fork and join order every reuse."""

    def __init__(self) -> None:
        self._bufs: Optional[List[torch.Tensor]] = None

    def get(self, devs: Sequence[torch.device], n_slots: int, shard: int) -> List[torch.Tensor]:
        bufs = self._bufs
        if (bufs is None or [b.device for b in bufs] != list(devs) or bufs[0].shape[1] < n_slots
                or bufs[0].shape[2] != shard):
            bufs = self._bufs = [torch.empty((2, n_slots, shard), dtype=torch.float32, device=dev) for dev in devs]
        return bufs


def _fold_launch(lib, ranks: array.array, nd: int, step: int, meta: array.array, n_slots: int,
                 shard: int, dev: torch.device, stream: torch.cuda.Stream) -> None:
    """K6 ring step ``step`` of the ranks in ``ranks`` (9 int64 each), one
    launch; both buffers are host memory that the launch copies by value."""
    err = lib.dvc_ring_fold(ranks.buffer_info()[0], len(ranks) // 9, nd, step, meta.buffer_info()[0],
                            len(meta), n_slots, shard, nd * shard, dev.index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_fold: CUDA error {err}: {lib.dvc_error_string(err).decode()}")
    with _launch_lock:
        LAUNCHES["ring_fold"] += 1


def _card_fold(lib, accs, bits, tiles, weights, n_tiles: int, shard: int, dev: torch.device) -> None:
    """K6 on a card that holds every rank: one launch per ring group on the
    card's current stream (``card_fold_pack``)."""
    nd = len(accs)
    ptrs = [(x.data_ptr() if x.numel() else 0, a.data_ptr()) for x, a in zip(bits, accs)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rec, meta, n_slots in card_fold_pack(ptrs, tiles, weights, n_tiles):
        err = lib.dvc_ring_fold_card(rec.buffer_info()[0], nd, meta.buffer_info()[0], len(meta), n_slots, shard,
                                     nd * shard, n_tiles, dev.index, stream)
        if err != 0:
            raise RuntimeError(f"ring_fold: CUDA error {err}: {lib.dvc_error_string(err).decode()}")
        with _launch_lock:
            LAUNCHES["ring_fold"] += 1


def ring_fold(
    accs: Sequence[torch.Tensor],
    bits: Sequence[torch.Tensor],
    tiles: Sequence[Sequence[int]],
    weights: Sequence[Sequence[float]],
    partials: RingPartials,
    streams: Optional[Sequence[Optional[torch.cuda.Stream]]] = None,
) -> None:
    """K6. Fold one flush into the accumulator shards, in place.

    ``accs[d]``: rank d's f32 shard [n_tiles, shard]; ``bits[d]``: rank d's
    own whole chunks, int16 bf16 bits [k_d, nd·shard] (short chunks
    zero-padded); ``tiles[d]`` / ``weights[d]``: their tiles and weights
    (host values; a zero weight folds nothing). ``partials``: the partial
    slots of the path across cards, kept by the caller across flushes.
    ``streams``: one per rank (CUDA ranks across cards; each card's steps run
    on the stream of its first rank). On one card the fold runs on its
    current stream and touches neither."""
    nd, n_tiles, shard = _check_accs(accs)
    _check_chunks(accs, bits, tiles, weights, nd, shard)
    if accs[0].device.type == "cpu":
        ring_fold_plain(accs, bits, tiles, weights)
        return
    devs = tuple(a.device for a in accs)
    if len(_card_layout(devs)[0]) > 1:
        ring_fold_stepwise(accs, bits, tiles, weights, partials, streams)
        return
    from distributedvolunteercomputing_tpu_torch.ops import _build

    _card_fold(_build.load_library(), accs, bits, tiles, weights, n_tiles, shard, devs[0])


def ring_fold_stepwise(
    accs: Sequence[torch.Tensor],
    bits: Sequence[torch.Tensor],
    tiles: Sequence[Sequence[int]],
    weights: Sequence[Sequence[float]],
    partials: RingPartials,
    streams: Optional[Sequence[Optional[torch.cuda.Stream]]] = None,
) -> None:
    """K6's stepwise design, which ``ring_fold`` runs when the ranks span
    cards: nd ring steps of one launch per card group (``card_groups``), on
    the stream of each group's first rank, forked, ordered by events and
    joined, the partials in ``partials``. It also runs with every rank on
    one card (stream order alone then orders the steps), so a one-card
    machine can hold its kernel against the plain version. CPU tensors
    take the plain version."""
    nd, n_tiles, shard = _check_accs(accs)
    _check_chunks(accs, bits, tiles, weights, nd, shard)
    if accs[0].device.type == "cpu":
        ring_fold_plain(accs, bits, tiles, weights)
        return
    from distributedvolunteercomputing_tpu_torch.ops import _build

    lib = _build.load_library()
    devs = tuple(a.device for a in accs)
    cards, card_of = _card_layout(devs)
    streams = _check_streams(streams, accs)
    plan = fold_plan(tiles, weights, n_tiles)
    if not plan:
        return
    cstreams = [streams[ranks[0]] for ranks in cards]
    slots = partials.get(devs, max(len(g.rows) for g in plan), shard)
    bits_p = [x.data_ptr() if x.numel() else 0 for x in bits]
    slot_p = [(buf.data_ptr(), buf.data_ptr() + buf.stride(0) * 4) for buf in slots]
    base = [(bits_p[d], accs[d].data_ptr(), *slot_p[d], *slot_p[(d - 1) % nd], d) for d in range(nd)]
    _fork(cstreams, devs)
    prev: List[torch.cuda.Event] = []
    for group in plan:
        launches = []
        for ranks in cards:
            meta, offs = group.meta(ranks)
            rec = array.array("q")
            for d, off in zip(ranks, offs):
                rec.extend((*base[d], off, len(group.chunks[d])))
            launches.append((rec, meta))
        for s in range(nd):
            last = s == nd - 1
            cur = []
            for c, ranks in enumerate(cards):
                st = cstreams[c]
                if prev:
                    if s == 0:  # the previous group's ring is done everywhere
                        waits = set(range(len(cards)))
                    else:
                        waits = {card_of[(d - 1) % nd] for d in ranks}  # their partials of step s - 1
                        if s >= 2 and not last:  # done reading the slot step s overwrites
                            waits |= {card_of[(d + 1) % nd] for d in ranks}
                    for w in sorted(waits - {c}):
                        st.wait_event(prev[w])
                rec, meta = launches[c]
                _fold_launch(lib, rec, nd, s, meta, len(group.rows), shard, devs[ranks[0]], st)
                cur.append(_record(st))
            prev = cur
    _join(cstreams, devs)


def ring_allgather(
    accs: Sequence[torch.Tensor], streams: Optional[Sequence[Optional[torch.cuda.Stream]]] = None
) -> List[torch.Tensor]:
    """K7. Every rank's copy of the full accumulator [n_tiles, nd·shard].
    On a card that holds every rank: one launch on its current stream that
    reads each shard once (``streams`` unused). Across cards: nd − 1 hops,
    rank d pulling block (d − s − 1) mod nd from its left neighbour at hop s
    (from the neighbour's shard at hop 0, with its own shard copied in the
    same launch), on the ranks' ``streams``."""
    nd, n_tiles, shard = _check_accs(accs)
    if accs[0].device.type == "cpu":
        return ring_allgather_plain(accs)
    devs = tuple(a.device for a in accs)
    if len(_card_layout(devs)[0]) > 1:
        return ring_allgather_stepwise(accs, streams)
    from distributedvolunteercomputing_tpu_torch.ops import _build

    lib = _build.load_library()
    outs = [torch.empty((n_tiles, nd * shard), dtype=torch.float32, device=dev) for dev in devs]
    ptrs = card_gather_pack([a.data_ptr() for a in accs], [o.data_ptr() for o in outs])
    err = lib.dvc_ring_allgather_card(ptrs.buffer_info()[0], nd, n_tiles, shard, devs[0].index,
                                      torch.cuda.current_stream(devs[0]).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_allgather: CUDA error {err}: {lib.dvc_error_string(err).decode()}")
    with _launch_lock:
        LAUNCHES["ring_allgather"] += 1
    return outs


def ring_allgather_stepwise(
    accs: Sequence[torch.Tensor], streams: Optional[Sequence[Optional[torch.cuda.Stream]]] = None
) -> List[torch.Tensor]:
    """K7's stepwise design, which ``ring_allgather`` runs when the ranks
    span cards: nd − 1 hops of one launch per rank on the ranks' ``streams``,
    ordered by events. It also runs with every rank on one card, so a
    one-card machine can hold its kernel against the plain version. CPU
    tensors take the plain version."""
    nd, n_tiles, shard = _check_accs(accs)
    if accs[0].device.type == "cpu":
        return ring_allgather_plain(accs)
    devs = tuple(a.device for a in accs)
    width = nd * shard
    outs = [torch.empty((n_tiles, width), dtype=torch.float32, device=dev) for dev in devs]
    streams = _check_streams(streams, accs)
    _fork(streams, devs)
    prev: List[torch.cuda.Event] = []
    for s in range(nd - 1):
        cur = []
        for d in range(nd):
            left, st = (d - 1) % nd, streams[d]
            blk = (d - s - 1) % nd
            if s == 0:
                src, src_ld = accs[left].data_ptr(), shard
                own = (accs[d].data_ptr(), outs[d].data_ptr() + d * shard * 4, shard)
            else:
                st.wait_event(prev[left])  # it pulled block blk at hop s - 1
                src, src_ld = outs[left].data_ptr() + blk * shard * 4, width
                own = (None, None, 0)
            with torch.cuda.stream(st):
                _launch(
                    "ring_allgather", devs[d],
                    src, outs[d].data_ptr() + blk * shard * 4, src_ld, *own, n_tiles, shard, width,
                    counts=LAUNCHES,
                )
                cur.append(_record(st))
        prev = cur
    _join(streams, devs)
    return outs


# ---------------------------------------------------------------------------
# folder
# ---------------------------------------------------------------------------


class RingMeanFolder(MeshMeanFolder):
    """``MeshMeanFolder`` whose flush is the ring reduce-scatter (K6) and
    whose result is the ring all-gather (K7). Staging, dense feeds and the
    accumulator layout are inherited."""

    kind = "ring"

    def __init__(self, codec: MeshCodec, n_elems: int, tile_elems: int, n_tiles: int, wire: str):
        if wire != "bf16":
            raise ValueError("ring folder is bf16-wire only")
        if codec.nd < 2:
            raise ValueError("ring folder needs >= 2 devices")
        if tile_elems % codec.nd:
            raise ValueError("tile_elems must split over the codec axis")
        super().__init__(codec, n_elems, tile_elems, n_tiles, wire)
        self.ring_flushes = 0
        self._partials = RingPartials()

    def _flush_dev(self, batch: List[Tuple[int, float, bytes]]) -> None:
        """Whole chunks on ranks (rank d takes batch rows [d·per, (d+1)·per),
        as the reference splits the batch rows over the codec axis), one
        copy to each rank, then the ring."""
        k = len(batch)
        per = -(-k // self.nd)
        own = [slice(min(d * per, k), min((d + 1) * per, k)) for d in range(self.nd)]
        raw = self._raw_rows(batch)
        bits = [self.codec._put(raw[sl], d).view(torch.int16) for d, sl in enumerate(own)]
        tiles = [[t for t, _, _ in batch[sl]] for sl in own]
        weights = [[w for _, w, _ in batch[sl]] for sl in own]
        with self._lock:
            ring_fold(self._device_accs(), bits, tiles, weights, self._partials, streams=self.codec.streams)
            self.ring_flushes += 1
        with _count_lock:
            self.codec.ring_flushes += 1

    def result(self) -> np.ndarray:
        """Flush the tail, gather the shards on the ring (K7) and fetch rank
        0's copy to the host once."""
        self.flush()
        accs = self._take_accs()
        if accs is None:
            return np.zeros(self.n_elems, np.float32)

        def dev() -> np.ndarray:
            full = ring_allgather(accs, streams=self.codec.streams)[0]
            return full.view(-1)[: self.n_elems].cpu().numpy().copy()

        out = self.codec._device(dev)
        with _count_lock:
            self.codec.ring_results += 1
        return out
