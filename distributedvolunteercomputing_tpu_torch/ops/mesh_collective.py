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

Each wrapper runs the whole ring schedule: nd launches per step, one per
rank on that rank's CUDA stream (``MeshCodec.streams``), ordered by CUDA
events and never by a flag a kernel spins on, so ranks that share a card
cannot deadlock. The rank streams first wait for the callers' current
streams and the current streams wait for every rank stream at the end, so a
wrapper is ordered like any other op on the current stream. K6 takes nd
steps (nd² launches per flush), K7 nd − 1 (nd·(nd − 1) launches per
result). ``LAUNCHES`` counts the launches. Given CPU tensors a wrapper
computes its plain version; given CUDA tensors it launches its kernels or
raises — there is no fallback.

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

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.ops.mesh_codec import (
    MeshCodec,
    MeshMeanFolder,
    _launch,
    widen_bf16,
)

LAUNCHES: Dict[str, int] = {"ring_fold": 0, "ring_allgather": 0}
_count_lock = threading.Lock()


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


def ring_fold(
    accs: Sequence[torch.Tensor],
    bits: Sequence[torch.Tensor],
    tiles: Sequence[Sequence[int]],
    weights: Sequence[Sequence[float]],
    streams: Optional[Sequence[Optional[torch.cuda.Stream]]] = None,
) -> None:
    """K6. Fold one flush into the accumulator shards, in place.

    ``accs[d]``: rank d's f32 shard [n_tiles, shard]; ``bits[d]``: rank d's
    own whole chunks, int16 bf16 bits [k_d, nd·shard] (short chunks
    zero-padded); ``tiles[d]`` / ``weights[d]``: their tiles and weights
    (host values; a zero weight folds nothing). ``streams``: one per rank
    (CUDA only)."""
    nd, n_tiles, shard = _check_accs(accs)
    _check_chunks(accs, bits, tiles, weights, nd, shard)
    if accs[0].device.type == "cpu":
        ring_fold_plain(accs, bits, tiles, weights)
        return
    streams = _check_streams(streams, accs)
    uniq, metas = ring_slots(tiles, weights, n_tiles)
    if not uniq:
        return
    devs = [a.device for a in accs]
    meta = [torch.from_numpy(m).to(dev) for m, dev in zip(metas, devs)]
    # Two partial slots per rank: step s writes slot s % 2 and its right
    # neighbour reads it at step s + 1.
    bufs = [torch.empty((2, len(uniq), shard), dtype=torch.float32, device=dev) for dev in devs]
    _fork(streams, devs)
    prev: List[torch.cuda.Event] = []
    for s in range(nd):
        last = s == nd - 1
        cur = []
        for d in range(nd):
            left, right, st = (d - 1) % nd, (d + 1) % nd, streams[d]
            if s > 0:
                st.wait_event(prev[left])  # its partial of step s - 1
                if s >= 2 and not last:
                    st.wait_event(prev[right])  # done reading the slot step s overwrites
            b = (d - s - 1) % nd
            dst = accs[d] if last else bufs[d][s % 2]
            with torch.cuda.stream(st):
                _launch(
                    "ring_fold", devs[d],
                    bits[d].data_ptr() if bits[d].numel() else None, meta[d].data_ptr(),
                    bufs[left][(s - 1) % 2].data_ptr() if s > 0 else None, dst.data_ptr(),
                    b * shard, shard, nd * shard, len(uniq), bits[d].shape[0], int(last),
                    counts=LAUNCHES,
                )
                cur.append(_record(st))
        prev = cur
    _join(streams, devs)


def ring_allgather(
    accs: Sequence[torch.Tensor], streams: Optional[Sequence[Optional[torch.cuda.Stream]]] = None
) -> List[torch.Tensor]:
    """K7. Every rank's copy of the full accumulator [n_tiles, nd·shard]:
    nd − 1 hops, rank d pulling block (d − s − 1) mod nd from its left
    neighbour at hop s (from the neighbour's shard at hop 0, with its own
    shard copied in the same launch)."""
    nd, n_tiles, shard = _check_accs(accs)
    if accs[0].device.type == "cpu":
        return ring_allgather_plain(accs)
    streams = _check_streams(streams, accs)
    devs = [a.device for a in accs]
    width = nd * shard
    outs = [torch.empty((n_tiles, width), dtype=torch.float32, device=dev) for dev in devs]
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
            ring_fold(self._device_accs(), bits, tiles, weights, streams=self.codec.streams)
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
