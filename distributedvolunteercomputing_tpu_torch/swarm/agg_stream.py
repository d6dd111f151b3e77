"""Streaming chunk-aligned leader aggregation: decode/aggregate overlapped
with arrival, O(N·tile) in-flight memory for the elementwise estimators.

PR 2 made multi-MB contributions CROSS the wire as bounded chunk frames,
but the leader still materialized every peer's full dense f32 buffer before
any aggregation started, and the robust path then paid a second O(N·D) copy
via ``np.stack``. This module is the missing half of that pipeline: the
transport hands each verified contribution chunk to a per-round
``StreamingAggregator`` (via the request-sink plumbing in
``swarm/transport.py``), which decodes it and folds it in immediately —
aggregation overlaps arrival, and the deadline commit reduces to finishing
whatever tiles are still open.

Tiles are aligned 1:1 with the transport's wire chunks (``chunk_bytes``
bytes of f32/bf16 == ``chunk_bytes // esz`` elements), so "one verified
chunk" and "one tile row" are the same event — no re-buffering between the
framing layer and the math.

Aggregation modes, chosen by ``ops.robust.tile_mode(method)``:

- ``mean``     — each arriving chunk is axpy-accumulated straight into one
                 O(D) accumulator (``native.weighted_sum_inplace``) and its
                 bytes released; a per-tile float64 tally records the weight
                 that arrived for that tile, so the deadline commit is one
                 per-tile re-normalization. The leader never holds a
                 per-peer dense vector.
- ``window``   — coordinate-wise estimators (trimmed_mean, median) hold only
                 the in-flight ``[n_slots, tile]`` window per tile: a tile
                 aggregates on a worker thread the moment every armed peer's
                 copy of it has arrived (or at the deadline, over the
                 arrived subset). Peak memory O(N·tile), not O(N·D).
- ``d2_dense`` — krum/bulyan need full vectors for the selected rows, but
                 their O(n²·D) pairwise-distance pass is a sum over
                 coordinates: d² accumulates tile-by-tile as rows fill, so
                 the commit-time selection starts from a finished distance
                 matrix instead of recomputing it.
- ``dense``    — estimators that genuinely couple all coordinates
                 (geometric_median's Weiszfeld iterations, centered_clip's
                 full-vector L2 clipping) keep dense rows; they still gain
                 decode-on-arrival, just not the memory bound.

Partial-contribution semantics (the price of eager commitment): a streamed
contribution that ABORTS mid-payload (corrupt chunk, connection death) has
already folded its sealed tiles into the aggregate — un-doing an axpy needs
the data, which was deliberately released. The committed result is then a
PER-TILE partial-participation aggregate: each tile is a valid weighted
mean / robust estimate over exactly the peers whose copy of that tile
arrived intact. That is the deadline-commit contract applied per tile
rather than per round — every committed coordinate is still a convex
combination (or robust estimate) of honest inputs, and the aborting peer is
reported absent, so its shipped mass is never double-counted by error
feedback (the streaming wires, f32/bf16, carry no EF residual). A slot that
aborts before ANY tile committed is reset cleanly and may retry; one that
aborts after committing tiles is tainted for the round and later pushes
under its key are refused.

Tail-optimal hedged recovery (OptiReduce, PAPERS.md): beside the in-order
original stream, the aggregator accepts **hedged tile-range replies**
(``add_hedged``) — the leader re-requested a straggler's missing tiles over
a second stream (``sync.refetch``) or decoded them from a ring neighbor's
XOR redundancy sidecar. Hedged arrivals are idempotent by (slot, tile): a
per-(slot, tile) arrival bitmap is the single source of truth, so a hedge
and the original can never double-fold one tile, in either order. A slot
whose every tile landed — through any mix of sources — auto-seals; one
sealed with at least one hedged tile is classified ``recovered`` (not
``included``) in ``mass_report``, so the win is auditable per round.
Hedges never resurrect an aborted or tainted slot: replies for those are
counted (``hedge_dropped``) and discarded, and a fenced aggregator counts
hedged chunks with the same ``chunks_after_fence`` bookkeeping the
original stream gets. The per-slot arrival **scoreboard** (tiles present,
missing ranges, last-arrival age) is what the leader's hedge loop ranks
targets from.

Thread model: ``add_chunk``/``add_dense`` run on the event-loop thread (the
transport's frame reader) or an averager worker thread, serialized by one
lock; tile aggregation jobs run via ``asyncio.to_thread`` when a loop is
running (inline otherwise — unit tests stay deterministic); ``finalize``
awaits in-flight jobs, closes open windows over the arrived subsets, and
returns the committed buffer.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mesh_codec_mod
from distributedvolunteercomputing_tpu_torch.ops import robust
from distributedvolunteercomputing_tpu_torch.swarm import health as health_mod
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)

# Sentinel job queued alongside window-closure tuples: "flush the mesh
# mean folder's staged chunks on a worker" (see _spawn_jobs).
_FLUSH = object()


def encode_wire_elems(wire: str, x: np.ndarray) -> bytes:
    """f32 elements -> wire bytes for the elementwise wires (f32/bf16).

    The ONE home of the re-encode rule: the hedge/redundancy paths'
    bit-identical-reencode invariant (refetch serving, tail retention,
    XOR sidecars must all produce the exact bytes the original push
    carried) rests on every encoder agreeing, so there is exactly one."""
    x = np.ascontiguousarray(x, np.float32)
    if wire == "bf16":
        return native.f32_to_bf16(x).tobytes()
    return x.tobytes()


def wire_geometry(wire: str, chunk_bytes: int, n_elems: int) -> Tuple[int, int, int, int]:
    """(element size, chunk bytes, tile elems, n tiles) for an elementwise
    wire — THE tiling rule. The aggregator's bitmap, the refetch range
    RPC, and the redundancy sidecars all address tiles by it, so like
    ``encode_wire_elems`` it has exactly one home: a divergent copy would
    silently shift hedged folds across tile boundaries."""
    esz = 4 if wire == "f32" else 2
    tile_elems = max(int(chunk_bytes) // esz, 1)
    return esz, int(chunk_bytes), tile_elems, max(-(-int(n_elems) // tile_elems), 1)


class TilePool:
    """Reusable float32 scratch buffers, keyed by element count.

    Window buffers and decode staging churn one allocation per tile per
    peer per round without this; the pool caps held bytes so an unusually
    large round can't pin its high-water mark forever."""

    def __init__(self, max_bytes: int = 64 << 20):
        self._lock = threading.Lock()
        self._free: Dict[int, List[np.ndarray]] = {}
        self._held = 0
        self.max_bytes = int(max_bytes)
        self.hits = 0
        self.misses = 0

    def get(self, n_elems: int) -> np.ndarray:
        with self._lock:
            lst = self._free.get(n_elems)
            if lst:
                buf = lst.pop()
                self._held -= buf.nbytes
                self.hits += 1
                return buf
            self.misses += 1
        return np.empty(n_elems, np.float32)

    def put(self, buf: Optional[np.ndarray]) -> None:
        if buf is None or buf.dtype != np.float32:
            return
        with self._lock:
            if self._held + buf.nbytes > self.max_bytes:
                return
            self._free.setdefault(buf.size, []).append(buf)
            self._held += buf.nbytes

    @property
    def held_bytes(self) -> int:
        return self._held


# One process-wide pool: rounds come and go, the buffers stay warm.
_POOL = TilePool()


class _Window:
    """One tile's in-flight [n_slots, tile_elems] row window."""

    __slots__ = ("buf", "mask", "count")

    def __init__(self, buf: np.ndarray, n_slots: int):
        self.buf = buf  # flat pool buffer viewed as [n_slots, tile_elems]
        self.mask = np.zeros(n_slots, bool)
        self.count = 0


class ContributionSink:
    """Transport-facing request sink for ONE streamed contribution.

    The transport calls ``sink(offset, total, data)`` per verified chunk and
    ``sink.close(ok)`` exactly once when the frame completes or dies; both
    are forwarded to the aggregator with this contribution's slot."""

    __slots__ = ("_agg", "slot", "weight", "_on_done", "_closed")

    def __init__(
        self,
        agg: "StreamingAggregator",
        slot: int,
        weight: float,
        on_done: Optional[Callable[[bool], None]] = None,
    ):
        self._agg = agg
        self.slot = slot
        self.weight = float(weight)
        self._on_done = on_done
        self._closed = False

    def __call__(self, off: int, total: int, data: bytes) -> None:
        self._agg.add_chunk(self.slot, self.weight, off, data)

    def close(self, ok: bool) -> None:
        if self._closed:
            return
        self._closed = True
        done = self._agg.seal_slot(self.slot) if ok else False
        if not ok:
            self._agg.abort_slot(self.slot)
        if self._on_done is not None:
            try:
                self._on_done(ok and done)
            except Exception as e:  # noqa: BLE001 — a callback bug must not kill the frame reader
                log.debug("contribution sink callback failed: %s", errstr(e))


class StreamingAggregator:
    """Leader-side streaming aggregation state for one round.

    ``slots`` fixes the armed peer set (the round's members, leader
    included); every contribution is addressed by its slot index. The
    instance is safe for concurrent ``add_chunk``/``add_dense``/``abort``
    from the loop thread and worker threads; ``finalize`` is async and must
    be called exactly once, after which the committed buffer is returned
    and all transient tiles are back in the pool."""

    def __init__(
        self,
        n_elems: int,
        slots: List[str],
        method: str,
        wire: str,
        chunk_bytes: int,
        kw_fn: Optional[Callable[[int], dict]] = None,
        pool: Optional[TilePool] = None,
        codec: Optional[mesh_codec_mod.MeshCodec] = None,
        telemetry=None,
        tail_keep_tiles: int = 0,
    ):
        if wire not in ("f32", "bf16"):
            raise ValueError(f"streaming aggregation needs an elementwise wire, got {wire!r}")
        esz, _, tile_elems, n_tiles = wire_geometry(wire, chunk_bytes, n_elems)
        if chunk_bytes % esz:
            raise ValueError(f"chunk_bytes {chunk_bytes} not {wire} element-aligned")
        self.n_elems = int(n_elems)
        self.wire = wire
        self.esz = esz
        self.chunk_bytes = int(chunk_bytes)
        self.tile_elems = tile_elems
        self.n_tiles = n_tiles
        self.method = method
        self.mode = robust.tile_mode(method)
        self._kw_fn = kw_fn or (lambda n: {})
        self.slots = list(slots)
        self.slot_index = {p: i for i, p in enumerate(self.slots)}
        self.pool = pool or _POOL
        n = len(self.slots)

        self._lock = threading.Lock()
        self.frozen = False
        self._weights: Dict[int, float] = {}  # slot -> folded weight
        self._aborted: Set[int] = set()
        self._tainted: Set[int] = set()
        self._sealed: Set[int] = set()  # slots whose full vector landed
        self._filled = np.zeros(n, np.int64)  # elements received per slot
        self._committed_tiles = np.zeros(n, np.int64)  # tiles folded per slot
        self._tasks: List[asyncio.Task] = []
        # -- tail-optimal hedged recovery state --------------------------
        # The per-(slot, tile) arrival bitmap is the idempotency ledger:
        # one True per tile per slot, set by WHICHEVER source folds it
        # first (original stream, hedged range reply, redundancy decode),
        # checked by every other. _filled stays the ORIGINAL stream's
        # in-order cursor; completeness is _tiles_got == n_tiles.
        self._tile_have = np.zeros((n, self.n_tiles), bool)
        self._tile_hedged = np.zeros((n, self.n_tiles), bool)
        self._tiles_got = np.zeros(n, np.int64)
        self._hedged_tiles = np.zeros(n, np.int64)  # hedge/redund-folded
        # Per-slot arrival timing for the scoreboard (monotonic seconds
        # since t0): first and latest tile arrival from ANY source.
        self._first_at = np.full(n, -1.0)
        self._last_at = np.full(n, -1.0)
        # Seal latency per slot (seconds since arming) — the leader feeds
        # these to the resilience policy's per-peer tail quantiles.
        self._seal_at: Dict[int, float] = {}
        # Summand redundancy: raw wire bytes of the last ``tail_keep_tiles``
        # tiles are retained per (slot, tile) so an XOR sidecar from a ring
        # neighbor can be decoded against the neighbor's own delivered tail
        # at commit time. 0 = retain nothing (redundancy off).
        self.tail_keep_tiles = int(tail_keep_tiles)
        self._tail_bytes: Dict[Tuple[int, int], bytes] = {}

        self._tile_w: Optional[np.ndarray] = None
        self._windows: Dict[int, _Window] = {}
        self._win_done = np.zeros(self.n_tiles, bool)
        # Window mode: complete dense contributions (the leader's own, a
        # parked pre-arming buffer) are held as BORROWED references whose
        # rows copy into a window lazily when a streamed chunk opens it —
        # a dense feed must not materialize every window up front, or the
        # peak regresses to O(N·D) the moment the leader feeds itself.
        self._resident: Dict[int, np.ndarray] = {}
        self._rows: Dict[int, np.ndarray] = {}
        self._d2: Optional[np.ndarray] = None
        self._tile_sealed: Dict[int, List[int]] = {}
        # On-mesh data path: window folds and the mean accumulator run on
        # the volunteer's local device mesh when the codec is active; the
        # host numpy path is both the default (CPU platform) and the
        # degraded-slice fallback (ops.mesh_codec module doc).
        self.codec = codec if codec is not None else mesh_codec_mod.get_default()
        self._folder: Optional[mesh_codec_mod.MeshMeanFolder] = None
        self.folder_flushes = 0
        # Captured from the folder before release() drops it, so the gauges
        # can still say which fold path served a COMMITTED round.
        self.folder_kind = ""
        self.ring_flushes = 0
        # Folder staged-bytes high-water, captured before the folder is
        # dropped (summed into the peak gauge: staged raw chunks are real
        # resident memory beside the accumulator).
        self._folder_staged_peak = 0
        if self.mode == "mean":
            self._tile_w = np.zeros(self.n_tiles, np.float64)
            self._folder = self.codec.mean_folder(
                self.n_elems, self.tile_elems, self.n_tiles, wire
            )
            self.folder_kind = getattr(self._folder, "kind", "")
        elif self.mode == "d2_dense":
            self._d2 = np.zeros((n, n), np.float64)
        # The committed/result buffer is O(D) — except in mean+folder mode,
        # where the DEVICE accumulator plays that role until finalize pulls
        # it: an eager host zeros there would be O(D) counted-but-never-
        # written memory.
        self._out = (
            np.zeros(0, np.float32) if self._folder is not None
            else np.zeros(self.n_elems, np.float32)
        )

        # Telemetry plane (swarm/telemetry.py): per-tile fold latency lands
        # in the unified registry's ``swarm.tile_fold_seconds`` histogram —
        # the in-pipeline evidence behind the leader's ``fold`` span.
        self._tile_hist = (
            telemetry.registry.histogram(
                "swarm.tile_fold_seconds", "window-tile aggregation latency"
            )
            if telemetry is not None and getattr(telemetry, "enabled", False)
            else None
        )
        # Training-health layer (swarm/health.py): per-slot squared
        # distance to the robust aggregate, accumulated tile-by-tile as
        # windows close — the raw material for per-peer contribution-
        # quality attribution. Needs per-peer rows next to the aggregate,
        # so the mean mode (rows released on arrival) can't attribute.
        health = getattr(telemetry, "health", None) if telemetry is not None else None
        self._quality_on = bool(
            health is not None
            and getattr(health, "enabled", False)
            and self.mode != "mean"
        )
        self._q_d2: Dict[int, float] = {}  # slot -> summed d² vs aggregate

        # -- gauges (surfaced via Averager.stats()/volunteer summary) ------
        self.t0 = time.monotonic()
        self.tiles_early = 0  # window tiles aggregated while arrivals were still in flight
        self.tiles_deadline = 0  # window tiles closed over a subset at finalize
        self.busy_s = 0.0  # seconds spent inside aggregation math
        self.streamed_contribs = 0
        self.dense_contribs = 0
        self.aborted_contribs = 0
        # Hedged-recovery gauges: tiles folded from a hedge/redundancy
        # source, hedge replies for tiles that had already landed (wasted
        # wire bytes — the AIMD budget's decrease signal), and replies
        # refused outright (aborted/tainted slot, frozen round).
        self.tiles_recovered = 0
        self.hedge_duplicates = 0
        self.hedge_dropped = 0
        # Leader-failover fencing: True once this aggregator was superseded
        # by a newer round generation (fence()). Chunks that still arrive —
        # a stale sink flushing after its round was deposed — are counted,
        # never folded.
        self.fenced = False
        self.chunks_after_fence = 0
        self._held = self._out.nbytes
        if self._folder is not None:
            # The device-resident accumulator counts against the round's
            # held bytes like any other O(D) state.
            self._held += self._folder.device_bytes
        self.peak_bytes_held = self._held

    # -- memory accounting --------------------------------------------------

    def _note_alloc(self, nbytes: int) -> None:
        self._held += nbytes
        if self._held > self.peak_bytes_held:
            self.peak_bytes_held = self._held

    def _note_free(self, nbytes: int) -> None:
        self._held -= nbytes

    # -- decode ---------------------------------------------------------------

    def _decode(self, data: bytes, out: Optional[np.ndarray] = None) -> np.ndarray:
        if self.wire == "f32":
            x = np.frombuffer(data, np.float32)
            if out is not None:
                out[: x.size] = x
                return out[: x.size]
            return x
        bits = np.frombuffer(data, np.uint16)
        if out is not None:
            return native.bf16_to_f32(bits, out=out[: bits.size])
        return native.bf16_to_f32(bits)

    def _encode_elems(self, x: np.ndarray) -> bytes:
        """f32 elements back to this round's wire form (the inverse of
        _decode; bit-identical for already-roundtripped values)."""
        return encode_wire_elems(self.wire, x)

    # -- sink construction ----------------------------------------------------

    def make_sink(
        self, peer: str, weight: float, total: int,
        on_done: Optional[Callable[[bool], None]] = None,
    ) -> Optional[ContributionSink]:
        """A transport request sink for ``peer``'s streamed contribution, or
        None when this round can't stream it (wrong size, frozen round,
        tainted slot, unknown peer)."""
        slot = self.slot_index.get(peer)
        if slot is None or total != self.n_elems * self.esz:
            return None
        w = float(weight)
        if not np.isfinite(w) or w <= 0:
            return None
        with self._lock:
            if self.frozen or slot in self._tainted or slot in self._sealed:
                return None
            if slot in self._aborted:
                # A cleanly-reset abort (nothing committed) may retry.
                self._aborted.discard(slot)
                self._filled[slot] = 0
            self._weights[slot] = w
        return ContributionSink(self, slot, w, on_done)

    def taints(self, peer: str) -> bool:
        """True when ``peer``'s earlier streamed push committed tiles and
        then died: a later (dense or streamed) contribution under this key
        can no longer enter the round coherently."""
        slot = self.slot_index.get(peer)
        return slot is not None and slot in self._tainted

    # -- ingestion ------------------------------------------------------------

    def add_chunk(self, slot: int, weight: float, off: int, data: bytes) -> None:
        """Fold one verified wire chunk (``off`` in wire-byte space, always
        chunk-aligned by the transport's framing) for ``slot``."""
        total = self.n_elems * self.esz
        if (
            not data
            or off % self.chunk_bytes
            or len(data) != min(self.chunk_bytes, total - off)
        ):
            # Exact-length contract: a sender whose chunk_bytes differs from
            # this aggregator's (version skew, custom embedding) would
            # otherwise fold data across tile boundaries while crediting
            # weight to one tile — silent corruption. Chunk size is a
            # per-Transport constant, never negotiated on the wire, so the
            # only safe response to a mismatch is to poison the slot BEFORE
            # anything folds.
            self.abort_slot(slot)
            return
        tile = off // self.chunk_bytes
        e0 = tile * self.tile_elems
        n = len(data) // self.esz
        fire: List[tuple] = []
        with self._lock:
            if self.fenced:
                self.chunks_after_fence += 1
                return
            if self.frozen or slot in self._aborted or slot in self._tainted:
                return
            if self._filled[slot] != e0:
                # Chunks arrive strictly in order per contribution; a gap
                # means a retry raced an earlier stream — refuse the slot.
                self._aborted.add(slot)
                if self._committed_tiles[slot]:
                    self._tainted.add(slot)
                return
            self._filled[slot] = e0 + n
            if self._tile_have[slot, tile]:
                # A hedged reply folded this tile first: the bitmap wins.
                # The in-order cursor still advances (the stream stays in
                # sync); the redundant copy is the hedge's wasted bytes.
                self.hedge_duplicates += 1
                self._note_arrival_locked(slot)
                return
            t0 = time.perf_counter()
            self._fold_tile_locked(slot, weight, tile, e0, n, data, fire)
            self._mark_tile_locked(slot, tile, hedged=False)
            self.busy_s += time.perf_counter() - t0
        self._spawn_jobs(fire)

    def _fold_tile_locked(
        self, slot: int, weight: float, tile: int, e0: int, n: int,
        data: bytes, fire: List, *, hedged: bool = False,
    ) -> None:
        """Fold one verified tile's wire bytes for ``slot`` — the shared
        body behind the original stream (add_chunk) and hedged replies
        (add_hedged). Caller holds the lock and has already established
        the (slot, tile) is unfolded."""
        if self.mode == "mean":
            if self._folder is not None:
                # On-mesh: stage the RAW wire bytes (no decode on the
                # frame-reader thread); a worker flushes staged batches
                # through one fused device decode+scatter-add.
                if self._folder.add(tile, weight, data):
                    fire.append(_FLUSH)
            else:
                x = self._decode(data)
                native.weighted_sum_inplace(self._out[e0 : e0 + n], x, weight)
            self._tile_w[tile] += weight
            self._committed_tiles[slot] += 1
            if not hedged:
                # "Folded while the push was in flight" — a hedged tile
                # is counted under tiles_recovered instead, never both.
                self.tiles_early += 1
        elif self.mode == "window":
            self._window_row(slot, tile, self._decode(data), n, fire)
        else:  # d2_dense / dense
            row = self._row_buffer(slot)
            self._decode(data, out=row[e0:])
            self._committed_tiles[slot] += 1
            if self.mode == "d2_dense":
                self._accumulate_d2(slot, tile, e0, e0 + n)
        if self.tail_keep_tiles and tile >= self.n_tiles - self.tail_keep_tiles:
            # Summand redundancy: tail tiles double as XOR-decode keys for
            # a ring neighbor's sidecar, so their wire bytes are retained
            # (bounded: tail_keep_tiles x chunk_bytes per slot).
            self._tail_bytes[(slot, tile)] = bytes(data)

    def _note_arrival_locked(self, slot: int) -> None:
        now = time.monotonic() - self.t0
        if self._first_at[slot] < 0:
            self._first_at[slot] = now
        self._last_at[slot] = now

    def _mark_tile_locked(self, slot: int, tile: int, *, hedged: bool) -> None:
        """Record one folded (slot, tile) in the idempotency bitmap and
        auto-seal the slot the moment its last tile lands — completeness
        is tile-count, not the in-order cursor, so a contribution finished
        by hedged replies seals exactly like a purely-streamed one.
        Caller holds the lock."""
        self._tile_have[slot, tile] = True
        self._tiles_got[slot] += 1
        self._note_arrival_locked(slot)
        if hedged:
            self._tile_hedged[slot, tile] = True
            self._hedged_tiles[slot] += 1
            self.tiles_recovered += 1
        if (
            self._tiles_got[slot] == self.n_tiles
            and slot not in self._sealed
            and slot not in self._aborted
            and slot not in self._tainted
        ):
            self._sealed.add(slot)
            self._seal_at[slot] = self._last_at[slot]
            self.streamed_contribs += 1

    def add_hedged(
        self, peer: str, weight: float, off: int, data: bytes,
        *, source: str = "refetch",
    ) -> int:
        """Fold one hedged tile reply (a ``sync.refetch`` range chunk or a
        redundancy-sidecar decode) for ``peer``. Idempotent by (slot,
        tile): a tile the original stream (or an earlier hedge) already
        folded is counted as a duplicate and discarded — a hedge and the
        original can never double-fold. Unlike the original stream, a
        malformed reply only drops itself (the healthy original must not
        be poisoned by a bad hedge), and an aborted/tainted slot is never
        resurrected. Returns 1 when the tile folded, 0 otherwise."""
        slot = self.slot_index.get(peer)
        total = self.n_elems * self.esz
        if (
            slot is None
            or not data
            or off % self.chunk_bytes
            or off >= total
            or len(data) != min(self.chunk_bytes, total - off)
        ):
            with self._lock:
                self.hedge_dropped += 1
            return 0
        tile = off // self.chunk_bytes
        e0 = tile * self.tile_elems
        n = len(data) // self.esz
        fire: List[tuple] = []
        with self._lock:
            if self.fenced:
                self.chunks_after_fence += 1
                return 0
            if self.frozen or slot in self._aborted or slot in self._tainted:
                self.hedge_dropped += 1
                return 0
            if slot in self._sealed or self._tile_have[slot, tile]:
                self.hedge_duplicates += 1
                return 0
            w = self._weights.get(slot)
            if w is None:
                # A silent straggler never declared a weight; the refetch
                # reply carries the one its push would have (first write
                # wins — a started stream's declared weight is kept).
                w = float(weight)
                if not np.isfinite(w) or w <= 0:
                    self.hedge_dropped += 1
                    return 0
                self._weights[slot] = w
            t0 = time.perf_counter()
            self._fold_tile_locked(slot, w, tile, e0, n, data, fire, hedged=True)
            self._mark_tile_locked(slot, tile, hedged=True)
            self.busy_s += time.perf_counter() - t0
        self._spawn_jobs(fire)
        return 1

    def _spawn_jobs(self, fire: List) -> None:
        """Spawn queued aggregation work OUTSIDE the lock: window-closure
        tuples from _fire_locked, or the _FLUSH sentinel for the mesh mean
        folder."""
        folder = self._folder
        for job in fire:
            if job is _FLUSH:
                if folder is not None:  # raced a release(): nothing to flush
                    self._spawn(folder.flush)
            else:
                t, w, r = job
                self._spawn(lambda tt=t, ww=w, rr=r: self._aggregate_window(tt, ww, rr))

    def add_dense(self, peer: str, weight: float, buf: np.ndarray) -> bool:
        """Fold a complete dense contribution (the leader's own, a parked
        pre-arming buffer, or an inline sub-chunk payload). Returns False —
        contribution NOT folded — once the round is frozen."""
        slot = self.slot_index.get(peer)
        if slot is None or buf.size != self.n_elems:
            return False
        w = float(weight)
        fire: List[tuple] = []
        with self._lock:
            if self.frozen or slot in self._aborted or slot in self._tainted or slot in self._sealed:
                return False
            # Tiles a hedged reply (or an aborted-then-retried stream's
            # surviving bitmap) already folded must not fold again: the
            # dense feed covers exactly the MISSING tiles. The common case
            # (no prior tile state) reduces to the whole-vector fast path.
            partial = bool(self._tiles_got[slot])
            w = float(self._weights.get(slot, w))
            t0 = time.perf_counter()
            if self.mode == "mean":
                if self._folder is not None:
                    if partial:
                        # The device folder stages whole vectors only; a
                        # per-tile dense backfill under it would need wire
                        # re-encoding on the loop thread. Rare (auth +
                        # hedge overlap) — refuse, the hedges own the slot.
                        return False
                    self._folder.add_dense(buf, w)
                    self._tile_w += w
                    self._committed_tiles[slot] += self.n_tiles
                elif partial:
                    b32 = np.ascontiguousarray(buf, np.float32)
                    for tile in range(self.n_tiles):
                        if self._tile_have[slot, tile]:
                            continue
                        e0 = tile * self.tile_elems
                        e1 = min(e0 + self.tile_elems, self.n_elems)
                        native.weighted_sum_inplace(self._out[e0:e1], b32[e0:e1], w)
                        self._tile_w[tile] += w
                        self._committed_tiles[slot] += 1
                else:
                    native.weighted_sum_inplace(
                        self._out, np.ascontiguousarray(buf, np.float32), w
                    )
                    self._tile_w += w
                    self._committed_tiles[slot] += self.n_tiles
            elif self.mode == "window":
                # Borrowed reference, not a copy: rows flow into windows
                # lazily (open ones now, future ones at creation, the rest
                # at finalize). A tile that already aggregated EARLY before
                # this feed excludes it — the same per-tile participation
                # contract streamed stragglers get.
                ref = np.ascontiguousarray(buf, np.float32)
                self._resident[slot] = ref
                for tile, win in list(self._windows.items()):
                    if win.mask[slot]:
                        continue
                    e0 = tile * self.tile_elems
                    n = min(self.tile_elems, self.n_elems - e0)
                    row0 = slot * self.tile_elems
                    win.buf[row0 : row0 + n] = ref[e0 : e0 + n]
                    win.mask[slot] = True
                    win.count += 1
                    if win.count >= self._active_slots():
                        fire.append(self._fire_locked(tile, win, early=True))
            else:
                row = self._row_buffer(slot)
                row[:] = buf
                for tile in range(self.n_tiles):
                    if self._tile_have[slot, tile]:
                        continue  # hedge-folded: d2/commit already counted
                    self._committed_tiles[slot] += 1
                    if self.mode == "d2_dense":
                        e0 = tile * self.tile_elems
                        self._accumulate_d2(
                            slot, tile, e0, min(e0 + self.tile_elems, self.n_elems)
                        )
            if self.tail_keep_tiles:
                # Retain the tail tiles' WIRE form (re-encoded from the
                # dense feed — bit-identical for f32/bf16 roundtrips) so
                # this slot can serve as a ring neighbor's XOR-decode key.
                b32 = np.ascontiguousarray(buf, np.float32)
                for tile in range(self.n_tiles - self.tail_keep_tiles, self.n_tiles):
                    if tile < 0 or (slot, tile) in self._tail_bytes:
                        continue
                    e0 = tile * self.tile_elems
                    e1 = min(e0 + self.tile_elems, self.n_elems)
                    self._tail_bytes[(slot, tile)] = self._encode_elems(b32[e0:e1])
            self.busy_s += time.perf_counter() - t0
            self._filled[slot] = self.n_elems
            self._tile_have[slot, :] = True
            self._tiles_got[slot] = self.n_tiles
            self._note_arrival_locked(slot)
            self._sealed.add(slot)
            self._seal_at.setdefault(slot, self._last_at[slot])
            self._weights[slot] = w
            self.dense_contribs += 1
        self._spawn_jobs(fire)
        return True

    def seal_slot(self, slot: int) -> bool:
        """Mark a streamed contribution complete; False when it didn't
        actually deliver every element (short stream). Completeness is
        TILE count, not the in-order cursor: a contribution whose tail a
        hedge delivered seals (auto-sealed by the last fold already; this
        just confirms it to the sink lifecycle)."""
        with self._lock:
            if slot in self._aborted or slot in self._tainted:
                return False
            if slot in self._sealed:
                return True
            if self._tiles_got[slot] != self.n_tiles:
                return False
            # Unreachable in practice (_mark_tile_locked auto-seals at the
            # last fold) — kept as the sink lifecycle's backstop.
            self._sealed.add(slot)
            self._seal_at.setdefault(slot, time.monotonic() - self.t0)
            self.streamed_contribs += 1
            return True

    def abort_slot(self, slot: int) -> None:
        """A streamed contribution died mid-payload. Tiles it already
        committed stand (per-tile participation, module doc); open window
        rows are withdrawn; a slot with committed tiles is tainted."""
        fire: List[tuple] = []
        with self._lock:
            if slot in self._aborted or slot in self._sealed or self.frozen:
                self._aborted.add(slot)
                return
            self._aborted.add(slot)
            self.aborted_contribs += 1
            if self.mode in ("mean", "window") and self._committed_tiles[slot]:
                # Irreversibly folded tiles (axpy'd / aggregated): the slot
                # can't coherently re-enter this round.
                self._tainted.add(slot)
            if self.mode in ("d2_dense", "dense"):
                # Nothing irreversible happened (rows are retained until
                # finalize): a retry starts clean — including the tile
                # bitmap, or the retry's chunks would read as duplicates.
                self._committed_tiles[slot] = 0
                self._tile_have[slot, :] = False
                self._tile_hedged[slot, :] = False
                self._tiles_got[slot] = 0
                self._hedged_tiles[slot] = 0
            if self.mode == "window":
                for tile, win in self._windows.items():
                    if win.mask[slot]:
                        win.mask[slot] = False
                        win.count -= 1
                        # Withdrawn rows leave the idempotency bitmap too:
                        # only CLOSED tiles stand, and a clean retry's
                        # chunks must not read as duplicates.
                        if self._tile_have[slot, tile]:
                            self._tile_have[slot, tile] = False
                            self._tiles_got[slot] -= 1
                            if self._tile_hedged[slot, tile]:
                                self._tile_hedged[slot, tile] = False
                                self._hedged_tiles[slot] -= 1
                # Its absence may be exactly what held the remaining
                # windows open — re-check the early-fire condition.
                active = self._active_slots()
                for tile, win in list(self._windows.items()):
                    if win.count and win.count >= active:
                        fire.append(self._fire_locked(tile, win, early=True))
            elif self.mode in ("d2_dense", "dense"):
                row = self._rows.pop(slot, None)
                if row is not None:
                    self._note_free(row.nbytes)
                    self.pool.put(row)
                # Withdraw its pairwise-d² participation so a clean retry
                # can't double-accumulate pairs it already contributed.
                for peers in self._tile_sealed.values():
                    if slot in peers:
                        peers.remove(slot)
                if self._d2 is not None:
                    self._d2[slot, :] = 0.0
                    self._d2[:, slot] = 0.0
        self._spawn_jobs(fire)

    # -- internals ------------------------------------------------------------

    def _active_slots(self) -> int:
        return len(self.slots) - len(self._aborted)

    def _row_buffer(self, slot: int) -> np.ndarray:
        row = self._rows.get(slot)
        if row is None:
            row = self.pool.get(self.n_elems)
            self._note_alloc(row.nbytes)
            self._rows[slot] = row
        return row

    def _fire_locked(self, tile: int, win: _Window, early: bool):
        """Commit one window's CLOSURE atomically (caller holds the lock):
        the tile is done, its rows are committed, and the window leaves the
        in-flight dict — all before the aggregation math runs, so neither
        an abort nor a clean-retry re-stream can reopen or double-count the
        tile while the worker job is still in flight. Returns the job args
        for the caller to spawn OUTSIDE the lock."""
        self._windows.pop(tile, None)
        self._win_done[tile] = True
        rows = np.flatnonzero(win.mask)
        self._committed_tiles[rows] += 1
        if early:
            self.tiles_early += 1
        else:
            self.tiles_deadline += 1
        return (tile, win, rows)

    def _window_row(
        self, slot: int, tile: int, x: np.ndarray, n: int,
        fire: List[tuple],
    ) -> None:
        """Place one decoded tile row; when every active slot has
        contributed it, close the window (atomically, via _fire_locked) and
        queue its aggregation job on ``fire`` for the caller to spawn
        OUTSIDE the lock. Caller holds the lock."""
        if self._win_done[tile]:
            return  # tile already closed (late row after an early fire)
        win = self._windows.get(tile)
        if win is None:
            flat = self.pool.get(len(self.slots) * self.tile_elems)
            self._note_alloc(flat.nbytes)
            win = self._windows[tile] = _Window(flat, len(self.slots))
            # Seed the new window with every resident dense contribution.
            e0 = tile * self.tile_elems
            for rslot, ref in self._resident.items():
                if rslot == slot or rslot in self._aborted:
                    continue
                rn = min(self.tile_elems, self.n_elems - e0)
                win.buf[rslot * self.tile_elems : rslot * self.tile_elems + rn] = (
                    ref[e0 : e0 + rn]
                )
                win.mask[rslot] = True
                win.count += 1
        win.buf[slot * self.tile_elems : slot * self.tile_elems + n] = x[:n]
        if not win.mask[slot]:
            win.mask[slot] = True
            win.count += 1
        if win.count >= self._active_slots():
            fire.append(self._fire_locked(tile, win, early=True))

    def _aggregate_window(self, tile: int, win: _Window, rows: np.ndarray) -> None:
        """The aggregation math for one ALREADY-CLOSED tile (closure —
        done flag, committed rows — happened in _fire_locked): robust-
        aggregate the arrived rows into the output slice, return the window
        buffer to the pool. Runs on a worker thread when a loop is
        available; an exception here propagates out of finalize() and fails
        the round rather than committing a silently-zeroed tile."""
        t0 = time.perf_counter()
        e0 = tile * self.tile_elems
        n = min(self.tile_elems, self.n_elems - e0)
        q: Optional[np.ndarray] = None
        try:
            if rows.size:
                stack = win.buf[: len(self.slots) * self.tile_elems].reshape(
                    len(self.slots), self.tile_elems
                )[rows, :n]
                kw = self._kw_fn(rows.size)
                # On-mesh window fold when the codec is active (sorting
                # network over the peer axis); ops.robust numpy otherwise.
                agg = self.codec.aggregate(
                    np.ascontiguousarray(stack), self.method, **kw
                )
                self._out[e0 : e0 + n] = agg
                if self._quality_on and rows.size >= 3:
                    # Quality attribution: each arrived row's squared
                    # distance to the tile's robust aggregate — one extra
                    # O(rows·tile) pass next to the fold's sort, gated off
                    # with the health probe.
                    q = health_mod.row_d2(stack, agg)
        finally:
            dt = time.perf_counter() - t0
            if self._tile_hist is not None:
                self._tile_hist.observe(dt, method=self.method)
            with self._lock:
                self.busy_s += dt
                if q is not None:
                    for slot, d2 in zip(rows, q):
                        self._q_d2[int(slot)] = self._q_d2.get(int(slot), 0.0) + float(d2)
                self._note_free(win.buf.nbytes)
                self.pool.put(win.buf)

    def _accumulate_d2(self, slot: int, tile: int, e0: int, e1: int) -> None:
        """Tile-wise pairwise squared-distance accumulation (krum/bulyan):
        d² is a plain sum over coordinates, so each sealed tile adds its
        partial distances against every slot that already sealed the same
        tile. Caller holds the lock.

        Streamed chunks run this inline on the event loop — ms-scale per
        chunk (one tile × already-sealed peers), amortized across arrival,
        and a deferred job could race abort's row-withdrawal/pool-reuse.
        The O(n·D) dense feeds land via asyncio.to_thread at the call
        sites, so the loop never eats a whole contribution's d² at once."""
        peers = self._tile_sealed.setdefault(tile, [])
        a64 = self._rows[slot][e0:e1].astype(np.float64)
        for other in peers:
            if other == slot:
                continue
            b_row = self._rows.get(other)
            if b_row is None:
                continue
            d = a64 - b_row[e0:e1]
            v = float(np.dot(d, d))
            self._d2[slot, other] += v
            self._d2[other, slot] += v
        peers.append(slot)

    def _spawn(self, fn: Callable[[], None]) -> None:
        """Run an aggregation job off the event loop when one is running,
        inline otherwise (synchronous tests, worker-thread callers)."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            fn()
            return
        task = loop.create_task(asyncio.to_thread(fn))
        self._tasks.append(task)

    # -- commit ---------------------------------------------------------------

    def freeze(self) -> None:
        """Stop accepting contributions (the deadline hit): later chunks and
        dense feeds become no-ops. ``finalize`` then closes what's open —
        split from it so the caller can fix round membership between the
        two without racing in-flight feeds.

        Fully-delivered streams whose close() hasn't run yet (the commit
        can interleave with a frame's trailing-MAC read) are auto-sealed:
        every chunk CRC-verified and folded, so the mass IS in the
        aggregate — the peer must be reported included, not absent."""
        with self._lock:
            self.frozen = True
            for slot in range(len(self.slots)):
                if (
                    slot not in self._sealed
                    and slot not in self._aborted
                    and slot not in self._tainted
                    and self._tiles_got[slot] == self.n_tiles
                ):
                    self._sealed.add(slot)
                    self._seal_at.setdefault(slot, time.monotonic() - self.t0)
                    self.streamed_contribs += 1

    def fence(self) -> None:
        """Supersede this aggregator under a newer round generation (leader
        failover re-arm over the same epoch): freeze, return every
        transient buffer to the pool, and from here on COUNT — never fold —
        any chunk a stale sink still delivers. The partially-committed
        tiles this aggregator holds are abandoned with it; the recovery
        round re-collects the same contributions into a fresh aggregator,
        so no half-folded mass from the deposed generation can leak into
        the recovered result."""
        with self._lock:
            self.fenced = True
        self.release()

    def progress(self) -> Dict[str, int]:
        """Per-peer elements received so far (streamed or dense) — the
        mid-round visibility probe failover phase instrumentation and the
        chaos campaign read to tell 'pre-arm' from 'mid-stream'."""
        with self._lock:
            return {p: int(self._filled[i]) for i, p in enumerate(self.slots)}

    def weight_of(self, peer: str) -> float:
        """The weight a peer's contribution was folded with (0.0 if it
        never fed this round)."""
        slot = self.slot_index.get(peer)
        with self._lock:
            return float(self._weights.get(slot, 0.0)) if slot is not None else 0.0

    def included_peers(self) -> List[str]:
        """Peers whose COMPLETE contribution entered the aggregate."""
        with self._lock:
            return [self.slots[s] for s in sorted(self._sealed)]

    def mass_report(self, shard_of: Optional[Dict[str, int]] = None) -> dict:
        """Balanced gradient-mass classification for this round (training-
        health layer, swarm/health.py): every armed slot lands in exactly
        one of included (sealed purely by its own stream) / recovered
        (sealed with at least one hedge/redundancy-folded tile — the
        tail-optimal pipeline's auditable win) / aborted (died mid-payload
        or tainted) / excluded (never sealed by the freeze — late,
        partial, or silent), with the weight it DECLARED (0 for a slot
        that never spoke — its undelivered mass is unknowable to the
        leader, so it balances as one excluded slot at weight 0).
        included + recovered + excluded + aborted weight sums to the total
        armed weight by construction; the property test exercises the
        classification across the deadline / abort / hedge / fence
        matrix.

        ``shard_of`` (zone-sharded training) tags each peer's entry with
        its shard domain so ``health.mass_by_shard`` can roll the buckets
        up per shard — a shard-holder death then shows as mass moving to
        recovered/excluded in ONE shard's bucket, not as a fleet-wide
        dip. Peers absent from the map are left untagged."""
        with self._lock:
            per_peer: Dict[str, dict] = {}
            for slot, pid in enumerate(self.slots):
                w = float(self._weights.get(slot, 0.0))
                if slot in self._sealed:
                    oc = "recovered" if self._hedged_tiles[slot] else "included"
                elif slot in self._aborted or slot in self._tainted:
                    oc = "aborted"
                else:
                    oc = "excluded"
                per_peer[pid] = {"outcome": oc, "weight": w}
                if shard_of is not None and pid in shard_of:
                    per_peer[pid]["shard"] = int(shard_of[pid])
        return health_mod.mass_report_from_per_peer(per_peer)

    # -- tail-optimal hedged recovery surface --------------------------------

    def scoreboard(self) -> Dict[str, dict]:
        """Per-peer tile-arrival scoreboard — what the leader's hedge loop
        ranks re-request targets from. ``missing`` is the contiguous
        [t0, t1) tile ranges not yet folded from any source;
        ``last_arrival_age_s`` is None until the slot's first tile."""
        now = time.monotonic() - self.t0
        with self._lock:
            out: Dict[str, dict] = {}
            for slot, pid in enumerate(self.slots):
                last = self._last_at[slot]
                out[pid] = {
                    "tiles_got": int(self._tiles_got[slot]),
                    "n_tiles": self.n_tiles,
                    "hedged_tiles": int(self._hedged_tiles[slot]),
                    "sealed": slot in self._sealed,
                    "aborted": slot in self._aborted or slot in self._tainted,
                    "started": bool(self._first_at[slot] >= 0.0),
                    "last_arrival_age_s": (
                        round(now - last, 6) if last >= 0.0 else None
                    ),
                    "missing": self._missing_ranges_locked(slot),
                }
            return out

    def _missing_ranges_locked(self, slot: int) -> List[Tuple[int, int]]:
        # Fast paths first: the hedge loop polls this under the ingest
        # lock every ~200 ms, and most slots are either COMPLETE (sealed/
        # dense) or UNTOUCHED (silent) — neither needs the bitmap scan
        # (at 1e6 tiles the flatnonzero temp alone is MBs per slot).
        got = int(self._tiles_got[slot])
        if got == self.n_tiles:
            return []
        if got == 0:
            return [(0, self.n_tiles)]
        missing = np.flatnonzero(~self._tile_have[slot])
        if missing.size == 0:
            return []
        ranges: List[Tuple[int, int]] = []
        start = prev = int(missing[0])
        for t in missing[1:]:
            t = int(t)
            if t == prev + 1:
                prev = t
                continue
            ranges.append((start, prev + 1))
            start = prev = t
        ranges.append((start, prev + 1))
        return ranges

    def tail_bytes(self, peer: str, tile: int) -> Optional[bytes]:
        """The retained wire bytes of one of ``peer``'s tail tiles (None
        unless redundancy retention covered it and the tile arrived) —
        the XOR-decode key for a ring neighbor's sidecar."""
        slot = self.slot_index.get(peer)
        if slot is None:
            return None
        with self._lock:
            return self._tail_bytes.get((slot, tile))

    def seal_latencies(self) -> Dict[str, float]:
        """Seconds from arming to each sealed contribution's completion —
        the leader feeds these into the resilience policy's per-peer tail
        quantiles (the hedge-target ranking evidence)."""
        with self._lock:
            return {
                self.slots[s]: round(dt, 6) for s, dt in self._seal_at.items()
            }

    def hedge_stats(self) -> Dict[str, int]:
        """Hedge-outcome counters for this round (AIMD feedback + gauges)."""
        with self._lock:
            return {
                "tiles_recovered": int(self.tiles_recovered),
                "hedge_duplicates": int(self.hedge_duplicates),
                "hedge_dropped": int(self.hedge_dropped),
                "slots_recovered": sum(
                    1 for s in self._sealed if self._hedged_tiles[s]
                ),
            }

    def quality_d2(self) -> Dict[str, float]:
        """Per-peer summed squared distance to the committed aggregate
        (accumulated across window tiles / the dense fold); empty when the
        health probe is off or the method is ``mean``."""
        with self._lock:
            return {self.slots[s]: d2 for s, d2 in self._q_d2.items()}

    async def finalize(self, included: Optional[List[str]] = None) -> np.ndarray:
        """Freeze arrivals, close open windows over the arrived subsets,
        await in-flight tile jobs, and return the committed buffer; every
        transient tile goes back to the pool. A failed tile job raises —
        the round must FAIL loudly, never commit a silently-zeroed tile."""
        self.freeze()
        leftovers: List[tuple] = []
        with self._lock:
            for tile, win in list(self._windows.items()):
                if win.count:
                    leftovers.append(self._fire_locked(tile, win, early=False))
                else:
                    # Empty window (every row withdrawn): nothing to close.
                    self._windows.pop(tile, None)
                    self._note_free(win.buf.nbytes)
                    self.pool.put(win.buf)
        self._spawn_jobs(leftovers)
        if self._tasks:
            results = await asyncio.gather(*self._tasks, return_exceptions=True)
            self._tasks.clear()
            for r in results:
                if isinstance(r, BaseException):
                    raise RuntimeError(f"tile aggregation failed: {r!r}") from r
        out = await asyncio.to_thread(self._finalize_blocking, included)
        self.release()  # transient rows/windows back to the pool NOW
        return out

    def _finalize_blocking(self, included: Optional[List[str]]) -> np.ndarray:
        t0 = time.perf_counter()
        try:
            if self.mode == "mean":
                if self._folder is not None:
                    # Pull the device accumulator (tail chunks flushed);
                    # re-normalization below is shared with the host path.
                    self._out = np.ascontiguousarray(
                        self._folder.result(), np.float32
                    )
                    self.folder_flushes = self._folder.flushes
                    self.ring_flushes = int(
                        getattr(self._folder, "ring_flushes", 0)
                    )
                # Per-tile re-normalization by the weight that ARRIVED: the
                # deadline-commit re-weighting, applied at tile granularity.
                for tile in range(self.n_tiles):
                    e0 = tile * self.tile_elems
                    w = self._tile_w[tile]
                    if w > 0:
                        self._out[e0 : e0 + self.tile_elems] *= np.float32(1.0 / w)
                return self._out
            if self.mode == "window":
                # Tiles no streamed chunk ever opened (e.g. every push
                # landed dense/pre-arming) close here over the residents.
                if self._resident:
                    rows = [
                        s for s in sorted(self._resident) if s not in self._aborted
                    ]
                    for tile in range(self.n_tiles):
                        if self._win_done[tile] or tile in self._windows or not rows:
                            continue
                        e0 = tile * self.tile_elems
                        n = min(self.tile_elems, self.n_elems - e0)
                        stack = np.stack(
                            [self._resident[s][e0 : e0 + n] for s in rows]
                        )
                        agg = self.codec.aggregate(
                            stack, self.method, **self._kw_fn(len(rows))
                        )
                        self._out[e0 : e0 + n] = agg
                        if self._quality_on and len(rows) >= 3:
                            for s, d2 in zip(rows, health_mod.row_d2(stack, agg)):
                                self._q_d2[s] = self._q_d2.get(s, 0.0) + float(d2)
                        self._win_done[tile] = True
                        self.tiles_deadline += 1
                return self._out
            # d2_dense / dense: stack the complete rows and run the dense
            # estimator (selection from the PRE-ACCUMULATED d² for krum/
            # bulyan). Completeness is TILE count, not the in-order cursor:
            # a hedge-completed row (out-of-order tiles, cursor never
            # advanced) is complete and must aggregate — it was REPORTED
            # recovered, so dropping it here would commit the accounting
            # without the mass.
            slots = sorted(
                self.slot_index[p]
                for p in (included if included is not None else self.included_peers())
                if self.slot_index.get(p) in self._rows
                and self._tiles_got[self.slot_index[p]] == self.n_tiles
            )
            if not slots:
                return self._out
            stack = np.stack([self._rows[s] for s in slots])
            kw = self._kw_fn(len(slots))
            if self.mode == "d2_dense" and self._d2 is not None:
                kw = dict(kw, d2=self._d2[np.ix_(slots, slots)].astype(np.float32))
            self._out = self.codec.aggregate(stack, self.method, **kw)
            if self._quality_on and len(slots) >= 3:
                # Dense-path quality attribution (krum/bulyan/geomedian/
                # centered_clip): one O(n·D) distance pass against the
                # aggregate the estimator just selected.
                for s, d2 in zip(slots, health_mod.row_d2(stack, self._out)):
                    self._q_d2[s] = self._q_d2.get(s, 0.0) + float(d2)
            return self._out
        finally:
            self.busy_s += time.perf_counter() - t0

    def release(self) -> None:
        """Return every transient buffer to the pool (skipped/failed round)."""
        with self._lock:
            self.frozen = True
            for win in self._windows.values():
                self._note_free(win.buf.nbytes)
                self.pool.put(win.buf)
            self._windows.clear()
            for row in self._rows.values():
                self._note_free(row.nbytes)
                self.pool.put(row)
            self._rows.clear()
            self._resident.clear()  # borrowed references: just drop them
            self._tail_bytes.clear()  # redundancy retention dies with the round
            if self._folder is not None:
                # Device accumulator freed with the round (committed rounds
                # already pulled result(); failed/fenced ones abandon it).
                self._folder_staged_peak = max(
                    self._folder_staged_peak, self._folder.peak_staged_bytes
                )
                self._note_free(self._folder.device_bytes)
                self._folder = None

    def gauges(self) -> dict:
        wall = max(time.monotonic() - self.t0, 1e-9)
        folder = self._folder
        staged_peak = max(
            self._folder_staged_peak,
            folder.peak_staged_bytes if folder is not None else 0,
        )
        return {
            "mode": self.mode,
            # Accumulator/window/row high-water PLUS the mesh folder's
            # staged raw-chunk high-water (summed peaks: a slight
            # over-count of the true concurrent peak, never an under-count).
            "peak_bytes_held": int(self.peak_bytes_held + staged_peak),
            "tiles_early": int(self.tiles_early),
            "tiles_deadline": int(self.tiles_deadline),
            "agg_busy_s": round(self.busy_s, 6),
            "agg_busy_frac": round(min(self.busy_s / wall, 1.0), 4),
            "streamed_contribs": int(self.streamed_contribs),
            "dense_contribs": int(self.dense_contribs),
            "aborted_contribs": int(self.aborted_contribs),
            # Tail-optimal hedged recovery (per-round view; the averager
            # rolls these into cumulative stats).
            "tiles_recovered": int(self.tiles_recovered),
            "hedge_duplicates": int(self.hedge_duplicates),
            "hedge_dropped": int(self.hedge_dropped),
            "fenced": bool(self.fenced),
            "chunks_after_fence": int(self.chunks_after_fence),
            # On-mesh data path: which backend folded this round (may read
            # "host" after a mid-round degrade — that IS the signal).
            "codec_backend": self.codec.backend,
            "folder_flushes": int(self.folder_flushes),
            # "ring" when the fused reduce pipeline (ops.mesh_collective)
            # carries the mean folds, "staged" for the PR 5 staged path,
            # "" when the round has no folder (non-mean modes / host codec).
            # Captured at construction so it survives release().
            "folder_kind": self.folder_kind,
            "ring_flushes": int(
                getattr(folder, "ring_flushes", None) or self.ring_flushes
            ),
        }
