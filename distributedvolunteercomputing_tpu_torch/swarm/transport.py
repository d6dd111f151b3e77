"""DCN transport: the WAN tensor/RPC fabric between volunteer slices.

TPU-native replacement for the reference's gloo/NCCL WAN path
(BASELINE.json:5): intra-slice collectives ride ICI inside ``pjit`` and never
touch this layer; everything BETWEEN volunteer slices — DHT RPCs, gossip,
butterfly rounds, robust aggregation — crosses here.

Design:
- asyncio TCP, length-prefixed binary frames; JSON meta + raw tensor payload
  (a param pytree crosses as ONE contiguous buffer from utils.pytree).
- CRC32-guarded payloads: WAN volunteers are untrusted/lossy, and the
  Byzantine path (config 5) must distinguish corruption from malice.
- **Persistent multiplexed connections**: one long-lived connection per
  dialed peer, shared by every in-flight RPC to that peer and demultiplexed
  by the request's ``rid``. Every heartbeat, DHT ping, clock probe, and
  averaging contribution used to pay a fresh TCP handshake + slow-start
  (the WAN tier's dominant fixed cost per the Moshpit/OptiReduce genre);
  now only the FIRST call to a peer does. A broken or idle-closed pooled
  socket is redialed transparently — the failed call is retried exactly
  once on a fresh connection (fresh rid, fresh MAC), so a peer restart
  looks like one slightly slower call, never an error surfaced to the
  averager. The server half handles requests CONCURRENTLY per connection
  (bounded in-flight), so a parked handler (e.g. a member's fetch awaiting
  the round result) cannot head-of-line-block heartbeats sharing the pipe.
- **Chunked payload streaming**: payloads above ``chunk_bytes`` cross as a
  header frame (meta declares the chunk count) followed by bounded chunk
  frames, each with its own CRC32. A multi-MB contribution no longer forces
  one giant allocation or a single monolithic write; the receiver
  assembles into ONE preallocated buffer (no join copy), enforces size
  caps incrementally, and can hand verified chunks to a ``chunk_sink`` so
  decode starts on the FIRST chunk instead of after the last. Senders may
  pass a ``StreamPayload`` whose chunks are produced (encoded) lazily on a
  worker thread while earlier chunks are already on the wire — encode/send
  overlap for the averaging tier (see AveragerBase._wire_stream). A bad
  chunk CRC or out-of-order chunk index is rejected with an attributable
  error frame WITHOUT dropping the connection (the explicit per-chunk
  lengths keep the stream in sync); only unparseable framing (bad magic,
  absurd lengths) kills the connection.
- Per-peer counters (bytes in/out, RPC count, connect count, latency EWMA)
  feed ``stats()``/`coord.status`` and the phi-accrual failure detector's
  secondary latency signal (swarm/membership.py).
- Timeout split: ``connect_timeout`` bounds the dial, ``timeout`` bounds
  the RPC itself (request write -> response). One slow dial can no longer
  eat the whole per-call budget the way the old combined wait_for did.
- The native C++ core (native/) accelerates checksum + quantization of the
  payload bytes; the socket path stays asyncio.
- Optional shared-secret message authentication (``secret=``): every frame
  carries an HMAC-SHA256 over (frame type, canonical meta, payload) plus a
  timestamp bounded by ``auth_window``. One chokepoint covers the whole
  swarm tier — DHT records, membership, state sync, and averaging
  contributions all cross this transport, so identity spoofing (which the
  Byzantine first-write-wins rule implicitly trusts) requires the secret,
  not just an open port. Replay is closed at this layer too, on two axes:
  SAME-NODE replay — every request carries a fresh uuid ``rid`` inside the
  MAC'd meta, so legitimate request frames are never byte-identical, and
  the server rejects an already-accepted MAC within the auth window;
  CROSS-NODE replay — the MAC also binds ``dst`` (the address the caller
  dialed), so a frame captured on its way to node X is refused by node Y
  (a captured membership heartbeat or DHT announce can NOT be re-played
  anywhere to keep a departed peer alive). Authenticated swarms must
  therefore dial peers at their advertised addresses — which every code
  path does (addresses always come from DHT/membership records).
  Responses are bound to their request by the MAC'd echoed ``rid``; the
  demultiplexer resolves exactly the pending call with that rid and
  discards unknown rids, so a replayed or stale response frame can never
  complete a different call (rids are fresh uuids, never reused).
  CHUNKED frames authenticate in two stages: the header MAC covers the
  meta (including rid, chunk count, and destination) and is verified
  BEFORE any chunk is read — so an unauthenticated peer cannot make a
  server buffer megabytes — and the payload itself is covered by a
  trailing HMAC computed incrementally over the chunk bytes and bound to
  the same rid, verified after the last chunk.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import statistics
import struct
import time
import uuid
import zlib
from collections import deque
from typing import (
    Awaitable,
    Callable,
    Dict,
    Iterator,
    Optional,
    Set,
    Tuple,
    Union,
)

from distributedvolunteercomputing_tpu_torch.swarm import telemetry
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)

MAGIC = b"DV"
VERSION = 1
TYPE_REQ, TYPE_RESP, TYPE_ERR = 1, 2, 3
_HEADER = struct.Struct("!2sBBIQI")  # magic, version, type, meta_len, payload_len, payload_crc32
# Chunk frame header: index, length, crc32 of this chunk's bytes. Chunk
# frames immediately follow a chunked message's header frame on the same
# (write-locked) stream, so they need no rid of their own.
_CHUNK = struct.Struct("!III")
MAX_PAYLOAD = 2 << 30  # 2 GiB guard
MAX_META = 4 << 20  # 4 MiB: meta is a small JSON dict, never tensor data
# Default per-chunk payload bound AND the inline threshold: payloads at or
# under this ride in the header frame exactly as the v1 wire did (the small
# RPCs — heartbeats, DHT, matchmaking — are byte-identical to pre-pool
# frames); bigger payloads stream as chunk frames.
CHUNK_BYTES = 1 << 20
MAX_CHUNKS = 1 << 20  # framing sanity bound, far above MAX_PAYLOAD/CHUNK_BYTES
# Smallest payload that contributes a bandwidth sample to the per-peer
# up/down throughput EWMAs: below this, per-RPC overhead (syscalls, loop
# scheduling) dominates the measurement and the estimate would read as a
# slow link. 256 KiB ~ a handful of wire chunks.
MIN_BW_SAMPLE_BYTES = 256 << 10
# A bandwidth estimate older than this no longer appears in
# bandwidth_advertisement(): links change (congestion, migration), and an
# aged-out advertisement degrades consumers to the unweighted default
# instead of electing yesterday's fat uplink.
BW_ADVERT_MAX_AGE_S = 120.0
DEFAULT_CONNECT_TIMEOUT = 5.0
# Concurrent in-flight requests served per inbound connection; past this the
# read loop stops pulling frames (TCP backpressure) until a handler finishes.
MAX_INFLIGHT_PER_CONN = 64
# Trailer MAC domain separator (payload HMAC of chunked frames).
_PAYLOAD_MAC_TAG = b"DVCP"

Addr = Tuple[str, int]
Handler = Callable[[dict, bytes], Awaitable[Tuple[dict, bytes]]]


class RPCError(Exception):
    """Remote handler raised, or the wire was corrupt."""


class _PayloadError(RPCError):
    """Payload-level rejection of an otherwise well-framed message (bad
    chunk CRC, out-of-order chunk index, corrupt inline payload). The
    explicit lengths kept the stream in sync, so the CONNECTION survives:
    the server answers with an error frame bound to ``rid`` and keeps
    serving; the client fails exactly the one pending call."""

    def __init__(self, rid: str, msg: str):
        super().__init__(msg)
        self.rid = rid if isinstance(rid, str) else ""


class StreamPayload:
    """A large outbound payload produced chunk-by-chunk.

    ``factory`` returns a fresh iterator of byte chunks summing to exactly
    ``total`` bytes; the transport pulls it on a worker thread while the
    event loop writes already-produced chunks — encode/send overlap. A
    factory (not a bare iterator) so the transparent single retry after a
    stale pooled socket can restart the stream from scratch.
    """

    __slots__ = ("total", "factory")

    def __init__(self, total: int, factory: Callable[[], Iterator[bytes]]):
        self.total = int(total)
        self.factory = factory


WirePayload = Union[bytes, bytearray, memoryview, StreamPayload]


def _payload_len(payload: WirePayload) -> int:
    return payload.total if isinstance(payload, StreamPayload) else len(payload)


def read_secret(path: Optional[str]) -> Optional[bytes]:
    """Swarm secret from a file (whitespace-stripped); None = auth off.
    A file, not a flag value — secrets in argv leak via process listings."""
    if not path:
        return None
    with open(path, "rb") as fh:
        secret = fh.read().strip()
    if not secret:
        raise ValueError(f"swarm secret file {path!r} is empty")
    return secret


class _PeerStats:
    """Per-dialed-peer WAN accounting: the transport-level evidence behind
    the pooling/bandwidth claims, and the latency EWMA the phi-accrual
    detector consumes as its secondary (RPC-level) liveness signal."""

    __slots__ = (
        "bytes_sent", "bytes_received", "rpcs", "connects", "lat_ewma",
        "last_used", "bw_up_ewma", "bw_down_ewma", "bw_up_t", "bw_down_t",
    )

    def __init__(self):
        self.bytes_sent = 0
        self.bytes_received = 0
        self.rpcs = 0
        self.connects = 0
        self.lat_ewma: Optional[float] = None
        self.last_used = time.monotonic()
        # Observed payload throughput to/from this peer (bytes/s), sampled
        # only on bulk transfers (>= MIN_BW_SAMPLE_BYTES) so control-plane
        # RPC timing never pollutes the estimate. Both directions are
        # measured at a RECEIVER (reads wait for bytes to actually arrive;
        # a sender's drain() only measures the kernel socket buffer):
        # ``bw_down`` from our own reads of this peer's responses,
        # ``bw_up`` from the peer's echoed arrival rate of our request
        # payloads (the ``rx_bps`` response field). Floors of the real
        # link rate — the safe direction for the consumers: bandwidth-
        # weighted leader election (matchmaking) and the membership
        # advertisement (bandwidth_advertisement). Each direction carries
        # its OWN sample timestamp so a stale estimate ages out of the
        # advertisement independently — a node still fetching bulk results
        # (fresh bw_down) but no longer pushing bulk payloads must not
        # keep advertising yesterday's uplink.
        self.bw_up_ewma: Optional[float] = None
        self.bw_down_ewma: Optional[float] = None
        self.bw_up_t = 0.0
        self.bw_down_t = 0.0

    def observe_latency(self, dt: float) -> None:
        if self.lat_ewma is None:
            self.lat_ewma = dt
        else:
            self.lat_ewma += 0.2 * (dt - self.lat_ewma)

    def observe_bw_up(self, bps: float) -> None:
        self.bw_up_ewma = (
            bps if self.bw_up_ewma is None
            else self.bw_up_ewma + 0.3 * (bps - self.bw_up_ewma)
        )
        self.bw_up_t = time.monotonic()

    def observe_bw_down(self, bps: float) -> None:
        self.bw_down_ewma = (
            bps if self.bw_down_ewma is None
            else self.bw_down_ewma + 0.3 * (bps - self.bw_down_ewma)
        )
        self.bw_down_t = time.monotonic()

    def as_dict(self) -> dict:
        return {
            "bytes_sent": self.bytes_sent,
            "bytes_received": self.bytes_received,
            "rpcs": self.rpcs,
            "connects": self.connects,
            "latency_ewma_ms": (
                round(self.lat_ewma * 1e3, 3) if self.lat_ewma is not None else None
            ),
            "bw_up_bps": (
                round(self.bw_up_ewma) if self.bw_up_ewma is not None else None
            ),
            "bw_down_bps": (
                round(self.bw_down_ewma) if self.bw_down_ewma is not None else None
            ),
        }


class _Conn:
    """One pooled client connection: write-locked frame writes, rid-demuxed
    response reads. The demux loop is the only reader; writers (concurrent
    calls) serialize whole messages under ``wlock`` so chunk sequences never
    interleave."""

    __slots__ = (
        "transport", "addr", "reader", "writer", "wlock", "pending", "sinks",
        "broken", "reused", "task",
    )

    def __init__(self, transport: "Transport", addr: Addr, reader, writer):
        self.transport = transport
        self.addr = addr
        self.reader = reader
        self.writer = writer
        self.wlock = asyncio.Lock()
        self.pending: Dict[str, asyncio.Future] = {}
        self.sinks: Dict[str, Callable[[int, int, bytes], None]] = {}
        self.broken = False
        # True once a call completed on this conn: only a REUSED (possibly
        # idle-closed / stale) socket earns the one transparent retry.
        self.reused = False
        self.task = asyncio.create_task(self._demux_loop())

    async def _demux_loop(self) -> None:
        t = self.transport
        try:
            while True:
                try:
                    ftype, meta, payload = await t._read_frame(
                        self.reader, sink_lookup=self.sinks.get, peer=self.addr
                    )
                except _PayloadError as e:
                    fut = self.pending.pop(e.rid, None)
                    if fut is not None and not fut.done():
                        fut.set_exception(RPCError(str(e)))
                    continue
                rid = meta.get("rid") if isinstance(meta, dict) else None
                if ftype == TYPE_ERR and not rid:
                    # Connection-level rejection from the server (framing /
                    # auth): the stream is done — surface the reason to
                    # every in-flight call rather than a bare disconnect.
                    raise RPCError(meta.get("error", "connection-level remote error"))
                fut = self.pending.pop(rid, None) if isinstance(rid, str) else None
                if fut is not None and not fut.done():
                    fut.set_result((ftype, meta, payload))
                # Unknown rid: the response to a call that already timed out
                # locally (its future was withdrawn) — discard. rids are
                # fresh uuids, so it can never complete a different call.
        except (
            asyncio.IncompleteReadError, ConnectionResetError,
            BrokenPipeError, OSError,
        ) as e:
            # Connection-level death: retryable by the caller (stale pooled
            # socket / peer restart).
            self._fail_pending(
                ConnectionResetError(f"connection to {self.addr} lost: {errstr(e)}")
            )
        except RPCError as e:
            # Protocol-level failure (unparseable/unauthenticated response):
            # NOT retryable — redialing an auth-failing peer is a retry storm.
            self._fail_pending(e)
        except asyncio.CancelledError:
            self._fail_pending(ConnectionResetError("transport closed"))
            raise
        finally:
            self.broken = True
            self.transport._drop_conn(self.addr, self)
            self.writer.close()

    def _fail_pending(self, exc: BaseException) -> None:
        for fut in list(self.pending.values()):
            if not fut.done():
                fut.set_exception(exc)
        self.pending.clear()

    def close(self) -> None:
        self.broken = True
        if not self.task.done():
            self.task.cancel()
        else:
            self.writer.close()


class Transport:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        advertise_host: Optional[str] = None,
        secret: Optional[bytes] = None,
        auth_window: float = 300.0,
        pooled: bool = True,
        connect_timeout: float = DEFAULT_CONNECT_TIMEOUT,
        chunk_bytes: int = CHUNK_BYTES,
    ):
        self._secret = secret
        self._auth_window = auth_window
        # Accepted-request MAC cache (replay rejection; see module doc).
        # FIFO deque gives cheap age+cap eviction: entries arrive in ~ts
        # order, so pruning from the left is enough.
        self._seen_macs: Dict[str, float] = {}
        self._seen_order: "deque[Tuple[float, str]]" = deque()
        self._host = host
        self._port = port
        # Bind address != reachable address when binding 0.0.0.0 (or behind
        # NAT): peers must be told an address they can dial, or every DHT
        # record we publish points back at the reader's own machine.
        self._advertise_host = advertise_host
        if advertise_host is None and host in ("0.0.0.0", "::", ""):
            log.warning(
                "binding %s without advertise_host: remote peers cannot dial "
                "the advertised address; pass --advertise-host for multi-host swarms",
                host or "ANY",
            )
        self._server: Optional[asyncio.base_events.Server] = None
        self._handlers: Dict[str, Handler] = {}
        # method -> factory(args, payload_len) returning a per-request sink
        # (or None to buffer normally): the server-side twin of call()'s
        # chunk_sink. Verified REQUEST chunks stream to the sink as they
        # arrive instead of assembling in a bytearray — the leader-side
        # aggregation pipeline consumes contribution chunks this way
        # (swarm/agg_stream.py). The matching handler then runs with an
        # empty payload. See register_request_sink.
        self._stream_factories: Dict[
            str, Callable[[dict, int], Optional[Callable[[int, int, bytes], None]]]
        ] = {}
        # ``pooled=False`` restores one-connection-per-call (the v1 wire
        # behavior): the escape hatch, and the baseline arm of
        # experiments/transport_bench.py.
        self.pooled = pooled
        self.connect_timeout = float(connect_timeout)
        self.chunk_bytes = int(chunk_bytes)
        # addr -> _Conn (ready) or asyncio.Task resolving to one (dialing);
        # concurrent calls to the same peer share the dial.
        self._conns: Dict[Addr, object] = {}
        self._server_writers: Set[asyncio.StreamWriter] = set()
        self._server_tasks: Set[asyncio.Task] = set()
        # WAN accounting (frame headers + meta + payload, both directions):
        # the evidence behind wire-codec claims — experiments read these off
        # the volunteer summary instead of estimating. Per-peer detail in
        # _peer_stats (dialed peers only: a server can't know which
        # LISTENING addr an inbound ephemeral port belongs to).
        self.bytes_sent = 0
        self.bytes_received = 0
        self.rpcs_sent = 0
        self.connects = 0
        self._peer_stats: Dict[Addr, _PeerStats] = {}

    @property
    def addr(self) -> Addr:
        """The ADVERTISED (dialable) address, used in every published record."""
        return (self._advertise_host or self._host, self._port)

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler

    def register_request_sink(
        self,
        method: str,
        factory: Callable[[dict, int], Optional[Callable[[int, int, bytes], None]]],
    ) -> None:
        """Stream ``method``'s chunked REQUEST payloads to a per-request sink.

        Only active when the transport has NO shared secret: chunks reach
        the sink after per-chunk CRC32 only, which is unkeyed, and sinks
        may consume irreversibly — with auth on the transport buffers the
        whole payload and verifies the HMAC trailer before the handler
        sees a byte, so tampered payloads are discarded whole.

        ``factory(args, payload_len)`` runs after the header frame is
        parsed. Returning None falls back to normal buffering — streaming
        is an optimization the factory may decline per request. The sink is
        called ``sink(offset, total, data)`` per verified in-order chunk,
        then ``sink.close(ok)`` exactly once: ok=True after the whole
        payload verified, ok=False on any abort — bad chunk CRC, framing
        error, connection death — possibly after some chunks were already
        delivered. Inline (sub-chunk) payloads never stream. The handler
        registered for ``method`` runs with an empty payload when the sink
        consumed it."""
        self._stream_factories[method] = factory

    def _request_sink(self, meta: dict, payload_len: int):
        fac = self._stream_factories.get(meta.get("method", ""))
        if fac is None:
            return None
        try:
            return fac(meta.get("args") or {}, payload_len)
        except Exception as e:  # noqa: BLE001 — a factory bug must buffer, not kill the conn
            log.debug("request sink factory failed (%s); buffering", errstr(e))
            return None

    async def start(self) -> Addr:
        self._server = await asyncio.start_server(self._serve_conn, self._host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        return self.addr

    async def close(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            # Stop accepting now; wait_closed() comes last: on Python 3.12
            # it waits for every inbound connection, which only the
            # force-close below ends.
            server.close()
        # Tear down the client pool: cancel demux loops (they close their
        # writers) and any dial still in flight.
        tasks = []
        for entry in list(self._conns.values()):
            if isinstance(entry, _Conn):
                entry.close()
                tasks.append(entry.task)
            elif isinstance(entry, asyncio.Task):
                entry.cancel()
                tasks.append(entry)
        self._conns.clear()
        # Force-close inbound connections and cancel parked handler tasks so
        # a closing node never keeps a test loop (or a real process) alive.
        for w in list(self._server_writers):
            w.close()
        for t in list(self._server_tasks):
            t.cancel()
        tasks.extend(self._server_tasks)
        self._server_tasks.clear()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        if server is not None:
            await server.wait_closed()

    # -- counters ----------------------------------------------------------

    # Distinct dialed peers whose counters are retained. Long-lived nodes in
    # a churning swarm dial an unbounded sequence of peer addresses; without
    # a cap the stats dict — serialized into every stats()/summary/
    # coord.status — would grow for the process lifetime.
    MAX_PEER_STATS = 512

    def _peer(self, addr: Addr) -> _PeerStats:
        st = self._peer_stats.get(addr)
        if st is None:
            if len(self._peer_stats) >= self.MAX_PEER_STATS:
                # Evict least-recently-used entries WITHOUT a live pooled
                # connection (an active peer's counters must survive).
                evictable = sorted(
                    (a for a in self._peer_stats if a not in self._conns),
                    key=lambda a: self._peer_stats[a].last_used,
                )
                for a in evictable[: max(1, len(evictable) // 4)]:
                    del self._peer_stats[a]
            st = self._peer_stats[addr] = _PeerStats()
        st.last_used = time.monotonic()
        return st

    def peer_latency(self, addr) -> Optional[float]:
        """RPC round-trip latency EWMA (seconds) to a dialed peer, or None
        before the first completed call. Fed to the phi-accrual failure
        detector as its secondary signal (swarm/membership.py)."""
        try:
            st = self._peer_stats.get((str(addr[0]), int(addr[1])))
        except (TypeError, ValueError, IndexError):
            return None
        return st.lat_ewma if st is not None else None

    def peer_bw_down(self, addr) -> Optional[float]:
        """Measured downlink throughput (bytes/s EWMA) FROM a dialed peer —
        our own read-timed samples of its bulk transfers, or None before
        the first >=MIN_BW_SAMPLE_BYTES payload. The hedge loop's transfer
        estimator reads this to predict whether a straggler's missing
        tiles can still arrive inside the round deadline."""
        try:
            st = self._peer_stats.get((str(addr[0]), int(addr[1])))
        except (TypeError, ValueError, IndexError):
            return None
        return st.bw_down_ewma if st is not None else None

    def bandwidth_advertisement(
        self, max_age_s: float = BW_ADVERT_MAX_AGE_S
    ) -> dict:
        """This node's measured up/down bandwidth, as the membership
        advertisement fields (``bw_up``/``bw_down``, bytes/s). ``bw_down``
        is the MAX of the fresh per-peer EWMAs — measured locally (our
        own reads), so every sample is a trustworthy floor and the best
        observed peer is the tightest floor on our link. ``bw_up``
        samples are peer-REPORTED (the rx_bps response echo), so one
        lying peer must not control the advertisement: with >= 3 fresh
        reporters the MEDIAN is taken (a minority of byzantine peers
        can't push it past honest reports), max otherwise (too few
        reporters to out-vote — the residual trust a 2-peer swarm always
        has). Each direction ages out independently; with nothing fresh
        within ``max_age_s`` the field is simply omitted and consumers
        degrade to unweighted behavior — a stale advertisement ages out
        rather than lingering."""
        cutoff = time.monotonic() - max_age_s
        up = [
            st.bw_up_ewma for st in self._peer_stats.values()
            if st.bw_up_ewma is not None and st.bw_up_t >= cutoff
        ]
        down = [
            st.bw_down_ewma for st in self._peer_stats.values()
            if st.bw_down_ewma is not None and st.bw_down_t >= cutoff
        ]
        out: dict = {}
        if up:
            out["bw_up"] = round(
                statistics.median(up) if len(up) >= 3 else max(up)
            )
        if down:
            out["bw_down"] = round(max(down))
        return out

    def stats(self) -> dict:
        """Transport-level counters: totals plus per-dialed-peer detail."""
        return {
            "bytes_sent": self.bytes_sent,
            "bytes_received": self.bytes_received,
            "rpcs": self.rpcs_sent,
            "connects": self.connects,
            "pooled_conns": sum(
                1 for c in self._conns.values()
                if isinstance(c, _Conn) and not c.broken
            ),
            "peers": {
                f"{h}:{p}": st.as_dict() for (h, p), st in self._peer_stats.items()
            },
        }

    # -- wire helpers ------------------------------------------------------

    def _mac(self, ftype: int, meta: dict, payload: bytes) -> str:
        """HMAC over (frame type, canonical meta minus auth, payload)."""
        canon = json.dumps(
            {k: v for k, v in meta.items() if k != "auth"},
            sort_keys=True,
            separators=(",", ":"),
        ).encode()
        return hmac.new(
            self._secret, bytes([ftype]) + canon + payload, hashlib.sha256
        ).hexdigest()

    def _payload_mac_ctx(self, ftype: int, rid: str):
        """Incremental HMAC over a chunked message's payload bytes, bound to
        the frame type and rid (the rid itself rides inside the MAC'd meta,
        closing the splice-a-different-payload-under-this-header hole)."""
        ctx = hmac.new(self._secret, _PAYLOAD_MAC_TAG, hashlib.sha256)
        ctx.update(bytes([ftype]))
        ctx.update(rid.encode())
        return ctx

    def _verify_auth(self, ftype: int, meta: dict, payload: bytes) -> None:
        got = meta.get("auth", "")
        if not isinstance(got, str) or not hmac.compare_digest(
            got, self._mac(ftype, meta, payload)
        ):
            raise RPCError("auth failure (missing/invalid frame HMAC)")
        ts = meta.get("ts")
        if not isinstance(ts, (int, float)) or abs(time.time() - ts) > self._auth_window:
            raise RPCError("auth failure (frame timestamp outside window)")
        if ftype == TYPE_REQ:
            if not self._dst_is_me(meta.get("dst")):
                # The MAC binds the address the caller DIALED: a frame
                # captured en route to another node must not be replayable
                # here (per-node seen-MAC caches can't see each other).
                raise RPCError("auth failure (frame addressed to a different node)")
            if not self._mac_fresh(got, float(ts)):
                # A fresh rid is in every legitimate request's MAC'd meta,
                # so an identical MAC within the window is a replay.
                raise RPCError("auth failure (replayed request frame)")

    def _chaos_corrupt_offset(self, ftype: int, total: int) -> Optional[int]:
        """Fault-injection hook (overridden by chaos.ChaosTransport): byte
        offset within the payload to flip AFTER checksums are computed, or
        None. Production transports never corrupt."""
        return None

    async def _iter_wire_chunks(self, payload: WirePayload):
        """Yield exactly-``chunk_bytes``-sized pieces (last may be short).

        bytes-likes are sliced zero-copy; a StreamPayload's factory iterator
        is pulled on a worker thread (the chunks are typically produced by a
        CPU-bound codec) and re-sliced to the wire chunk size, so encode of
        chunk k+1 overlaps the socket write of chunk k."""
        cb = self.chunk_bytes
        if not isinstance(payload, StreamPayload):
            view = memoryview(payload)
            for off in range(0, len(view), cb):
                yield view[off : off + cb]
            return
        it = payload.factory()
        pending = bytearray()
        _END = object()
        while True:
            piece = await asyncio.to_thread(next, it, _END)
            if piece is _END:
                break
            if not pending and len(piece) == cb:
                yield piece  # aligned producer: no re-buffer copy
                continue
            pending.extend(piece)
            while len(pending) >= cb:
                yield bytes(pending[:cb])
                del pending[:cb]
        if pending:
            yield bytes(pending)

    async def _write_message(
        self,
        writer: asyncio.StreamWriter,
        wlock: asyncio.Lock,
        ftype: int,
        meta: dict,
        payload: WirePayload,
        peer: Optional[Addr] = None,
        started: Optional[list] = None,
    ) -> None:
        """Serialize one message (inline or chunked) onto ``writer`` under
        ``wlock``. Any exception after the first byte leaves the stream
        mid-message — the CALLER must treat the connection as poisoned.
        ``started`` (when given) is appended to right before the first byte
        goes out, so a caller cancelled while still QUEUED on the write
        lock can tell it never touched the stream (the connection — and
        every other in-flight RPC multiplexed on it — survives)."""
        total = _payload_len(payload)
        if total > MAX_PAYLOAD:
            raise RPCError(f"payload {total} exceeds {MAX_PAYLOAD}")
        chunked = isinstance(payload, StreamPayload) or total > self.chunk_bytes
        rid = meta.get("rid", "")
        rid = rid if isinstance(rid, str) else ""
        corrupt_at = self._chaos_corrupt_offset(ftype, total)
        if chunked:
            n_chunks = -(-total // self.chunk_bytes)
            meta = dict(meta, chunks=n_chunks)
            if self._secret is not None:
                meta["ptrail"] = True  # payload MAC trailer follows the chunks
                meta["ts"] = round(time.time(), 3)
                meta["auth"] = self._mac(ftype, meta, b"")
        elif self._secret is not None:
            pl = payload if isinstance(payload, bytes) else bytes(payload)
            meta = dict(meta, ts=round(time.time(), 3))
            meta["auth"] = self._mac(ftype, meta, pl)
            payload = pl
        meta_b = json.dumps(meta).encode()
        sent = 0
        async with wlock:
            if started is not None:
                started.append(True)
            if not chunked:
                data = payload if isinstance(payload, bytes) else bytes(payload)
                crc = zlib.crc32(data) & 0xFFFFFFFF  # checksum of the TRUE payload
                if corrupt_at is not None:
                    bad = bytearray(data)
                    bad[corrupt_at] ^= 0xFF
                    data = bytes(bad)
                # One write: header + meta + payload coalesced. Separate
                # writes each poke the transport (a send syscall when the
                # kernel buffer has room) — at small-RPC rates the extra
                # syscalls were ~10% of swarm CPU.
                frame = _HEADER.pack(MAGIC, VERSION, ftype, len(meta_b), total, crc)
                writer.write(frame + meta_b + (data if total else b""))
                sent = _HEADER.size + len(meta_b) + total
                await writer.drain()
            else:
                writer.write(_HEADER.pack(MAGIC, VERSION, ftype, len(meta_b), total, 0))
                writer.write(meta_b)
                sent = _HEADER.size + len(meta_b)
                mac = (
                    self._payload_mac_ctx(ftype, rid)
                    if self._secret is not None
                    else None
                )
                idx = 0
                off = 0
                async for piece in self._iter_wire_chunks(payload):
                    data = piece  # bytes-like; crc/hmac/write all take views
                    crc = zlib.crc32(data) & 0xFFFFFFFF
                    if mac is not None:
                        mac.update(data)
                    if corrupt_at is not None and off <= corrupt_at < off + len(data):
                        bad = bytearray(data)
                        bad[corrupt_at - off] ^= 0xFF
                        data = bytes(bad)
                    writer.write(_CHUNK.pack(idx, len(data), crc))
                    writer.write(data)
                    sent += _CHUNK.size + len(data)
                    # Drain per chunk: the loop stays responsive and the
                    # socket applies backpressure chunk-by-chunk instead of
                    # buffering the whole payload in userspace.
                    await writer.drain()
                    idx += 1
                    off += len(data)
                if off != total or idx != -(-total // self.chunk_bytes):
                    raise RPCError(
                        f"stream payload produced {off}B/{idx} chunks, "
                        f"declared {total}B"
                    )
                if mac is not None:
                    digest = mac.digest()
                    writer.write(
                        _CHUNK.pack(idx, len(digest), zlib.crc32(digest) & 0xFFFFFFFF)
                    )
                    writer.write(digest)
                    sent += _CHUNK.size + len(digest)
                await writer.drain()
        self.bytes_sent += sent
        if peer is not None:
            self._peer(peer).bytes_sent += sent

    async def _read_frame(
        self,
        reader: asyncio.StreamReader,
        sink_lookup: Optional[Callable[[str], Optional[Callable]]] = None,
        peer: Optional[Addr] = None,
        req_sinks: bool = False,
    ) -> Tuple[int, dict, bytes]:
        """Read one complete message (header frame + any chunk frames).

        Raises IncompleteReadError/ConnectionResetError when the stream
        dies, _PayloadError for an attributable payload rejection (the
        connection survives), and plain RPCError for unparseable or
        unauthenticated framing (the caller must drop the connection)."""
        header = await reader.readexactly(_HEADER.size)
        magic, version, ftype, meta_len, payload_len, crc = _HEADER.unpack(header)
        if magic != MAGIC or version != VERSION:
            raise RPCError(f"bad frame header: magic={magic!r} version={version}")
        if payload_len > MAX_PAYLOAD:
            raise RPCError(f"payload {payload_len} exceeds {MAX_PAYLOAD}")
        if meta_len > MAX_META:
            raise RPCError(f"meta {meta_len} exceeds {MAX_META}")
        meta_b = await reader.readexactly(meta_len) if meta_len else b"{}"
        received = _HEADER.size + meta_len
        try:
            meta = json.loads(meta_b)
        except (ValueError, RecursionError) as e:
            # Attacker-controlled bytes: a JSONDecodeError is a ValueError,
            # not an RPCError — without this wrap it would escape the serve
            # loop's bad-frame containment and kill the connection task with
            # an unhandled exception instead of a clean error frame.
            # RecursionError too: deeply-nested JSON (200 KB of '[' fits
            # comfortably under MAX_META) blows the parser's stack.
            self.bytes_received += received
            raise RPCError(f"malformed frame meta (not JSON: {e})") from e
        if not isinstance(meta, dict):
            # json.loads happily returns lists/scalars; meta.get() downstream
            # would AttributeError outside the containment net.
            self.bytes_received += received
            raise RPCError(f"malformed frame meta (not an object: {type(meta).__name__})")
        rid = meta.get("rid", "")
        rid = rid if isinstance(rid, str) else ""
        # Local measurement stash only (set below, echoed by the server
        # half): a remote peer must not be able to pre-seed it.
        meta.pop("_rx_bps", None)
        n_chunks = meta.get("chunks")
        if n_chunks is None:
            # Inline message: the v1 wire, byte-identical.
            t_payload = time.monotonic()
            payload = await reader.readexactly(payload_len) if payload_len else b""
            received += payload_len
            self.bytes_received += received
            dt = time.monotonic() - t_payload
            if peer is not None:
                st = self._peer(peer)
                st.bytes_received += received
                if payload_len >= MIN_BW_SAMPLE_BYTES and dt > 0:
                    st.observe_bw_down(payload_len / dt)
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                # The declared lengths were honored, so the stream is still
                # in sync: reject THIS message, keep the connection.
                raise _PayloadError(rid, "payload CRC mismatch (corrupt frame)")
            if self._secret is not None:
                self._verify_auth(ftype, meta, payload)
            if payload_len >= MIN_BW_SAMPLE_BYTES and dt > 0:
                # Read-side throughput is genuine: readexactly waits for
                # bytes to actually ARRIVE (stream buffer caps at 64 KiB),
                # so the rate is bounded by the sender's uplink + path.
                # Stashed in the meta so the server half can echo it back
                # to the sender as its measured uplink (see
                # _handle_request); the sender CANNOT measure this itself —
                # its drain() returns once the kernel socket buffer accepts
                # the bytes, a ceiling on the link rate, not a floor. Set
                # AFTER auth: the MAC covers the meta as the sender sent it.
                meta["_rx_bps"] = payload_len / dt
            return ftype, meta, payload
        # Chunked message.
        if (
            not isinstance(n_chunks, int)
            or isinstance(n_chunks, bool)
            or n_chunks < 1
            or n_chunks > MAX_CHUNKS
            or payload_len <= 0
            or n_chunks > payload_len
        ):
            self.bytes_received += received
            raise RPCError(f"malformed chunked frame (chunks={n_chunks!r})")
        if self._secret is not None:
            # Header MAC verified BEFORE any chunk is read: an
            # unauthenticated peer cannot make this node buffer megabytes,
            # and the replay/dst checks run on bounded work.
            self._verify_auth(ftype, meta, b"")
        sink = sink_lookup(rid) if sink_lookup is not None else None
        if sink is None and req_sinks and ftype == TYPE_REQ and self._secret is None:
            # Server-side request streaming (register_request_sink). Only
            # without auth: a streamed chunk reaches the sink after its
            # CRC32 — an unkeyed check — but BEFORE the payload HMAC
            # trailer, and request sinks may consume irreversibly (the
            # leader axpy-folds mean-mode chunks into the aggregate). With
            # a secret set we buffer instead, so a MAC-failing payload is
            # discarded whole and never touches the consumer — the same
            # integrity guarantee the pre-streaming path gave. (The CLIENT
            # fetch sink stays streamed under auth: it fills a staging
            # buffer the caller drops when the call errors.)
            sink = self._request_sink(meta, payload_len)
        sink_closed = False

        def _close_sink(ok: bool) -> None:
            # Exactly-once completion signal for sinks that track a
            # lifecycle (request sinks do; the client fetch sink doesn't).
            nonlocal sink_closed
            if sink is None or sink_closed:
                return
            sink_closed = True
            close = getattr(sink, "close", None)
            if close is not None:
                try:
                    close(ok)
                except Exception as e:  # noqa: BLE001 — a sink bug must not kill the conn
                    log.debug("chunk sink close(%s) failed: %s", ok, errstr(e))

        mac = (
            self._payload_mac_ctx(ftype, rid) if self._secret is not None else None
        )
        buf: Optional[bytearray] = None if sink is not None else bytearray(payload_len)
        got = 0
        bad: Optional[str] = None
        t_chunks = time.monotonic()
        try:
            for i in range(n_chunks):
                ch = await reader.readexactly(_CHUNK.size)
                idx, length, ccrc = _CHUNK.unpack(ch)
                if length == 0 or got + length > payload_len:
                    # Framing no longer adds up — the incremental size cap. The
                    # stream position past this point is untrustworthy.
                    self.bytes_received += received
                    raise RPCError(
                        f"chunk framing exceeds declared payload "
                        f"({got}+{length} > {payload_len})"
                    )
                data = await reader.readexactly(length)
                received += _CHUNK.size + length
                if mac is not None:
                    mac.update(data)
                if bad is None and idx != i:
                    bad = f"chunk index {idx} != expected {i} (duplicated/reordered)"
                elif bad is None and (zlib.crc32(data) & 0xFFFFFFFF) != ccrc:
                    bad = f"chunk {i} CRC mismatch (corrupt frame)"
                if bad is None:
                    if sink is not None:
                        try:
                            # Verified chunk straight to the consumer: decode
                            # (and leader-side aggregation) starts on the
                            # FIRST chunk.
                            sink(got, payload_len, data)
                        except Exception as e:  # noqa: BLE001 — a sink bug fails the call, not the conn
                            bad = f"chunk sink rejected payload: {errstr(e)}"
                    else:
                        buf[got : got + length] = data
                got += length
            if bad is None and got != payload_len:
                bad = f"chunked payload short of declared total ({got} < {payload_len})"
            if meta.get("ptrail"):
                th = await reader.readexactly(_CHUNK.size)
                t_idx, t_len, t_crc = _CHUNK.unpack(th)
                if t_idx != n_chunks or t_len != hashlib.sha256().digest_size:
                    self.bytes_received += received
                    raise RPCError("malformed payload MAC trailer")
                digest = await reader.readexactly(t_len)
                received += _CHUNK.size + t_len
                if mac is not None and bad is None and not hmac.compare_digest(
                    digest, mac.digest()
                ):
                    self.bytes_received += received
                    raise RPCError("auth failure (chunked payload MAC mismatch)")
            elif mac is not None:
                self.bytes_received += received
                raise RPCError("auth failure (chunked payload without MAC trailer)")
        except BaseException:
            # Framing/auth failure or connection death mid-payload: the sink
            # may have consumed verified chunks already — tell it the stream
            # died so it can withdraw or quarantine them.
            _close_sink(False)
            raise
        self.bytes_received += received
        chunk_dt = time.monotonic() - t_chunks
        if bad is None and payload_len >= MIN_BW_SAMPLE_BYTES and chunk_dt > 0:
            # First chunk to last: a throughput floor (the sender's encode
            # pacing only makes the true link faster). Same echo contract
            # as the inline path above.
            meta["_rx_bps"] = payload_len / chunk_dt
        if peer is not None:
            st = self._peer(peer)
            st.bytes_received += received
            if bad is None and payload_len >= MIN_BW_SAMPLE_BYTES and chunk_dt > 0:
                st.observe_bw_down(payload_len / chunk_dt)
        if bad is not None:
            _close_sink(False)
            raise _PayloadError(rid, bad)
        _close_sink(True)
        # The assembled bytearray is returned as-is (bytes-like): converting
        # would copy the whole payload — at contribution scale, a real cost.
        return ftype, meta, buf if buf is not None else b""

    def _dst_is_me(self, dst) -> bool:
        """Is the MAC'd destination this node? Port must match the bound
        port; the host may be any name this node is legitimately dialed by
        (advertised, bound, or loopback). Alias sets of distinct nodes
        cannot collide: same machine implies distinct ports, distinct
        machines implies distinct hosts."""
        if not (isinstance(dst, (list, tuple)) and len(dst) == 2):
            return False
        host, port = dst
        if port != self._port:
            return False
        aliases = {self._advertise_host, self._host, "127.0.0.1", "localhost"}
        return host in aliases

    # Hard cap on remembered request MACs: ~5 MB worst case, and at any
    # realistic RPC rate the age-based pruning keeps it far smaller.
    MAX_SEEN_MACS = 65536

    def _mac_fresh(self, mac: str, ts: float) -> bool:
        """Record ``mac``; False if it was already accepted in the window.

        Entries are retained until max(accept_time, frame ts) + auth_window:
        a frame from an ahead-of-clock peer stays timestamp-valid until
        ts + window, so evicting by accept time alone would reopen a replay
        window of exactly the sender's clock skew."""
        now = time.time()
        cutoff = now - self._auth_window
        order, seen = self._seen_order, self._seen_macs
        while order and (order[0][0] < cutoff or len(order) > self.MAX_SEEN_MACS):
            _, old = order.popleft()
            seen.pop(old, None)
        if mac in seen:
            return False
        seen[mac] = now
        order.append((max(now, ts), mac))
        return True

    # -- server ------------------------------------------------------------

    async def _serve_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._server_writers.add(writer)
        wlock = asyncio.Lock()
        sem = asyncio.Semaphore(MAX_INFLIGHT_PER_CONN)
        try:
            while True:
                try:
                    ftype, meta, payload = await self._read_frame(
                        reader, req_sinks=True
                    )
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                except _PayloadError as e:
                    # Attributable payload rejection (bad CRC, chunk index,
                    # sink refusal): error frame bound to the rid; the
                    # connection — and every other in-flight RPC on it —
                    # keeps going.
                    try:
                        await self._write_message(
                            writer, wlock, TYPE_ERR,
                            {"rid": e.rid, "error": f"bad frame: {e}"}, b"",
                        )
                    except Exception:
                        return
                    continue
                except RPCError as e:
                    # Unparseable framing / auth failure: the stream position
                    # is untrustworthy past this point, so report the reason
                    # and drop the connection — the caller can then
                    # distinguish corruption from a disconnect (the
                    # Byzantine path needs that signal).
                    try:
                        await self._write_message(
                            writer, wlock, TYPE_ERR,
                            {"rid": "", "error": f"bad frame: {e}"}, b"",
                        )
                    except Exception:
                        pass
                    return
                if ftype != TYPE_REQ:
                    return
                # Concurrent handling per connection: a parked handler (e.g.
                # sync.fetch awaiting the round result) must not
                # head-of-line-block the heartbeats and DHT RPCs sharing
                # this multiplexed pipe. The semaphore bounds in-flight
                # handlers; past it the read loop itself applies TCP
                # backpressure.
                await sem.acquire()
                task = asyncio.create_task(
                    self._handle_request(writer, wlock, sem, meta, payload)
                )
                self._server_tasks.add(task)
                task.add_done_callback(self._server_tasks.discard)
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._server_writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _handle_request(
        self,
        writer: asyncio.StreamWriter,
        wlock: asyncio.Lock,
        sem: asyncio.Semaphore,
        meta: dict,
        payload: bytes,
    ) -> None:
        """One request end-to-end: dispatch, run the handler, write the
        response. Handler errors go back on the wire; write failures mean
        the client vanished (its call timed out / conn dropped) — the
        handler's state effects stand, the response is simply lost, exactly
        as with the old per-call connections."""
        # Round-trace propagation (swarm/telemetry.py): the caller's
        # ambient trace id rides the MAC'd frame meta (``tr``); restoring
        # it around this handler task is what lets a leader's handler-side
        # spans and flight events stitch into the member's round trace
        # without any new RPC.
        tr = meta.get("tr")
        tr_token = (
            telemetry.set_current_trace(tr) if isinstance(tr, str) and tr else None
        )
        try:
            method = meta.get("method", "")
            rid = meta.get("rid", "")
            handler = self._handlers.get(method)
            if handler is None:
                out_type: int = TYPE_ERR
                out_meta: dict = {"rid": rid, "error": f"no such method {method!r}"}
                out_payload: WirePayload = b""
            else:
                try:
                    resp_meta, out_payload = await handler(meta.get("args", {}), payload)
                    out_type, out_meta = TYPE_RESP, {"rid": rid, "ret": resp_meta}
                    rx_bps = meta.get("_rx_bps")
                    if rx_bps:
                        # Echo the measured arrival rate of the request's
                        # bulk payload back to its sender — the only place
                        # the sender's UPLINK is genuinely observable (its
                        # own drain() only measures the kernel buffer).
                        # MAC-covered under auth like the rest of the
                        # response meta. Trust note: a LYING responder
                        # inflates the honest REQUESTER's uplink estimate
                        # (possibly electing a thin-linked leader), which
                        # is why bandwidth_advertisement aggregates these
                        # by MEDIAN across reporters — a minority of
                        # byzantine peers can't move the advertisement —
                        # and why samples age out in BW_ADVERT_MAX_AGE_S.
                        out_meta["rx_bps"] = round(rx_bps)
                except Exception as e:  # handler errors go back on the wire
                    log.debug("handler %s raised: %s", method, errstr(e))
                    out_type = TYPE_ERR
                    out_meta = {"rid": rid, "error": f"{type(e).__name__}: {e}"}
                    out_payload = b""
            try:
                await self._write_message(writer, wlock, out_type, out_meta, out_payload)
            except (ConnectionResetError, BrokenPipeError, OSError, RPCError) as e:
                log.debug("response write failed (client gone?): %s", errstr(e))
                writer.close()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — a request task must never die loudly
            log.debug("request task failed: %s", errstr(e))
        finally:
            if tr_token is not None:
                telemetry.reset_current_trace(tr_token)
            sem.release()

    # -- client ------------------------------------------------------------

    def _drop_conn(self, addr: Addr, conn: "_Conn") -> None:
        if self._conns.get(addr) is conn:
            del self._conns[addr]

    def drop_peer(self, addr) -> None:
        """Proactively retire the pooled connection (or in-flight dial) to
        ``addr``. Failover support: a deposed round leader's socket must
        stop being a transparent-retry target the instant the deposition is
        decided — every RPC still multiplexed on it fails NOW with a
        connection error instead of discovering the corpse one timeout at a
        time. A later call to the same address dials fresh."""
        try:
            addr = (str(addr[0]), int(addr[1]))
        except (TypeError, ValueError, IndexError):
            return
        entry = self._conns.get(addr)
        if isinstance(entry, _Conn):
            entry.close()
        elif isinstance(entry, asyncio.Task):
            entry.cancel()
            self._conns.pop(addr, None)

    async def _dial(self, addr: Addr, connect_timeout: float) -> "_Conn":
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(*addr), timeout=connect_timeout
            )
        except asyncio.TimeoutError:
            # Surface dial timeouts as OSError (unreachable peer), keeping
            # TimeoutError for "the RPC itself blew its budget" — callers
            # catch both, but the distinction matters for retry/backoff
            # policies and logs.
            raise OSError(
                f"connect to {addr[0]}:{addr[1]} timed out after {connect_timeout:.1f}s"
            ) from None
        self.connects += 1
        self._peer(addr).connects += 1
        return _Conn(self, addr, reader, writer)

    def _finish_dial(self, addr: Addr, task: asyncio.Task) -> None:
        current = self._conns.get(addr)
        if current is not task:
            return
        if task.cancelled() or task.exception() is not None:
            del self._conns[addr]
        else:
            self._conns[addr] = task.result()

    async def _checkout_conn(
        self, addr: Addr, connect_timeout: float
    ) -> Tuple["_Conn", bool]:
        """(conn, fresh): the pooled connection to ``addr``, dialing if
        absent/broken. Concurrent callers share one dial. ``fresh`` is True
        when this caller's conn came from a dial it (co-)initiated — only
        REUSED conns earn the transparent retry."""
        entry = self._conns.get(addr)
        if isinstance(entry, _Conn):
            if not entry.broken:
                return entry, not entry.reused
            self._drop_conn(addr, entry)
            entry = None
        if entry is None:
            task = asyncio.create_task(self._dial(addr, connect_timeout))
            self._conns[addr] = task
            task.add_done_callback(lambda t, a=addr: self._finish_dial(a, t))
            entry = task
        # shield: a caller timing out must not cancel the dial other
        # concurrent callers are waiting on.
        conn = await asyncio.shield(entry)
        return conn, True

    async def _roundtrip(
        self,
        conn: "_Conn",
        addr: Addr,
        method: str,
        args: Optional[dict],
        payload: WirePayload,
        chunk_sink: Optional[Callable[[int, int, bytes], None]],
        record_latency: bool,
    ) -> Tuple[dict, bytes]:
        rid = uuid.uuid4().hex[:16]
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        conn.pending[rid] = fut
        if chunk_sink is not None:
            conn.sinks[rid] = chunk_sink
        t0 = time.monotonic()
        started: list = []
        req_meta = {
            "rid": rid, "method": method, "args": args or {},
            "dst": [addr[0], addr[1]],
        }
        # Ambient round-trace id (swarm/telemetry.py) rides the frame meta:
        # the server half restores it around the handler, stitching the
        # remote spans into this round's trace with zero extra RPCs.
        tr = telemetry.current_trace()
        if tr:
            req_meta["tr"] = tr
        try:
            try:
                # dst (the dialed address) rides inside the MAC'd meta so an
                # authenticated frame is only acceptable at the node it was
                # sent to (see module doc: cross-node replay).
                await self._write_message(
                    conn.writer, conn.wlock, TYPE_REQ,
                    req_meta, payload, peer=addr, started=started,
                )
            except BaseException:
                # A failure (or cancellation) mid-write leaves the
                # multiplexed stream half-way through a message: poison the
                # connection so no other call inherits a desynced wire.
                # Cancelled while still QUEUED on the write lock (no byte
                # out yet) the stream is untouched — the connection, and
                # every other RPC in flight on it, survives.
                if started:
                    conn.close()
                raise
            ftype, meta, resp_payload = await fut
        finally:
            conn.pending.pop(rid, None)
            conn.sinks.pop(rid, None)
            if fut.done() and not fut.cancelled():
                # Consume a result/exception the demux set concurrently with
                # our own cancellation — silences 'exception was never
                # retrieved' for races between a timeout and a conn death.
                fut.exception()
        st = self._peer(addr)
        st.rpcs += 1
        if record_latency:
            st.observe_latency(time.monotonic() - t0)
        rx_bps = meta.get("rx_bps") if isinstance(meta, dict) else None
        if (
            isinstance(rx_bps, (int, float))
            and not isinstance(rx_bps, bool)
            and 0 < rx_bps < 1e12
        ):
            # The receiver's measured arrival rate of our bulk request
            # payload (see _handle_request): the honest uplink sample —
            # our own drain() timing only measures the kernel buffer.
            st.observe_bw_up(float(rx_bps))
        self.rpcs_sent += 1
        conn.reused = True
        if ftype == TYPE_ERR:
            raise RPCError(meta.get("error", "unknown remote error"))
        if meta.get("rid") != rid:
            raise RPCError("response rid mismatch")
        return meta.get("ret", {}), resp_payload

    async def call(
        self,
        addr,
        method: str,
        args: Optional[dict] = None,
        payload: WirePayload = b"",
        timeout: float = 30.0,
        connect_timeout: Optional[float] = None,
        chunk_sink: Optional[Callable[[int, int, bytes], None]] = None,
        record_latency: bool = True,
    ) -> Tuple[dict, bytes]:
        """One RPC to ``addr``; raises RPCError/OSError/TimeoutError on failure.

        ``connect_timeout`` bounds the dial (when no pooled connection
        exists); ``timeout`` bounds the RPC itself, starting AFTER the
        connection is up — a slow dial can no longer eat the whole budget.
        On a pooled connection that turns out stale (idle-closed socket,
        restarted peer) the call transparently redials and retries EXACTLY
        once with a fresh rid (a ``chunk_sink`` with a ``reset`` attribute
        is reset first, discarding any chunks the dead stream delivered);
        fresh-connection failures, RPC errors, and timeouts are never
        retried. ``payload`` may be bytes or a StreamPayload (chunks
        encoded while earlier ones are in flight); ``chunk_sink(offset,
        total, data)``, when given, receives the response payload's
        verified chunks as they arrive (the returned payload is then
        empty). ``record_latency=False`` keeps this call out of the
        per-peer latency EWMA — REQUIRED for calls that park on the remote
        handler by design (a member's result fetch) or move bulk payloads,
        since that EWMA feeds the failure detector's straggler suspicion
        and must sample only quick control-plane RPCs."""
        addr = (str(addr[0]), int(addr[1]))
        if connect_timeout is None:
            connect_timeout = min(self.connect_timeout, timeout)
        # ONE deadline across both attempts: the transparent retry must not
        # double the budget the caller planned around (averaging rounds pass
        # their remaining deadline-wait here).
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:
            attempt += 1
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise asyncio.TimeoutError()
            if self.pooled:
                conn, fresh = await self._checkout_conn(
                    addr, min(connect_timeout, remaining)
                )
            else:
                conn, fresh = await self._dial(addr, min(connect_timeout, remaining)), True
            try:
                return await asyncio.wait_for(
                    self._roundtrip(
                        conn, addr, method, args, payload, chunk_sink,
                        record_latency,
                    ),
                    timeout=max(deadline - time.monotonic(), 0.001),
                )
            except (asyncio.TimeoutError, TimeoutError):
                # Never retried, and explicit: on Python >= 3.11
                # asyncio.TimeoutError IS builtins.TimeoutError, an OSError
                # subclass — without this clause the conn-error handler
                # below would close the pooled connection and silently
                # re-send the timed-out RPC with a fresh budget.
                raise
            except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError, OSError) as e:
                conn.close()
                if fresh or attempt > 1:
                    if isinstance(e, asyncio.IncompleteReadError):
                        raise ConnectionResetError(
                            f"connection to {addr[0]}:{addr[1]} lost mid-call"
                        ) from e
                    raise
                # Stale pooled socket (the peer idle-closed it, or restarted
                # since we dialed): one transparent retry on a fresh
                # connection — a peer restart is a retried call, not an
                # error surfaced to the averager.
                if chunk_sink is not None:
                    # The dead stream may have delivered some response
                    # chunks already; the retry re-delivers from offset 0,
                    # so the sink must forget them or its accounting
                    # double-counts and fails the very call the retry saves.
                    reset = getattr(chunk_sink, "reset", None)
                    if reset is not None:
                        reset()
                log.debug(
                    "pooled connection to %s:%d stale (%s); redialing once",
                    addr[0], addr[1], errstr(e),
                )
            finally:
                if not self.pooled:
                    conn.close()
