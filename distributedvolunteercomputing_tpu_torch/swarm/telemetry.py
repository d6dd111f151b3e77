"""Swarm telemetry plane: round tracing, metrics registry, flight recorder.

PRs 1-9 each bolted their own gauges onto ``Averager.stats()`` and the
coord.status rollup — ~10 disjoint ad-hoc dicts and no way to answer the
question every chaos campaign and bench actually asks: **where did a
round's wall time go, across volunteers?** This module is the shared
substrate those surfaces re-register into:

- **Distributed round tracing** (:class:`Tracer`): lightweight spans over
  the round protocol's phases (``join -> arm -> encode -> wire -> fold ->
  commit`` / ``recover``) whose trace id IS the existing round key — the
  matchmaking epoch hash, which already folds in the group-scoped
  rendezvous key (``r<rot>.g<idx>`` levels included) — with the failover
  generation riding as a span attribute. The trace id propagates in the
  transport frame meta (``Transport.call`` stamps the ambient trace into
  every outbound frame; the server half restores it around the handler
  task), so the leader's handler-side spans and each member's client-side
  spans stitch into one tree WITHOUT any new RPC. Span timestamps are
  taken on the telemetry clock — ``ClockSync.now`` when the volunteer has
  one — so cross-volunteer spans align to swarm-consensus time, not raw
  host clocks.

- **Unified metrics registry** (:class:`MetricsRegistry`): counters,
  gauges, and log2-bucketed histograms with bounded label sets, plus
  *callback sources* — the existing ``stats()`` dict surfaces (transport,
  failover, aggregation, control_plane, ...) register themselves once and
  every scrape flattens their numeric leaves into gauges under a stable
  dotted namespace. Scraped via the ``telemetry.scrape`` RPC, batched
  through the PR-9 ``cp.exchange`` beat (the volunteer report carries
  :meth:`Telemetry.summary`), and rolled up by control-plane replicas into
  ``coord.status["telemetry"]`` under the versioned schema below.

- **Flight recorder** (:class:`FlightRecorder`): a bounded ring buffer of
  structured events (depositions, fences rejected, degrades, backoff and
  escalation transitions) every volunteer keeps locally. Dumped on demand
  via the ``telemetry.flight`` debug RPC, and attached automatically to
  chaos campaign artifacts on verdict (experiments/chaos_soak.py) — a
  failed verdict ships its own post-mortem.

Everything is advisory and bounded: a telemetry bug must never fail a
round, so record paths swallow their own exceptions, ring buffers cap
memory, and ``Telemetry(enabled=False)`` turns every hot-path call into a
cheap no-op (the overhead smoke in tests/test_telemetry.py holds the
enabled path within 5% of disabled commit latency).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)

# Version stamp carried by every scrape, report summary, and the
# coord.status rollup. Bump when the SHAPE of the telemetry surfaces
# changes; tests/test_telemetry.py pins the documented schema per version
# so rollup drift breaks CI instead of dashboards.
# v2: the training-health layer (swarm/health.py) — health summaries ride
# the report beat, scrapes carry the health view, and the status rollup
# counts health reporters (the full health rollup is coord.status["health"],
# pinned by its own STATUS_HEALTH_SCHEMA).
# v3: the watchdog layer (swarm/watchdog.py) — flight events carry a
# severity (``sev``) and the flight RPC an incremental ``since_seq``
# cursor; scrapes carry the watchdog view; the status rollups gain an
# ``age_s`` staleness stamp (the slo/alerts sections are pinned by
# watchdog.STATUS_WATCHDOG_SCHEMA).
TELEMETRY_SCHEMA_VERSION = 3

# RPC method names (registered by Telemetry.register_rpcs).
SCRAPE_METHOD = "telemetry.scrape"
TRACE_METHOD = "telemetry.trace"
FLIGHT_METHOD = "telemetry.flight"
PROM_METHOD = "telemetry.prom"

# Default severity per flight-recorder event kind (the alerting tier's
# triage order: ``page`` wakes someone, ``warn`` waits for business
# hours, ``info`` is context). Callers can override per event via
# ``sev=``; unknown kinds default to "info".
KIND_SEVERITY: Dict[str, str] = {
    "leader_deposed": "warn",
    "fence_rejected": "warn",
    "round_degraded": "warn",
    "round_failed": "warn",
    "round_recovered": "info",
    "recovery_failed": "page",
    "backoff": "warn",
    "method_escalated": "warn",
    "method_deescalated": "info",
    "codec_degraded": "warn",
    "peer_quality_flagged": "page",
    "mass_lost_at_deadline": "warn",
    # Tail-optimal hedged recovery: a hedge being issued is routine
    # tail-chasing; recovered mass is the good-news twin of
    # mass_lost_at_deadline.
    "hedge_issued": "info",
    "mass_recovered_by_hedge": "info",
    # Closed-loop controller: an applied policy transition is an
    # INTENTIONAL retune (context for the anomaly it pre-empts or
    # explains, not itself an anomaly).
    "policy_changed": "info",
    "alert_raised": "page",
    "alert_cleared": "info",
    # Zone-sharded training (swarm/sharding.py): a holder departing with
    # its shard starts a recovery clock (warn until the ladder closes it);
    # a fence rejection is the protocol WORKING (a stale serve/pull was
    # refused) but worth a look in bulk; an exhausted ladder means a
    # shard's state is gone from the zone — page.
    "shard_lost": "warn",
    "shard_recovered": "info",
    "shard_fence_rejected": "warn",
    "shard_recovery_failed": "page",
}

# The ambient trace id: set by Tracer.trace_scope around a round on the
# client side, and restored by the transport server around each handler
# task from the frame meta's ``tr`` field — which is how a leader's
# handler-side spans inherit the member's round trace with no new RPCs.
_CURRENT_TRACE: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "dvc_trace", default=None
)


def current_trace() -> Optional[str]:
    """The ambient round trace id, or None outside any traced round."""
    return _CURRENT_TRACE.get()


def set_current_trace(trace: Optional[str]) -> contextvars.Token:
    """Bind the ambient trace (transport server half; see module doc)."""
    return _CURRENT_TRACE.set(trace)


def reset_current_trace(token: contextvars.Token) -> None:
    try:
        _CURRENT_TRACE.reset(token)
    except ValueError:
        # Token from another context (a handler that migrated tasks) —
        # the var is request-scoped anyway; losing the reset is harmless.
        pass


# -- metrics registry --------------------------------------------------------


class Counter:
    """Monotone counter, optionally labeled. Thread-safe."""

    __slots__ = ("name", "help", "_lock", "_values")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def _scrape(self) -> dict:
        with self._lock:
            return {
                "type": "counter",
                "values": [
                    {"labels": dict(k), "value": v}
                    for k, v in self._values.items()
                ],
            }


class Gauge:
    """Last-write-wins gauge, optionally labeled or callback-sourced."""

    __slots__ = ("name", "help", "_lock", "_values", "_fn")

    def __init__(self, name: str, help: str = "", fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._fn = fn

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels: str) -> Optional[float]:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a gauge callback must not raise out
                return None
        return self._values.get(_label_key(labels))

    def _scrape(self) -> dict:
        if self._fn is not None:
            v = self.value()
            vals = [] if v is None else [{"labels": {}, "value": v}]
        else:
            with self._lock:
                vals = [
                    {"labels": dict(k), "value": v}
                    for k, v in self._values.items()
                ]
        return {"type": "gauge", "values": vals}


# Log2 histogram bucket upper bounds, in seconds, covering 1ms .. ~2min.
# Chosen once for every duration histogram in the swarm: cross-volunteer
# rollups can merge buckets without resampling.
HIST_BUCKETS: Tuple[float, ...] = tuple(0.001 * (2.0 ** i) for i in range(18))


class Histogram:
    """Log2-bucketed histogram (fixed shared buckets), optionally labeled."""

    __slots__ = ("name", "help", "_lock", "_series")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        # label key -> [counts per bucket (+inf last), total count, total sum]
        self._series: Dict[Tuple[Tuple[str, str], ...], list] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * (len(HIST_BUCKETS) + 1), 0, 0.0]
            counts, _, _ = s
            for i, ub in enumerate(HIST_BUCKETS):
                if value <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            s[1] += 1
            s[2] += float(value)

    def snapshot(self, **labels: str) -> Optional[dict]:
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None:
                return None
            return {"buckets": list(s[0]), "count": s[1], "sum": s[2]}

    def _scrape(self) -> dict:
        with self._lock:
            return {
                "type": "histogram",
                "bucket_bounds": list(HIST_BUCKETS),
                "values": [
                    {
                        "labels": dict(k),
                        "buckets": list(s[0]),
                        "count": s[1],
                        "sum": round(s[2], 6),
                    }
                    for k, s in self._series.items()
                ],
            }


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """One namespace of counters/gauges/histograms plus callback sources.

    ``source(prefix, fn)`` registers an existing ``stats()``-style dict
    callable; every scrape flattens its numeric leaves into gauges under
    ``<prefix>.<dotted.path>`` — the re-registration path that unifies the
    pre-telemetry ad-hoc dicts without rewriting the code that fills them.
    """

    # Bound on flattened series emitted per callback source per scrape:
    # the per-peer transport map can grow to MAX_PEER_STATS entries x 7
    # fields, and a scrape rides RPC replies/reports.
    MAX_SOURCE_SERIES = 512
    MAX_FLATTEN_DEPTH = 4

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._sources: Dict[str, Callable[[], dict]] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, Gauge, help)

    def gauge_fn(self, name: str, fn: Callable[[], float], help: str = "") -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Gauge(name, help, fn=fn)
            elif not isinstance(m, Gauge):
                # Same contract as every other accessor: a name collision
                # across metric types is a bug, not a silent no-op.
                raise ValueError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            elif m._fn is None:
                # A set()-style gauge pre-registered under this name: adopt
                # the callback rather than silently never reporting it.
                m._fn = fn
            return m

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_make(name, Histogram, help)

    def _get_or_make(self, name: str, cls, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def source(self, prefix: str, fn: Callable[[], dict]) -> None:
        """Register a stats()-style dict callable; scrapes flatten its
        numeric leaves into gauges under ``<prefix>.<path>``."""
        with self._lock:
            self._sources[prefix] = fn

    def _flatten(self, prefix: str, obj: Any, out: Dict[str, float], depth: int) -> None:
        if len(out) >= self.MAX_SOURCE_SERIES:
            return
        if isinstance(obj, bool):
            out[prefix] = float(obj)
        elif isinstance(obj, (int, float)):
            out[prefix] = float(obj)
        elif isinstance(obj, dict) and depth < self.MAX_FLATTEN_DEPTH:
            for k, v in obj.items():
                self._flatten(f"{prefix}.{k}", v, out, depth + 1)

    def scrape(self) -> dict:
        """Versioned point-in-time view of every metric and source."""
        with self._lock:
            metrics = dict(self._metrics)
            sources = dict(self._sources)
        out: Dict[str, Any] = {}
        for name, m in sorted(metrics.items()):
            out[name] = m._scrape()
        for prefix, fn in sorted(sources.items()):
            flat: Dict[str, float] = {}
            try:
                self._flatten(prefix, fn() or {}, flat, 0)
            except Exception as e:  # noqa: BLE001 — a source bug must not fail the scrape
                log.debug("telemetry source %s failed: %s", prefix, errstr(e))
                continue
            for name, v in flat.items():
                out[name] = {"type": "gauge", "values": [{"labels": {}, "value": v}]}
        return {"schema_version": TELEMETRY_SCHEMA_VERSION, "metrics": out}


# -- tracing -----------------------------------------------------------------


class Span:
    """One timed phase of a round. End exactly once (idempotent)."""

    __slots__ = ("tracer", "name", "trace", "attrs", "t0", "_pc0", "dur_s", "_done")

    def __init__(self, tracer: "Tracer", name: str, trace: str, attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.trace = trace
        self.attrs = attrs
        # Wall timestamp on the telemetry clock (ClockSync-aligned when the
        # volunteer has one) for cross-volunteer stitching; duration from
        # the monotonic clock so a mid-span offset correction cannot
        # produce a negative phase.
        self.t0 = tracer._clock()
        self._pc0 = time.perf_counter()
        self.dur_s = None
        self._done = False

    def end(self, **attrs: Any) -> None:
        if self._done:
            return
        self._done = True
        self.dur_s = time.perf_counter() - self._pc0
        if attrs:
            self.attrs.update(attrs)
        self.tracer._finish(self)

    def as_dict(self) -> dict:
        return {
            "trace": self.trace,
            "name": self.name,
            "peer": self.tracer.peer_id,
            "t0": round(self.t0, 6),
            "dur_s": round(self.dur_s, 6) if self.dur_s is not None else None,
            **({"attrs": self.attrs} if self.attrs else {}),
        }


class Tracer:
    """Bounded ring of finished spans, keyed by round trace id.

    Ended spans also land in the registry as the
    ``swarm.span_seconds{span=<name>}`` histogram — the metrics half of
    the span taxonomy, scrapeable without pulling whole traces.
    """

    MAX_SPANS = 4096

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        peer_id: str = "",
        clock: Callable[[], float] = time.time,
        enabled: bool = True,
    ):
        self.registry = registry
        self.peer_id = peer_id
        self.enabled = enabled
        self._clock = clock
        self._lock = threading.Lock()
        self._done: "deque[dict]" = deque(maxlen=self.MAX_SPANS)
        self._hist = registry.histogram(
            "swarm.span_seconds", "round phase durations by span name"
        ) if registry is not None else None
        # Finished-span hook (the watchdog's per-level round-wall feed):
        # called with each ended span's dict, exceptions swallowed.
        self.on_record: Optional[Callable[[dict], None]] = None

    def start(self, name: str, trace: Optional[str] = None, **attrs: Any) -> Optional[Span]:
        if not self.enabled:
            return None
        trace = trace or current_trace()
        if not trace:
            return None
        return Span(self, name, trace, attrs)

    def _finish(self, span: Span) -> None:
        try:
            sp = span.as_dict()
            with self._lock:
                self._done.append(sp)
            if self._hist is not None and span.dur_s is not None:
                self._hist.observe(span.dur_s, span=span.name)
            if self.on_record is not None:
                self.on_record(sp)
        except Exception as e:  # noqa: BLE001 — tracing must never fail the round
            log.debug("span finish failed: %s", errstr(e))

    def record(
        self, name: str, trace: str, t0: float, dur_s: float, **attrs: Any
    ) -> None:
        """Append an already-measured span retroactively — for phases
        (like ``join``) that finish before their round's trace id exists."""
        if not self.enabled or not trace:
            return
        sp: Dict[str, Any] = {
            "trace": trace,
            "name": name,
            "peer": self.peer_id,
            "t0": round(t0, 6),
            "dur_s": round(dur_s, 6),
        }
        if attrs:
            sp["attrs"] = attrs
        with self._lock:
            self._done.append(sp)
        if self._hist is not None:
            self._hist.observe(dur_s, span=name)
        if self.on_record is not None:
            try:
                self.on_record(sp)
            except Exception as e:  # noqa: BLE001 — the hook must not fail the caller
                log.debug("span hook failed: %s", errstr(e))

    @contextlib.contextmanager
    def span(self, name: str, trace: Optional[str] = None, **attrs: Any) -> Iterator[Optional[Span]]:
        sp = self.start(name, trace, **attrs)
        try:
            yield sp
        finally:
            if sp is not None:
                sp.end()

    @contextlib.contextmanager
    def trace_scope(self, trace: str) -> Iterator[None]:
        """Bind the ambient trace id for the duration of a round: spans
        started without an explicit trace, and every outbound
        ``Transport.call`` issued inside, inherit it."""
        token = set_current_trace(trace)
        try:
            yield
        finally:
            reset_current_trace(token)

    def spans(self, trace: Optional[str] = None, since: float = 0.0) -> List[dict]:
        with self._lock:
            out = list(self._done)
        if trace:
            out = [s for s in out if s["trace"] == trace]
        if since:
            out = [s for s in out if s["t0"] >= since]
        return out

    def clear(self) -> None:
        with self._lock:
            self._done.clear()


# -- flight recorder ---------------------------------------------------------


class FlightRecorder:
    """Bounded ring buffer of structured swarm events for post-mortems.

    Event kinds recorded by the swarm tier (the documented taxonomy —
    docs/OBSERVABILITY.md keeps the authoritative list):

    - ``leader_deposed`` — this node decided a deposition (failover).
    - ``fence_rejected`` — a push/fetch/recover carried a stale generation.
    - ``round_degraded`` — a round committed at its deadline with a subset.
    - ``round_failed`` — a round raised / skipped below min_group.
    - ``round_recovered`` / ``recovery_failed`` — failover outcomes.
    - ``backoff`` — the resilience backoff engaged/changed after failures.
    - ``method_escalated`` / ``method_deescalated`` — estimator ladder moves.
    - ``codec_degraded`` — the on-mesh data path fell back to host.
    - ``peer_quality_flagged`` — the contribution-quality score crossed
      the flag threshold for a peer (swarm/health.py).
    - ``mass_lost_at_deadline`` — a committed round excluded/aborted
      nonzero gradient mass (swarm/health.py).
    """

    MAX_EVENTS = 2048

    def __init__(
        self,
        peer_id: str = "",
        clock: Callable[[], float] = time.time,
        enabled: bool = True,
    ):
        self.peer_id = peer_id
        self.enabled = enabled
        self._clock = clock
        self._lock = threading.Lock()
        self._events: "deque[dict]" = deque(maxlen=self.MAX_EVENTS)
        self._seq = 0

    def record(self, kind: str, **fields: Any) -> None:
        if not self.enabled:
            return
        try:
            trace = fields.pop("trace", None) or current_trace()
            # Severity rides every event (triage tier for the alerting
            # plane): explicit sev= wins, else the documented per-kind
            # default, else "info".
            sev = fields.pop("sev", None) or KIND_SEVERITY.get(str(kind), "info")
            ev = {
                "seq": self._seq,
                "t": round(self._clock(), 6),
                "kind": str(kind),
                "sev": str(sev),
                "peer": self.peer_id,
            }
            if trace:
                ev["trace"] = trace
            ev.update(fields)
            with self._lock:
                ev["seq"] = self._seq
                self._seq += 1
                self._events.append(ev)
        except Exception as e:  # noqa: BLE001 — recording must never fail the caller
            log.debug("flight record failed: %s", errstr(e))

    def dump(
        self,
        since: float = 0.0,
        kinds: Optional[List[str]] = None,
        since_seq: Optional[int] = None,
    ) -> List[dict]:
        """Ring contents, filterable by time (``since``), kind, and the
        monotonic ``since_seq`` CURSOR (events with seq >= since_seq) —
        the incremental-poll half of the flight RPC: a watchdog poller or
        chaos collector passes the previous reply's ``next_seq`` back and
        re-ships only what's new instead of the whole ring."""
        with self._lock:
            out = list(self._events)
        if since:
            out = [e for e in out if e["t"] >= since]
        if since_seq is not None:
            out = [e for e in out if e["seq"] >= since_seq]
        if kinds:
            want = set(kinds)
            out = [e for e in out if e["kind"] in want]
        return out

    @property
    def next_seq(self) -> int:
        """The cursor a caller passes as ``since_seq`` next poll to see
        only events recorded after everything currently in the ring."""
        return self._seq

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


# -- the bundle --------------------------------------------------------------


class Telemetry:
    """Per-volunteer telemetry bundle: registry + tracer + flight recorder.

    One instance per process half (a volunteer, a coordinator replica),
    shared by the averager, membership, resilience policy, and transport
    via constructor injection. ``enabled=False`` short-circuits every
    record path (the overhead-smoke baseline and the ``--no-telemetry``
    escape hatch); the registry still answers scrapes (empty-ish) so the
    RPC surface never disappears mid-fleet.
    """

    def __init__(
        self,
        peer_id: str = "",
        clock: Callable[[], float] = time.time,
        enabled: bool = True,
        health_enabled: Optional[bool] = None,
        watchdog_enabled: Optional[bool] = None,
    ):
        self.peer_id = peer_id
        self.enabled = enabled
        self.clock = clock
        self.registry = MetricsRegistry()
        self.tracer = Tracer(self.registry, peer_id, clock, enabled=enabled)
        self.recorder = FlightRecorder(peer_id, clock, enabled=enabled)
        # Training-health layer (swarm/health.py): sketches, mass
        # accounting, contribution quality, codec distortion. Gated
        # independently (--no-health-probe disables the sketch/tally work
        # while the rest of the plane stays on); --no-telemetry disables
        # both. The object always exists so call sites stay branch-free.
        from distributedvolunteercomputing_tpu_torch.swarm import health as health_mod

        if health_enabled is None:
            health_enabled = enabled
        self.health = health_mod.HealthMonitor(
            self.registry, self.recorder, peer_id,
            enabled=bool(enabled and health_enabled), clock=clock,
        )
        # Watchdog layer (swarm/watchdog.py): streaming anomaly detectors
        # over the plane's own series. Gated independently the same way
        # (--no-watchdog keeps tracing/health on but ships no alert
        # bytes); --no-telemetry disables everything. Always constructed
        # so call sites stay branch-free.
        from distributedvolunteercomputing_tpu_torch.swarm import watchdog as watchdog_mod

        if watchdog_enabled is None:
            watchdog_enabled = enabled
        self.watchdog = watchdog_mod.Watchdog(
            self.registry, self.recorder, peer_id,
            enabled=bool(enabled and watchdog_enabled), clock=clock,
        )
        if self.watchdog.enabled:
            # Ended round spans feed the per-level wall detectors.
            self.tracer.on_record = self.watchdog.observe_span

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Adopt the ClockSync-corrected clock once the volunteer builds
        one (the averager/membership may construct telemetry earlier)."""
        self.clock = clock
        self.tracer._clock = clock
        self.recorder._clock = clock
        self.health.clock = clock
        self.watchdog.clock = clock

    # -- hot-path shorthands (None/no-op when disabled) ---------------------

    def span(self, name: str, trace: Optional[str] = None, **attrs: Any):
        return self.tracer.span(name, trace, **attrs)

    def event(self, kind: str, **fields: Any) -> None:
        self.recorder.record(kind, **fields)

    # -- RPC surface ---------------------------------------------------------

    def register_rpcs(self, transport) -> None:
        """Expose scrape/trace/flight over the swarm transport (debug +
        collection surface; trace_report and operators dial these)."""

        async def _scrape(args: dict, payload: bytes):
            return self.scrape(), b""

        async def _trace(args: dict, payload: bytes):
            return {
                "schema_version": TELEMETRY_SCHEMA_VERSION,
                "peer": self.peer_id,
                "spans": self.tracer.spans(
                    trace=args.get("trace") or None,
                    since=float(args.get("since") or 0.0),
                ),
            }, b""

        async def _flight(args: dict, payload: bytes):
            since_seq = args.get("since_seq")
            # Cursor read BEFORE the dump: an event recorded (from a
            # trainer/averager thread) between the two reads must show up
            # in the NEXT poll, not vanish — at-least-once duplication is
            # fine for a poller, a silently dropped event is not.
            next_seq = self.recorder.next_seq
            return {
                "schema_version": TELEMETRY_SCHEMA_VERSION,
                "peer": self.peer_id,
                "events": self.recorder.dump(
                    since=float(args.get("since") or 0.0),
                    kinds=args.get("kinds") or None,
                    since_seq=int(since_seq) if since_seq is not None else None,
                ),
                # Incremental cursor: pass back as since_seq next poll and
                # repeated dumps ship only new events, not the whole ring.
                "next_seq": next_seq,
            }, b""

        async def _prom(args: dict, payload: bytes):
            # Prometheus text exposition of the whole registry: any stock
            # scraper (or the --metrics-port HTTP shim) can watch this
            # volunteer without the coordinator.
            text = render_prom(self.registry.scrape())
            return {
                "peer": self.peer_id,
                "content_type": PROM_CONTENT_TYPE,
            }, text.encode()

        transport.register(SCRAPE_METHOD, _scrape)
        transport.register(TRACE_METHOD, _trace)
        transport.register(FLIGHT_METHOD, _flight)
        transport.register(PROM_METHOD, _prom)

    def scrape(self) -> dict:
        out = self.registry.scrape()
        out["peer"] = self.peer_id
        out["enabled"] = self.enabled
        # Training-health view (None when the probe is disabled): summary
        # plus the bounded sketch history — what trace_report matches
        # across peers by trace id for the per-round mixing-error column.
        out["health"] = self.health.scrape()
        # Watchdog view (None when disabled): the firing alert set plus
        # lifetime raise/clear totals and per-level wall histograms.
        out["watchdog"] = self.watchdog.summary()
        return out

    # -- report summary (rides the cp.exchange beat) -------------------------

    # Span-histogram names summarized into every report: the per-phase
    # latency evidence coord.status rolls up without shipping whole scrapes
    # every beat.
    SUMMARY_SPANS = (
        "round", "join", "encode", "wire", "fold", "commit", "health",
        "fetch", "recover",
    )

    def summary(self) -> dict:
        """Compact per-beat telemetry summary for the volunteer report:
        schema version, flight-recorder high-water, and per-span
        count/sum pairs (enough for rate + mean-latency rollups without
        shipping buckets every heartbeat)."""
        spans: Dict[str, dict] = {}
        hist = self.registry.histogram("swarm.span_seconds")
        for name in self.SUMMARY_SPANS:
            snap = hist.snapshot(span=name)
            if snap is not None:
                spans[name] = {
                    "count": snap["count"],
                    "sum_s": round(snap["sum"], 6),
                }
        return {
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "enabled": self.enabled,
            "events_recorded": self.recorder._seq,
            "spans": spans,
        }


# -- coord.status rollup -----------------------------------------------------

# The documented coord.status["telemetry"] schema, keyed by dotted path.
# Every entry must be present (None allowed only where marked) and typed
# as stated — tests/test_telemetry.py::test_status_telemetry_schema walks
# this table against a live rollup, so drift breaks CI instead of
# dashboards. per-peer / per-span maps are typed by their VALUE schema.
STATUS_TELEMETRY_SCHEMA: Dict[str, type] = {
    "schema_version": int,
    "reporting": int,          # volunteers whose fresh report carried telemetry
    "events_recorded_total": int,
    "spans": dict,             # span name -> {count, sum_s, mean_s}
    "per_peer": dict,          # peer id -> its report summary (verbatim)
    # v2: how many fresh reports also carried a training-health summary
    # (the full health rollup lives at coord.status["health"], pinned by
    # health.STATUS_HEALTH_SCHEMA).
    "health_reporting": int,
    # v3: staleness stamp — seconds since the FRESHEST contributing report
    # landed, stamped by the serving replica on the telemetry clock. A
    # frozen replica serves a growing age_s; a healthy quiet swarm serves
    # a small one. (Stamped at serve time, so rollup_status() output only
    # carries it after the replica's status path adds it.)
    "age_s": float,
}
STATUS_SPAN_SCHEMA: Dict[str, type] = {
    "count": int,
    "sum_s": float,
    "mean_s": float,
}


def rollup_status(fresh_reports: List[dict]) -> Optional[dict]:
    """Merge per-volunteer telemetry summaries (from fresh reports) into
    the versioned coord.status rollup. None until some volunteer reports
    telemetry — same contract as the multigroup rollup."""
    per_peer: Dict[str, dict] = {}
    for m in fresh_reports:
        t = m.get("telemetry")
        if isinstance(t, dict) and t.get("schema_version") == TELEMETRY_SCHEMA_VERSION:
            per_peer[str(m.get("peer", "?"))] = t
    if not per_peer:
        return None
    spans: Dict[str, dict] = {}
    for t in per_peer.values():
        for name, rec in (t.get("spans") or {}).items():
            agg = spans.setdefault(str(name), {"count": 0, "sum_s": 0.0})
            agg["count"] += int(rec.get("count") or 0)
            agg["sum_s"] += float(rec.get("sum_s") or 0.0)
    for agg in spans.values():
        agg["sum_s"] = round(agg["sum_s"], 6)
        agg["mean_s"] = round(agg["sum_s"] / agg["count"], 6) if agg["count"] else 0.0
    return {
        "schema_version": TELEMETRY_SCHEMA_VERSION,
        "reporting": len(per_peer),
        "events_recorded_total": sum(
            int(t.get("events_recorded") or 0) for t in per_peer.values()
        ),
        "spans": spans,
        "per_peer": per_peer,
        "health_reporting": sum(
            1 for m in fresh_reports if isinstance(m.get("health"), dict)
        ),
    }


# -- Prometheus text exposition ----------------------------------------------

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_PROM_NAME_RE = None


def _prom_name(name: str) -> str:
    global _PROM_NAME_RE
    if _PROM_NAME_RE is None:
        import re

        _PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
    out = _PROM_NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
        parts.append(f'{_prom_name(str(k))}="{v}"')
    return "{" + ",".join(parts) + "}"


def render_prom(scrape: dict) -> str:
    """Render a registry scrape (:meth:`MetricsRegistry.scrape`) in the
    Prometheus text exposition format, so any stock scraper can watch a
    volunteer directly — no coordinator, no custom client. Dotted names
    sanitize to underscores; histograms emit the standard cumulative
    ``_bucket``/``_sum``/``_count`` triple over the shared log2 bounds."""
    lines: List[str] = []
    for name, m in sorted((scrape.get("metrics") or {}).items()):
        pname = _prom_name(name)
        mtype = m.get("type")
        if mtype == "counter":
            lines.append(f"# TYPE {pname} counter")
            for v in m.get("values") or []:
                lines.append(
                    f"{pname}{_prom_label_str(v.get('labels') or {})} "
                    f"{float(v['value']):g}"
                )
        elif mtype == "gauge":
            lines.append(f"# TYPE {pname} gauge")
            for v in m.get("values") or []:
                lines.append(
                    f"{pname}{_prom_label_str(v.get('labels') or {})} "
                    f"{float(v['value']):g}"
                )
        elif mtype == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            bounds = m.get("bucket_bounds") or list(HIST_BUCKETS)
            for v in m.get("values") or []:
                labels = dict(v.get("labels") or {})
                acc = 0
                for ub, c in zip(bounds, v.get("buckets") or []):
                    acc += int(c)
                    lines.append(
                        f"{pname}_bucket"
                        f"{_prom_label_str({**labels, 'le': f'{ub:g}'})} {acc}"
                    )
                acc += int((v.get("buckets") or [0])[-1])
                lines.append(
                    f"{pname}_bucket"
                    f"{_prom_label_str({**labels, 'le': '+Inf'})} "
                    f"{int(v.get('count') or acc)}"
                )
                lines.append(
                    f"{pname}_sum{_prom_label_str(labels)} "
                    f"{float(v.get('sum') or 0.0):g}"
                )
                lines.append(
                    f"{pname}_count{_prom_label_str(labels)} "
                    f"{int(v.get('count') or 0)}"
                )
    return "\n".join(lines) + "\n"


class MetricsHTTPServer:
    """Minimal local HTTP shim serving ``GET /metrics`` in Prometheus text
    format (the ``--metrics-port`` toggle): hand-rolled over asyncio
    streams — no HTTP dependency — because the only consumers are stock
    scrapers doing one GET per interval. Binds the volunteer's host; port
    0 picks an ephemeral port (returned from :meth:`start`)."""

    def __init__(self, telemetry: "Telemetry", host: str = "127.0.0.1", port: int = 0):
        self.telemetry = telemetry
        self.host = host
        self.port = int(port)
        self._server = None

    async def start(self) -> Tuple[str, int]:
        import asyncio

        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("metrics endpoint on http://%s:%d/metrics", self.host, self.port)
        return self.host, self.port

    async def _handle(self, reader, writer) -> None:
        try:
            request = await reader.readline()
            # Drain headers (bounded) so keep-alive clients see a clean close.
            for _ in range(64):
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = request.decode("latin-1", "replace").split()
            path = parts[1] if len(parts) >= 2 else ""
            if parts[:1] == ["GET"] and path.split("?")[0] in ("/metrics", "/"):
                body = render_prom(self.telemetry.registry.scrape()).encode()
                head = (
                    "HTTP/1.0 200 OK\r\n"
                    f"Content-Type: {PROM_CONTENT_TYPE}\r\n"
                    f"Content-Length: {len(body)}\r\n\r\n"
                ).encode()
            else:
                body = b"watchdog: only /metrics lives here\n"
                head = (
                    "HTTP/1.0 404 Not Found\r\n"
                    f"Content-Length: {len(body)}\r\n\r\n"
                ).encode()
            writer.write(head + body)
            await writer.drain()
        except Exception as e:  # noqa: BLE001 — a broken scraper must not log-spam
            log.debug("metrics request failed: %s", errstr(e))
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
