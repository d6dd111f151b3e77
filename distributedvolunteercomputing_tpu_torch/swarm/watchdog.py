"""Swarm watchdog: streaming anomaly detection, SLO burn rates, and the
alert plane over the telemetry substrate.

PRs 10-11 built a complete sensor suite — round traces, a unified metrics
registry, a flight recorder, training-health signals — but nothing
CONSUMED it: every regression was found by a human reading chaos artifacts
after the fact. This module is the active consumer, in two halves:

- **Volunteer-side streaming detectors** (:class:`Watchdog`, one per
  telemetry bundle): robust online baselines (EWMA mean + EWMA-MAD band,
  warm-up gated — :class:`OnlineBaseline`) over the series every volunteer
  already produces. The stock detector catalog:

  ========================  =========  ==========================================
  kind                      severity   fires on
  ========================  =========  ==========================================
  ``commit_rate_collapse``  page       committed-round rate far below baseline
  ``round_wall_inflation``  warn       per-LEVEL round wall far above baseline
                                       (key = ``flat``/``intra``/``cross``)
  ``mass_frac_drop``        warn       ``mass_committed_frac`` far below baseline
  ``peer_bw_collapse``      warn       a per-peer bandwidth EWMA far below its
                                       own baseline (key = peer / link)
  ``cp_beat_failures``      warn       consecutive control-plane beat failures
                                       (streak, not baseline)
  ``byzantine_contributor`` page       the health monitor's quality flag set
                                       (key = flagged peer)
  ========================  =========  ==========================================

  Every transition is deduplicated and flap-suppressed (hysteresis: a
  separate clear band + consecutive-breach counts; plus a re-raise
  cooldown after each clear) and lands as an ``alert_raised`` /
  ``alert_cleared`` flight-recorder event. The compact firing set rides
  the existing ``cp.exchange`` report beat via :meth:`Watchdog.summary`
  — zero new RPC types, the PR-11 health-sketch pattern.

- **Replica-side SLO plane** (:class:`SwarmWatchdog`, one per
  control-plane replica): declarative objectives (:class:`SLO`, defaults
  in :data:`DEFAULT_SLOS`) evaluated with fast/slow multi-window burn
  rates over the merged rollup — committed-round rate, p99 round wall per
  level (merged from the per-volunteer shared-bucket histograms riding
  the report), ``mass_committed_frac``, and report freshness — plus the
  swarm-level detectors no single volunteer can see (cross-zone mixing
  stall over the health rollup's sketch dispersion). Rolled into
  ``coord.status["slo"]`` and ``coord.status["alerts"]`` under the
  CI-pinned :data:`STATUS_WATCHDOG_SCHEMA`.

Burn-rate semantics (the classic multi-window pair): each evaluation tick
is *good* when the objective's metric meets its bound; over a fast and a
slow window, ``burn = bad_fraction / (1 - target)`` — burn 1.0 spends the
error budget exactly at the objective's target rate, burn N spends it N
times faster. An objective is **burning** (alert ``slo_burn``) when BOTH
windows exceed their thresholds: the fast window gives detection latency,
the slow window suppresses blips.

Everything follows the telemetry plane's contract: advisory and bounded.
Record paths swallow their own exceptions, per-key maps are capped, and a
disabled watchdog (``--no-watchdog`` / ``--no-telemetry``) turns every
call into a no-op and ships NO alert bytes on the heartbeat.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from distributedvolunteercomputing_tpu_torch.swarm.telemetry import HIST_BUCKETS
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)

# Version stamp carried by every watchdog summary and the coord.status
# slo/alerts rollups (independent of TELEMETRY_SCHEMA_VERSION; both are
# CI-pinned by tests/test_watchdog.py).
WATCHDOG_SCHEMA_VERSION = 1

SEV_INFO, SEV_WARN, SEV_PAGE = "info", "warn", "page"
SEVERITIES = (SEV_INFO, SEV_WARN, SEV_PAGE)


# -- robust online baseline --------------------------------------------------


class OnlineBaseline:
    """EWMA mean + EWMA absolute-deviation (MAD-style) band, warm-up gated.

    The deviation floor (``max(mad, 5% of |mean|, 1e-9)``) keeps a
    perfectly-steady warm-up (mad 0) from turning numeric jitter into
    infinite deviations — the same degenerate-case guard the health
    monitor's quality threshold uses."""

    __slots__ = ("alpha", "warmup", "n", "mean", "mad")

    def __init__(self, alpha: float = 0.25, warmup: int = 4):
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.n = 0
        self.mean = 0.0
        self.mad = 0.0

    def observe(self, x: float, alpha: Optional[float] = None) -> None:
        a = self.alpha if alpha is None else float(alpha)
        x = float(x)
        self.n += 1
        if self.n == 1:
            self.mean = x
            self.mad = 0.0
            return
        dev = abs(x - self.mean)
        self.mean += a * (x - self.mean)
        self.mad += a * (dev - self.mad)

    @property
    def ready(self) -> bool:
        return self.n >= self.warmup

    def floor(self) -> float:
        return max(self.mad, 0.05 * abs(self.mean), 1e-9)

    def deviation(self, x: float) -> Optional[float]:
        """Signed deviation of ``x`` from the baseline mean, in floored
        MAD units. None while warming up — warm-up NEVER fires."""
        if not self.ready:
            return None
        return (float(x) - self.mean) / self.floor()


# -- detectors ---------------------------------------------------------------


class AnomalyDetector:
    """Baseline-band detector with hysteresis + cooldown flap suppression.

    One instance covers a whole labeled series family (``key`` = level,
    peer, link, ...) with an independent baseline per key. Lifecycle per
    key: WARM-UP (no fires, baseline learns) -> ARMED -> ``min_breaches``
    consecutive out-of-band observations RAISE -> firing until
    ``clear_breaches`` consecutive in-clear-band observations CLEAR ->
    ``cooldown_s`` suppresses an immediate re-raise. While breaching, the
    baseline adopts the anomalous values at ``alpha x adopt_frac`` only —
    the healthy regime holds, yet a genuine permanent regime shift
    eventually re-baselines instead of paging forever."""

    MAX_KEYS = 128

    def __init__(
        self,
        kind: str,
        *,
        direction: str = "high",  # "high": above-band anomalous; "low": below
        fire_dev: float = 4.0,
        clear_dev: float = 2.0,
        min_breaches: int = 2,
        clear_breaches: int = 2,
        cooldown_s: float = 10.0,
        warmup: int = 4,
        alpha: float = 0.25,
        adopt_frac: float = 0.125,
        severity: str = SEV_WARN,
        description: str = "",
    ):
        assert direction in ("high", "low")
        self.kind = kind
        self.direction = direction
        self.fire_dev = float(fire_dev)
        self.clear_dev = float(clear_dev)
        self.min_breaches = int(min_breaches)
        self.clear_breaches = int(clear_breaches)
        self.cooldown_s = float(cooldown_s)
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self.adopt_frac = float(adopt_frac)
        self.severity = severity
        self.description = description
        self._state: Dict[str, dict] = {}

    def _signed(self, dev: float) -> float:
        """Deviation in the BAD direction (positive = worse)."""
        return dev if self.direction == "high" else -dev

    def observe(self, now: float, value: float, key: str = "") -> List[dict]:
        st = self._state.get(key)
        if st is None:
            if len(self._state) >= self.MAX_KEYS:
                return []
            st = self._state[key] = {
                "base": OnlineBaseline(self.alpha, self.warmup),
                "breach": 0, "inband": 0, "firing": False,
                "since": 0.0, "last_clear": float("-inf"), "value": None,
            }
        base: OnlineBaseline = st["base"]
        dev = base.deviation(value)
        bad = dev is not None and self._signed(dev) >= self.fire_dev
        in_clear = dev is None or self._signed(dev) <= self.clear_dev
        # Baseline update: in-band at full alpha; breaching at a crawl.
        base.observe(value, alpha=None if not bad else self.alpha * self.adopt_frac)
        st["value"] = float(value)
        events: List[dict] = []
        if not st["firing"]:
            if bad:
                st["breach"] += 1
                if (
                    st["breach"] >= self.min_breaches
                    and now - st["last_clear"] >= self.cooldown_s
                ):
                    st["firing"] = True
                    st["since"] = now
                    st["inband"] = 0
                    events.append(self._event("alert_raised", now, key, st, dev))
            else:
                st["breach"] = 0
        else:
            if in_clear:
                st["inband"] += 1
                if st["inband"] >= self.clear_breaches:
                    st["firing"] = False
                    st["breach"] = 0
                    st["last_clear"] = now
                    events.append(self._event("alert_cleared", now, key, st, dev))
            else:
                st["inband"] = 0
        return events

    def _event(self, action: str, now: float, key: str, st: dict, dev) -> dict:
        return {
            "action": action,
            "kind": self.kind,
            "key": key,
            "severity": self.severity,
            "value": round(float(st["value"]), 6),
            "baseline": round(float(st["base"].mean), 6),
            "deviation": round(float(dev), 3) if dev is not None else None,
            "since": round(st["since"], 6),
            "t": round(now, 6),
        }

    def firing(self, key: str = "") -> bool:
        st = self._state.get(key)
        return bool(st and st["firing"])

    def drop_key(self, now: float, key: str) -> List[dict]:
        """Retire a key whose series went away (a departed peer): frees
        its slot under MAX_KEYS and CLEARS any firing alert — a series
        that stopped existing must not page forever."""
        st = self._state.pop(key, None)
        if st is None or not st["firing"]:
            return []
        return [self._event("alert_cleared", now, key, st, None)]


class StreakDetector:
    """Boolean-series detector: RAISE after ``bad_streak`` consecutive bad
    observations, CLEAR after ``good_streak`` consecutive good ones —
    hysteresis for series where 'how bad' is meaningless (a beat either
    failed over or it didn't, a peer is flagged or it isn't)."""

    MAX_KEYS = 128

    def __init__(
        self,
        kind: str,
        *,
        bad_streak: int = 3,
        good_streak: int = 2,
        severity: str = SEV_WARN,
        description: str = "",
    ):
        self.kind = kind
        self.bad_streak = int(bad_streak)
        self.good_streak = int(good_streak)
        self.severity = severity
        self.description = description
        self._state: Dict[str, dict] = {}

    def observe(self, now: float, bad: bool, key: str = "") -> List[dict]:
        st = self._state.get(key)
        if st is None:
            if len(self._state) >= self.MAX_KEYS:
                return []
            st = self._state[key] = {
                "bad": 0, "good": 0, "firing": False, "since": 0.0,
            }
        events: List[dict] = []
        if bad:
            st["bad"] += 1
            st["good"] = 0
        else:
            st["good"] += 1
            st["bad"] = 0
        if not st["firing"] and st["bad"] >= self.bad_streak:
            st["firing"] = True
            st["since"] = now
            events.append(self._event("alert_raised", now, key, st))
        elif st["firing"] and st["good"] >= self.good_streak:
            st["firing"] = False
            events.append(self._event("alert_cleared", now, key, st))
        return events

    def _event(self, action: str, now: float, key: str, st: dict) -> dict:
        return {
            "action": action,
            "kind": self.kind,
            "key": key,
            "severity": self.severity,
            "value": float(st["bad"]),
            "baseline": 0.0,
            "deviation": None,
            "since": round(st["since"], 6),
            "t": round(now, 6),
        }

    def firing(self, key: str = "") -> bool:
        st = self._state.get(key)
        return bool(st and st["firing"])


class StallDetector:
    """No-new-minimum detector for series that are supposed to keep being
    DRIVEN DOWN (cross-zone sketch dispersion: every cross rotation should
    produce a new low). Observations are fed only when the series moves
    (the caller dedups repeats); STALLED when the newest ``window``
    observations contain no value meaningfully below the previous window's
    minimum AND stay above ``floor`` — robust to the healthy intra/cross
    sawtooth, where dispersion re-grows between cross rotations but each
    cross rotation still sets a lower low."""

    def __init__(
        self,
        kind: str = "mixing_stall",
        *,
        window: int = 3,
        improve_tol: float = 0.1,
        floor: float = 0.05,
        severity: str = SEV_WARN,
        description: str = "",
    ):
        self.kind = kind
        self.window = int(window)
        self.improve_tol = float(improve_tol)
        self.floor = float(floor)
        self.severity = severity
        self.description = description
        self._hist: "deque[float]" = deque(maxlen=2 * self.window)
        self._firing = False
        self._since = 0.0
        self._last: Optional[float] = None

    def observe(self, now: float, value: float) -> List[dict]:
        value = float(value)
        if self._last is not None and value == self._last:
            return []  # not a new observation: nothing rotated
        self._last = value
        self._hist.append(value)
        if len(self._hist) < 2 * self.window:
            return []
        vals = list(self._hist)
        prev_min = min(vals[: self.window])
        new_min = min(vals[self.window:])
        stalled = (
            new_min >= (1.0 - self.improve_tol) * prev_min
            and new_min >= self.floor
        )
        events: List[dict] = []
        if stalled and not self._firing:
            self._firing = True
            self._since = now
            events.append(self._event("alert_raised", now, value, prev_min))
        elif self._firing and not stalled:
            self._firing = False
            events.append(self._event("alert_cleared", now, value, prev_min))
        return events

    def _event(self, action: str, now: float, value: float, prev_min: float) -> dict:
        return {
            "action": action,
            "kind": self.kind,
            "key": "",
            "severity": self.severity,
            "value": round(value, 9),
            "baseline": round(prev_min, 9),
            "deviation": None,
            "since": round(self._since, 6),
            "t": round(now, 6),
        }

    def firing(self) -> bool:
        return self._firing


# -- volunteer-side watchdog -------------------------------------------------


def _fold_hist(hist: list, value: float) -> None:
    """Fold one duration into a [counts, count, sum] record over the
    telemetry plane's shared log2 buckets (mergeable cross-volunteer)."""
    counts = hist[0]
    for i, ub in enumerate(HIST_BUCKETS):
        if value <= ub:
            counts[i] += 1
            break
    else:
        counts[-1] += 1
    hist[1] += 1
    hist[2] += float(value)


def hist_quantile(counts: List[int], q: float) -> Optional[float]:
    """Quantile estimate from shared-bucket counts (upper bound of the
    bucket the q-th observation lands in; +inf bucket reports the last
    finite bound x2 — a pessimistic, monotone tail estimate)."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= rank:
            if i < len(HIST_BUCKETS):
                return float(HIST_BUCKETS[i])
            return float(HIST_BUCKETS[-1] * 2.0)
    return float(HIST_BUCKETS[-1] * 2.0)


class Watchdog:
    """Per-volunteer streaming anomaly detection over the telemetry plane.

    Fed from two directions: :meth:`observe_span` consumes ended round
    spans (the tracer's ``on_record`` hook — per-level round wall), and
    :meth:`tick` — called once per report beat — samples the wired probes
    (commit counter, mass fraction, bandwidth EWMAs, beat outcomes).
    Alert transitions land in the flight recorder and the registry;
    :meth:`summary` is the compact per-beat view riding the report."""

    MAX_LEVELS = 8
    # Round-wall histogram window: p99 is estimated over the last 1-2
    # half-windows (5-10 min), so the SLO sees an inflation at report
    # cadence and stops burning within a window of heal.
    WALL_WINDOW_S = 600.0

    def __init__(
        self,
        registry=None,
        recorder=None,
        peer_id: str = "",
        enabled: bool = True,
        clock: Callable[[], float] = time.time,
    ):
        self.registry = registry
        self.recorder = recorder
        self.peer_id = peer_id
        self.enabled = enabled
        self.clock = clock
        self._lock = threading.Lock()
        self.detectors: Dict[str, Any] = {
            "commit_rate_collapse": AnomalyDetector(
                "commit_rate_collapse", direction="low", severity=SEV_PAGE,
                description="committed-round rate collapsed vs baseline",
            ),
            "round_wall_inflation": AnomalyDetector(
                "round_wall_inflation", direction="high", severity=SEV_WARN,
                description="round wall (per level) inflated vs baseline",
            ),
            "mass_frac_drop": AnomalyDetector(
                "mass_frac_drop", direction="low", severity=SEV_WARN,
                description="committed gradient-mass fraction dropped",
            ),
            "peer_bw_collapse": AnomalyDetector(
                "peer_bw_collapse", direction="low", severity=SEV_WARN,
                description="per-peer bandwidth EWMA collapsed",
            ),
            "cp_beat_failures": StreakDetector(
                "cp_beat_failures", bad_streak=3, good_streak=2,
                severity=SEV_WARN,
                description="control-plane beat failure streak",
            ),
            "byzantine_contributor": StreakDetector(
                "byzantine_contributor", bad_streak=1, good_streak=2,
                severity=SEV_PAGE,
                description="contribution-quality flag on a peer",
            ),
        }
        # Wired sample sources, called each tick with (now, dt, feed).
        self._probes: List[Callable[[float, Optional[float]], None]] = []
        self._firing: Dict[Tuple[str, str], dict] = {}
        self.raised_total = 0
        self.cleared_total = 0
        self._last_tick: Optional[float] = None
        # Per-level round-wall histograms over the SHARED telemetry
        # buckets: the report-beat evidence the replica merges for the
        # p99-per-level SLO (count/sum alone cannot give a p99). WINDOWED
        # — two half-window generations rotated in place, summary reports
        # their merge — because a lifetime-cumulative p99 both detects an
        # inflation late (N healthy rounds dilute it) and stays burning
        # long after heal. NOT a telemetry.Histogram: those are
        # cumulative by contract (counters merge across restarts); this
        # is a sliding estimate.
        self._wall_hists: Dict[str, Dict[str, list]] = {}
        self._wall_rotated: Optional[float] = None
        if enabled and registry is not None:
            self._alert_ctr = registry.counter(
                "swarm.watchdog.alerts_total",
                "alert transitions by kind and action",
            )
            self._firing_gauge = registry.gauge_fn(
                "swarm.watchdog.firing", lambda: float(len(self._firing)),
                "alerts currently firing on this volunteer",
            )
        else:
            self._alert_ctr = None

    # -- feeding -----------------------------------------------------------

    def observe_span(self, span: dict) -> None:
        """Tracer ``on_record`` hook: per-level round-wall observations
        (the round span carries ``level`` in its attrs)."""
        if not self.enabled:
            return
        try:
            if span.get("name") != "round":
                return
            dur = span.get("dur_s")
            if dur is None:
                return
            level = str((span.get("attrs") or {}).get("level") or "flat")
            now = self.clock()
            with self._lock:
                if self._wall_rotated is None:
                    self._wall_rotated = now
                elif now - self._wall_rotated >= self.WALL_WINDOW_S / 2:
                    # Rotate generations: current -> prev, fresh current.
                    for gens in self._wall_hists.values():
                        gens["prev"] = gens["cur"]
                        gens["cur"] = [[0] * (len(HIST_BUCKETS) + 1), 0, 0.0]
                    self._wall_rotated = now
                gens = self._wall_hists.get(level)
                if gens is None:
                    if len(self._wall_hists) >= self.MAX_LEVELS:
                        return
                    gens = self._wall_hists[level] = {
                        "cur": [[0] * (len(HIST_BUCKETS) + 1), 0, 0.0],
                        "prev": None,
                    }
                _fold_hist(gens["cur"], float(dur))
                events = self.detectors["round_wall_inflation"].observe(
                    now, float(dur), key=level
                )
            self._emit(events)
        except Exception as e:  # noqa: BLE001 — the watchdog must never fail a round
            log.debug("watchdog span observation failed: %s", errstr(e))

    def observe(self, kind: str, value: float, key: str = "") -> None:
        """Feed one observation into a baseline detector by kind (the
        probes and tests use this; unknown kinds are ignored)."""
        if not self.enabled:
            return
        det = self.detectors.get(kind)
        if det is None or not isinstance(det, AnomalyDetector):
            return
        with self._lock:
            events = det.observe(self.clock(), value, key=key)
        self._emit(events)

    def observe_bool(self, kind: str, bad: bool, key: str = "") -> None:
        if not self.enabled:
            return
        det = self.detectors.get(kind)
        if det is None or not isinstance(det, StreakDetector):
            return
        with self._lock:
            events = det.observe(self.clock(), bool(bad), key=key)
        self._emit(events)

    def annotate(self, kind: str, key: str, **fields) -> None:
        """Merge advisory context onto a FIRING alert (no-op otherwise):
        e.g. the hedged-recovery scorecard onto ``mass_frac_drop``, so the
        alert itself says whether an automated mitigation is already
        recovering the mass. Annotations ride the firing dict into
        ``alerts()``/``summary()``; they never change alert lifecycle."""
        if not self.enabled:
            return
        with self._lock:
            alert = self._firing.get((kind, key))
            if alert is not None:
                alert.update({k: v for k, v in fields.items() if v is not None})

    def retire_key(self, kind: str, key: str) -> None:
        """Drop a detector key whose underlying series went away (peer
        departed): clears any firing alert and frees the key slot."""
        if not self.enabled:
            return
        det = self.detectors.get(kind)
        if det is None or not isinstance(det, AnomalyDetector):
            return
        with self._lock:
            events = det.drop_key(self.clock(), key)
        self._emit(events)

    def add_probe(self, fn: Callable[[float, Optional[float]], None]) -> None:
        """Register a tick-time sampler ``fn(now, dt)`` that calls
        ``observe``/``observe_bool`` with fresh values. ``dt`` is None on
        the first tick (rates undefined)."""
        self._probes.append(fn)

    def wire_volunteer(
        self,
        averager=None,
        control_plane=None,
        health=None,
        bandwidths: Optional[Callable[[], Dict[str, float]]] = None,
    ) -> None:
        """Wire the stock volunteer probes over the surfaces PRs 1-11
        built. Each probe closes over delta state so repeated samples of
        an unchanged gauge do not fabricate observations."""
        if not self.enabled:
            return
        state: Dict[str, Any] = {}

        def probe(now: float, dt: Optional[float]) -> None:
            if averager is not None:
                ok = int(getattr(averager, "rounds_ok", 0))
                prev = state.get("rounds_ok")
                state["rounds_ok"] = ok
                if prev is not None and dt and dt > 0:
                    self.observe(
                        "commit_rate_collapse", (ok - prev) / dt * 60.0
                    )
            if health is not None and getattr(health, "enabled", False):
                n = int(getattr(health, "mass_rounds", 0))
                if n and state.get("mass_rounds") != n:
                    state["mass_rounds"] = n
                    last = getattr(health, "_last_mass", None)
                    if isinstance(last, dict):
                        # The tighter of the weight and slot views: a
                        # SILENT deadline-dropped straggler's undelivered
                        # weight is unknowable (counts 0 in the weight
                        # balance), so only the slot fraction shows it.
                        fracs = [
                            float(last[k]) for k in
                            ("mass_committed_frac", "slot_committed_frac")
                            if isinstance(last.get(k), (int, float))
                        ]
                        if fracs:
                            self.observe("mass_frac_drop", min(fracs))
                        # Hedged-recovery annotation: stamp the LATEST
                        # round's recovered mass onto any firing mass
                        # alert so an operator (and the doctor) can see
                        # whether the hedger is on the case. Stamped on
                        # every fresh report — zeros included — so a
                        # round where recovery stopped cannot leave a
                        # stale "mitigation active" claim on a
                        # still-firing alert.
                        self.annotate(
                            "mass_frac_drop", "",
                            hedge_recovered_weight=float(
                                last.get("recovered_weight") or 0.0
                            ),
                            hedge_recovered_slots=int(
                                last.get("recovered_slots") or 0
                            ),
                        )
                # Quality flags -> per-peer byzantine alerts. Feed every
                # currently-flagged peer as bad and every previously-fed
                # peer that unflagged as good, so clears happen.
                flagged = set(health.flagged_peers())
                seen = state.setdefault("byz_seen", set())
                for p in flagged | seen:
                    self.observe_bool("byzantine_contributor", p in flagged, key=p)
                seen |= flagged
            if bandwidths is not None:
                try:
                    cur = {
                        str(k): float(bps)
                        for k, bps in (bandwidths() or {}).items()
                        if bps is not None
                    }
                    for k, bps in cur.items():
                        self.observe("peer_bw_collapse", bps, key=k)
                    # Keys that vanished (departed peers, aged-out EWMAs):
                    # retire them, so a firing alert for a gone peer
                    # clears and churned host:port keys do not exhaust
                    # the detector's key cap.
                    for k in state.get("bw_seen", set()) - set(cur):
                        self.retire_key("peer_bw_collapse", k)
                    state["bw_seen"] = set(cur)
                except Exception as e:  # noqa: BLE001 — probe is advisory
                    log.debug("bandwidth probe failed: %s", errstr(e))
            if control_plane is not None:
                failed = int(control_plane.counters.get("calls_failed", 0))
                ok_calls = int(control_plane.counters.get("calls_ok", 0))
                pf, po = state.get("cp_failed", 0), state.get("cp_ok", 0)
                state["cp_failed"], state["cp_ok"] = failed, ok_calls
                if "cp_seeded" in state:
                    # A beat is bad when control-plane calls failed and
                    # none succeeded since the last tick; ticks with no
                    # control traffic at all observe nothing.
                    if failed > pf and ok_calls == po:
                        self.observe_bool("cp_beat_failures", True)
                    elif ok_calls > po:
                        self.observe_bool("cp_beat_failures", False)
                state["cp_seeded"] = True

        self.add_probe(probe)

    def tick(self) -> None:
        """One watchdog evaluation pass: sample every wired probe. Called
        once per report beat (the volunteer report build) or per round in
        the chaos campaigns."""
        if not self.enabled:
            return
        try:
            now = self.clock()
            dt = None if self._last_tick is None else max(now - self._last_tick, 0.0)
            self._last_tick = now
            for probe in self._probes:
                try:
                    probe(now, dt)
                except Exception as e:  # noqa: BLE001 — one probe must not kill the tick
                    log.debug("watchdog probe failed: %s", errstr(e))
        except Exception as e:  # noqa: BLE001
            log.debug("watchdog tick failed: %s", errstr(e))

    # -- alert bookkeeping ---------------------------------------------------

    def _emit(self, events: Iterable[dict]) -> None:
        for ev in events:
            akey = (ev["kind"], ev["key"])
            action = ev.pop("action")
            alert = {
                "kind": ev["kind"],
                "key": ev["key"],
                "severity": ev["severity"],
                "value": ev["value"],
                "baseline": ev["baseline"],
                "since": ev["since"],
            }
            with self._lock:
                if action == "alert_raised":
                    self._firing[akey] = alert
                    self.raised_total += 1
                else:
                    self._firing.pop(akey, None)
                    self.cleared_total += 1
            if self._alert_ctr is not None:
                self._alert_ctr.inc(alert=ev["kind"], action=action.split("_")[1])
            if self.recorder is not None:
                try:
                    self.recorder.record(
                        action,
                        alert=ev["kind"],
                        key=ev["key"],
                        sev=ev["severity"] if action == "alert_raised" else SEV_INFO,
                        value=ev["value"],
                        baseline=ev["baseline"],
                        deviation=ev["deviation"],
                    )
                except Exception:  # noqa: BLE001 — recording is advisory
                    pass

    def alerts(self) -> List[dict]:
        """Currently-firing alerts (deduplicated; sorted for stability)."""
        with self._lock:
            return [
                dict(self._firing[k]) for k in sorted(self._firing)
            ]

    def summary(self) -> Optional[dict]:
        """Compact per-beat watchdog view for the volunteer report (rides
        the batched ``cp.exchange`` beat). None when disabled — the
        heartbeat then carries no alert bytes at all."""
        if not self.enabled:
            return None
        with self._lock:
            firing = [dict(self._firing[k]) for k in sorted(self._firing)]
            walls = {}
            for level, gens in self._wall_hists.items():
                counts = list(gens["cur"][0])
                count, sum_s = gens["cur"][1], gens["cur"][2]
                if gens["prev"] is not None:
                    for i, c in enumerate(gens["prev"][0]):
                        counts[i] += c
                    count += gens["prev"][1]
                    sum_s += gens["prev"][2]
                walls[level] = {
                    "buckets": counts, "count": count,
                    "sum_s": round(sum_s, 6),
                }
            return {
                "schema_version": WATCHDOG_SCHEMA_VERSION,
                "firing": firing,
                "n_firing": len(firing),
                "raised_total": self.raised_total,
                "cleared_total": self.cleared_total,
                "round_wall": walls,
            }


# -- SLO plane ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective: ``metric`` (a key into the evaluation
    context) must meet ``bound`` (per ``direction``) on at least
    ``target`` of evaluation ticks; burn rates measure budget spend."""

    name: str
    metric: str
    bound: float
    direction: str = "min"  # "min": value >= bound is good; "max": <=
    target: float = 0.9
    fast_s: float = 60.0
    slow_s: float = 300.0
    fast_burn: float = 2.0
    slow_burn: float = 1.0
    per_level: bool = False
    description: str = ""


DEFAULT_SLOS: Tuple[SLO, ...] = (
    SLO(
        "committed_round_rate", metric="commit_rate_per_min", bound=1.0,
        direction="min",
        description="the swarm commits at least this many rounds/min",
    ),
    SLO(
        "round_wall_p99", metric="round_wall_p99", bound=10.0,
        direction="max", per_level=True,
        description="p99 round wall per hierarchy level stays under bound",
    ),
    SLO(
        "mass_committed_frac", metric="mass_committed_frac", bound=0.9,
        direction="min",
        description="committed gradient-mass fraction stays above bound",
    ),
    SLO(
        "status_freshness", metric="status_age_s", bound=30.0,
        direction="max", target=0.95,
        description="the freshest volunteer report stays younger than bound",
    ),
    SLO(
        # Zone-sharded training: how long a departed holder's shard stays
        # unrecovered. The metric is the recent-window MAX across the
        # fleet's ``sharding`` report sections (None when no recovery ran
        # recently — no tick, so unsharded swarms never burn this).
        "shard_recovery_latency", metric="shard_recovery_latency_s",
        bound=15.0, direction="max",
        description="recent shard recoveries complete within bound",
    ),
)

# Minimum ticks in the slow window before a burn verdict counts: two
# bad ticks on an empty window must not page.
MIN_BURN_TICKS = 3


class BurnRateTracker:
    """Fast/slow-window burn-rate accounting for one (SLO, level) pair."""

    def __init__(self, slo: SLO):
        self.slo = slo
        self._ticks: "deque[Tuple[float, bool]]" = deque()
        self.value: Optional[float] = None

    def observe(self, now: float, ok: bool, value: float) -> None:
        self.value = float(value)
        self._ticks.append((now, bool(ok)))
        cutoff = now - self.slo.slow_s
        while self._ticks and self._ticks[0][0] < cutoff:
            self._ticks.popleft()

    def evaluate(self, now: float) -> dict:
        # Time-filtered at EVALUATION, not just at observe: a tracker
        # whose metric became uncomputable (reporters gone) must see its
        # windows drain so a firing burn alert can clear, instead of
        # serving a frozen burn_slow forever.
        slow = [(t, ok) for t, ok in self._ticks if t >= now - self.slo.slow_s]
        fast = [(t, ok) for t, ok in slow if t >= now - self.slo.fast_s]
        budget = max(1.0 - self.slo.target, 1e-6)

        def burn(ticks):
            if not ticks:
                return 0.0
            bad = sum(1 for _, ok in ticks if not ok)
            return (bad / len(ticks)) / budget

        bf, bs = burn(fast), burn(slow)
        return {
            "value": self.value,
            "ticks": len(slow),
            "burn_fast": round(bf, 3),
            "burn_slow": round(bs, 3),
            "burning": (
                len(slow) >= MIN_BURN_TICKS
                and bf >= self.slo.fast_burn
                and bs >= self.slo.slow_burn
            ),
        }


# -- coord.status schema (CI-pinned) -----------------------------------------

# The documented coord.status["slo"] / coord.status["alerts"] sections —
# walked by tests/test_watchdog.py like STATUS_TELEMETRY_SCHEMA, so drift
# breaks CI instead of dashboards. Both sections are ALWAYS dicts (never
# None): the watchdog plane exists the moment a replica does. `age_s` is
# each section's staleness stamp on the telemetry clock — a frozen
# replica is distinguishable from a healthy quiet swarm.
STATUS_WATCHDOG_SCHEMA: Dict[str, Dict[str, type]] = {
    "slo": {
        "schema_version": int,
        "age_s": float,
        "objectives": dict,  # name[.level] -> STATUS_SLO_OBJECTIVE_SCHEMA
    },
    "alerts": {
        "schema_version": int,
        "age_s": float,
        "reporting": int,     # fresh reports that carried a watchdog summary
        "firing": list,       # ALERT_SCHEMA dicts, severity-major order
        "n_firing": int,
        "raised_total": int,  # reporters' lifetime raises + replica-local
        "cleared_total": int,
        "by_kind": dict,      # kind -> firing count
    },
}
# Value schema for one objective row. `value` may be None before the
# metric has ever been computable (e.g. no health reporters yet).
STATUS_SLO_OBJECTIVE_SCHEMA: Dict[str, tuple] = {
    "metric": (str,),
    "bound": (float, int),
    "direction": (str,),
    "target": (float, int),
    "value": (float, int, type(None)),
    "ticks": (int,),
    "burn_fast": (float, int),
    "burn_slow": (float, int),
    "burning": (bool,),
    "window_fast_s": (float, int),
    "window_slow_s": (float, int),
}
# One firing alert as served in coord.status["alerts"]["firing"].
ALERT_SCHEMA: Dict[str, tuple] = {
    "kind": (str,),
    "key": (str,),
    "severity": (str,),
    "peer": (str,),
    "value": (float, int),
    "baseline": (float, int),
    "since": (float, int),
}

_SEV_ORDER = {SEV_PAGE: 0, SEV_WARN: 1, SEV_INFO: 2}


class SwarmWatchdog:
    """Replica-side watchdog: SLO burn rates over the merged rollup, the
    swarm-level detectors no single volunteer can see (cross-zone mixing
    stall), and the alert rollup joining every reporter's firing set.

    One per control-plane replica; :meth:`evaluate` runs once per replica
    tick (and lazily on status serves, spacing-guarded so a status storm
    cannot inflate the burn windows)."""

    MIN_TICK_SPACING_S = 0.25

    def __init__(
        self,
        clock: Callable[[], float] = time.time,
        slos: Tuple[SLO, ...] = DEFAULT_SLOS,
        recorder=None,
        peer_id: str = "",
    ):
        self.clock = clock
        self.slos = tuple(slos)
        self.recorder = recorder
        self.peer_id = peer_id or "coordinator"
        self._trackers: Dict[Tuple[str, str], BurnRateTracker] = {}
        self.stall = StallDetector(
            "mixing_stall", severity=SEV_WARN,
            description="cross-zone sketch dispersion stopped converging",
        )
        self._firing: Dict[Tuple[str, str], dict] = {}
        self.raised_total = 0
        self.cleared_total = 0
        self._last_eval: Optional[float] = None
        self._state: Dict[str, Any] = {}

    # -- evaluation context --------------------------------------------------

    def _context(
        self, fresh: List[dict], multigroup: Optional[dict],
        health: Optional[dict], now: float,
    ) -> Dict[str, Any]:
        ctx: Dict[str, Any] = {}
        # Committed-round rate: the multigroup rollup's windowed rate when
        # present; otherwise a counter delta over the reporters' telemetry
        # round-span counts (covers single-group swarms).
        if multigroup and multigroup.get("commits_per_min") is not None:
            ctx["commit_rate_per_min"] = float(multigroup["commits_per_min"])
        else:
            total = 0
            latest = 0.0
            seen = False
            for m in fresh:
                t = m.get("telemetry")
                if isinstance(t, dict):
                    rec = (t.get("spans") or {}).get("round")
                    if isinstance(rec, dict):
                        total += int(rec.get("count") or 0)
                        seen = True
                        rt = m.get("recv_t")
                        if isinstance(rt, (int, float)):
                            latest = max(latest, float(rt))
            if seen:
                prev = self._state.get("round_total")
                prev_latest = self._state.get("round_latest")
                # Rate over REPORT refreshes, not evaluation ticks: an
                # eval landing between two report beats would otherwise
                # read a zero delta and log a spurious "0 commits/min"
                # bad tick against the SLO (observed live: beat/tick
                # aliasing burned the budget on a healthy swarm).
                if latest and (prev_latest is None or latest > prev_latest):
                    self._state["round_total"] = total
                    self._state["round_latest"] = latest
                    if prev is not None and prev_latest and latest > prev_latest:
                        delta = max(total - prev, 0)
                        ctx["commit_rate_per_min"] = (
                            delta / (latest - prev_latest) * 60.0
                        )
        # p99 round wall per level, merged from the reporters' shared-
        # bucket histograms riding the report beat.
        merged: Dict[str, List[int]] = {}
        for m in fresh:
            wd = m.get("watchdog")
            if not isinstance(wd, dict):
                continue
            for level, h in (wd.get("round_wall") or {}).items():
                buckets = h.get("buckets")
                if not isinstance(buckets, list):
                    continue
                acc = merged.setdefault(str(level), [0] * len(buckets))
                if len(acc) == len(buckets):
                    for i, c in enumerate(buckets):
                        acc[i] += int(c)
        ctx["round_wall_p99"] = {
            level: hist_quantile(counts, 0.99) for level, counts in merged.items()
        }
        if health:
            v = (health.get("mass") or {}).get("committed_frac_min")
            if isinstance(v, (int, float)):
                ctx["mass_committed_frac"] = float(v)
        # Shard-recovery latency: worst recent recovery across reporters
        # carrying a ``sharding`` section (zone-sharded swarms only —
        # absent everywhere leaves the metric None and the SLO untouched).
        lat = [
            (m.get("sharding") or {}).get("recent_recovery_latency_s")
            for m in fresh
            if isinstance(m.get("sharding"), dict)
        ]
        lat = [float(v) for v in lat if isinstance(v, (int, float))]
        if lat:
            ctx["shard_recovery_latency_s"] = max(lat)
        recvs = [
            m.get("recv_t") for m in fresh
            if isinstance(m.get("recv_t"), (int, float))
        ]
        if recvs:
            self._state["last_recv"] = max(
                self._state.get("last_recv", 0.0), max(recvs)
            )
        # Freshness from the newest report EVER seen, not just the
        # currently-fresh set: during a total reporter outage the fresh
        # set empties (the replica's FRESH_S filter), and computing age
        # only from it would make the freshness objective go blind — and
        # its firing alert auto-clear — on exactly the severest outage.
        last = self._state.get("last_recv")
        if last:
            ctx["status_age_s"] = max(0.0, now - last)
        return ctx

    # -- evaluation ----------------------------------------------------------

    def evaluate(
        self,
        fresh_reports: List[dict],
        multigroup: Optional[dict] = None,
        health: Optional[dict] = None,
        now: Optional[float] = None,
    ) -> None:
        """One SLO/detector evaluation tick over the merged view. Safe to
        call from both the replica tick and the status path — spacing-
        guarded so double evaluation cannot inflate the burn windows."""
        now = self.clock() if now is None else float(now)
        if self._last_eval is not None and now - self._last_eval < self.MIN_TICK_SPACING_S:
            return
        self._last_eval = now
        try:
            ctx = self._context(fresh_reports, multigroup, health, now)
            events: List[dict] = []
            for slo in self.slos:
                if slo.per_level:
                    pairs = list((ctx.get(slo.metric) or {}).items())
                else:
                    pairs = [("", ctx.get(slo.metric))]
                for level, value in pairs:
                    if value is None:
                        continue
                    tk = (slo.name, level)
                    tr = self._trackers.get(tk)
                    if tr is None:
                        tr = self._trackers[tk] = BurnRateTracker(slo)
                    ok = (
                        value >= slo.bound
                        if slo.direction == "min"
                        else value <= slo.bound
                    )
                    tr.observe(now, ok, value)
            # Raise/clear over ALL trackers, observed this tick or not: a
            # firing burn alert whose metric became uncomputable (health
            # reporters gone, level retired) must still CLEAR as its
            # time-filtered windows drain — the alert plane and the slo
            # section must never contradict each other.
            for (name, level), tr in self._trackers.items():
                res = tr.evaluate(now)
                slo = tr.slo
                akey = ("slo_burn", f"{name}.{level}" if level else name)
                firing = akey in self._firing
                value = tr.value if tr.value is not None else 0.0
                if res["burning"] and not firing:
                    events.append({
                        "action": "alert_raised", "kind": "slo_burn",
                        "key": akey[1], "severity": SEV_PAGE,
                        "value": round(float(value), 6),
                        "baseline": float(slo.bound),
                        "deviation": res["burn_fast"],
                        "since": round(now, 6), "t": round(now, 6),
                    })
                elif firing and not res["burning"] and res["burn_fast"] < 1.0:
                    events.append({
                        "action": "alert_cleared", "kind": "slo_burn",
                        "key": akey[1], "severity": SEV_INFO,
                        "value": round(float(value), 6),
                        "baseline": float(slo.bound),
                        "deviation": res["burn_fast"],
                        "since": self._firing[akey]["since"],
                        "t": round(now, 6),
                    })
            # Cross-zone mixing stall over the health rollup's across-zone
            # sketch dispersion (the signal ROADMAP item 1's controller
            # needs to learn cross_zone_every_k).
            across = ((health or {}).get("mixing") or {}).get("across_zones")
            if isinstance(across, dict) and isinstance(
                across.get("rel"), (int, float)
            ):
                events.extend(self.stall.observe(now, float(across["rel"])))
            self._emit(events)
        except Exception as e:  # noqa: BLE001 — the watchdog must not kill the tick
            log.debug("swarm watchdog evaluation failed: %s", errstr(e))

    def _emit(self, events: Iterable[dict]) -> None:
        for ev in events:
            akey = (ev["kind"], ev["key"])
            action = ev.pop("action")
            if action == "alert_raised":
                self._firing[akey] = {
                    "kind": ev["kind"], "key": ev["key"],
                    "severity": ev["severity"], "value": ev["value"],
                    "baseline": ev["baseline"], "since": ev["since"],
                }
                self.raised_total += 1
            else:
                self._firing.pop(akey, None)
                self.cleared_total += 1
            if self.recorder is not None:
                try:
                    self.recorder.record(
                        action, alert=ev["kind"], key=ev["key"],
                        sev=ev["severity"], value=ev["value"],
                        baseline=ev["baseline"],
                    )
                except Exception:  # noqa: BLE001
                    pass

    # -- status sections -----------------------------------------------------

    def slo_status(self, now: Optional[float] = None) -> dict:
        now = self.clock() if now is None else float(now)
        objectives: Dict[str, dict] = {}
        for (name, level), tr in sorted(self._trackers.items()):
            res = tr.evaluate(now)
            slo = tr.slo
            objectives[f"{name}.{level}" if level else name] = {
                "metric": slo.metric,
                "bound": slo.bound,
                "direction": slo.direction,
                "target": slo.target,
                "value": res["value"],
                "ticks": res["ticks"],
                "burn_fast": res["burn_fast"],
                "burn_slow": res["burn_slow"],
                "burning": res["burning"],
                "window_fast_s": slo.fast_s,
                "window_slow_s": slo.slow_s,
            }
        return {
            "schema_version": WATCHDOG_SCHEMA_VERSION,
            "age_s": round(
                max(0.0, now - self._last_eval) if self._last_eval else -1.0, 3
            ),
            "objectives": objectives,
        }

    def alerts_status(
        self, fresh_reports: List[dict], now: Optional[float] = None
    ) -> dict:
        """The swarm-wide alert rollup: every fresh reporter's firing set
        (riding the report beat) joined with the replica-local swarm-level
        alerts, severity-major."""
        now = self.clock() if now is None else float(now)
        firing: List[dict] = []
        reporting = 0
        raised = self.raised_total
        cleared = self.cleared_total
        for m in fresh_reports:
            wd = m.get("watchdog")
            if not isinstance(wd, dict) or wd.get(
                "schema_version"
            ) != WATCHDOG_SCHEMA_VERSION:
                continue
            reporting += 1
            raised += int(wd.get("raised_total") or 0)
            cleared += int(wd.get("cleared_total") or 0)
            peer = str(m.get("peer", "?"))
            for a in wd.get("firing") or []:
                if isinstance(a, dict):
                    firing.append({**a, "peer": peer})
        for a in self._firing.values():
            firing.append({**a, "peer": self.peer_id})
        firing.sort(
            key=lambda a: (
                _SEV_ORDER.get(a.get("severity"), 9),
                a.get("kind", ""), a.get("peer", ""), a.get("key", ""),
            )
        )
        by_kind: Dict[str, int] = {}
        for a in firing:
            by_kind[a["kind"]] = by_kind.get(a["kind"], 0) + 1
        return {
            "schema_version": WATCHDOG_SCHEMA_VERSION,
            "age_s": round(
                max(0.0, now - self._last_eval) if self._last_eval else -1.0, 3
            ),
            "reporting": reporting,
            "firing": firing,
            "n_firing": len(firing),
            "raised_total": raised,
            "cleared_total": cleared,
            "by_kind": by_kind,
        }
