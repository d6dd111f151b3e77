"""Training-health telemetry: live mixing error, gradient-mass accounting,
per-peer contribution quality, and codec distortion.

PR 10's telemetry plane answers *where the wall-clock goes*; this module
answers *whether the learning is healthy*. Four signals, all riding the
existing surfaces (metrics registry, flight recorder, the ``cp.exchange``
report beat — zero new RPC types):

- **Live mixing error** (:func:`params_sketch` / :func:`sketch_dispersion`):
  every peer folds a seeded random-projection sketch of its POST-ROUND
  parameters into its report. The projection is a blocked
  Johnson-Lindenstrauss map over a seeded coordinate subsample — the seed
  is swarm-constant (derived from the averaging namespace), so every
  peer's sketch lives in the SAME k-dim space and cross-peer sketch
  distances estimate cross-peer parameter distances (relative error
  ~1/sqrt(2k) per pair). Control-plane replicas compute cross-peer sketch
  dispersion per zone into ``coord.status["health"]["mixing"]`` — the
  hierarchy bench's offline "equal mixing error" criterion, watched live.

- **Gradient-mass accounting**: every committed round classifies each
  armed peer's declared weight into exactly one of included / excluded /
  aborted (``StreamingAggregator.mass_report`` on streaming rounds,
  :func:`mass_from_outcomes` on dense ones), so included + excluded +
  aborted == total armed weight BY CONSTRUCTION and the cost of
  deadline-dropping stragglers is a first-class metric
  (``swarm.health.mass_committed_frac``). A silent peer's undelivered
  weight is unknowable to the leader and counts 0 toward the balance —
  it still counts as one excluded SLOT.

- **Per-peer contribution quality** (:class:`HealthMonitor`): the window
  folds and dense stacks already hold per-peer rows next to the robust
  aggregate; a row whose squared distance to the aggregate exceeds
  ``OUTLIER_FACTOR²`` x the median row's is an outlier vote. Votes decay
  into a per-peer flag rate; a peer whose rate crosses FLAG_RATE after
  FLAG_MIN_ROUNDS observations is FLAGGED — ``peer_quality_flagged`` in
  the flight recorder, the quality map in the report, and (via the
  averager's hook) a ``health_flagged`` field in the membership record.
  Quality needs per-peer rows, so it covers the robust estimators
  (window/d2_dense/dense tile modes and the byzantine full mesh); a
  ``mean`` swarm first escalates via the resilience ladder.

- **Codec distortion**: per-round relative compression error per wire
  format — the EF-residual norm over the gradient norm on the lossy
  wires (topk/powersgd/sign, exactly the mass error feedback re-stages),
  a sampled round-trip estimate on bf16/q8, and 0 on f32. The raw
  material for ranking wire formats by convergence-per-byte (ROADMAP
  item 1).

Everything here follows the telemetry plane's contract: advisory and
bounded — record paths swallow their own exceptions, per-peer maps are
capped, and a disabled monitor (``--no-telemetry`` / ``--no-health-probe``)
turns every call into a no-op and ships NO sketch bytes on the heartbeat.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)

# Version stamp carried by every health summary and the coord.status
# rollup (independent of TELEMETRY_SCHEMA_VERSION: the two surfaces can
# evolve separately; both are CI-pinned).
HEALTH_SCHEMA_VERSION = 1

# Sketch geometry. dim = projected dimensionality (the sketch is dim f32
# values, 256 B at 64 — "few KB" with history); sample = max coordinates
# fed to the projection (a seeded with-replacement subsample when the
# model is bigger, an unbiased dispersion estimator); block = projection
# matrix tile (cached per seed, so steady-state sketches are one small
# matmul, not fresh Gaussian generation).
DEFAULT_SKETCH_DIM = 64
DEFAULT_SKETCH_SAMPLE = 32_768
_SKETCH_BLOCK = 8_192

# Cached projection blocks keyed by (seed, dim, block_index) and cached
# subsample indices keyed by (seed, n_elems, sample): the seed is
# swarm-constant, so these are computed once per process, not per round.
_PROJ_CACHE: Dict[Tuple[int, int, int], np.ndarray] = {}
_IDX_CACHE: Dict[Tuple[int, int, int], np.ndarray] = {}
_CACHE_LOCK = threading.Lock()
_PROJ_CACHE_MAX = 16
_IDX_CACHE_MAX = 8


def sketch_seed(namespace: str = "") -> int:
    """Swarm-constant sketch seed: every peer averaging the same namespace
    derives the same projection, which is what makes sketches comparable
    across the swarm without negotiating anything on the wire."""
    return zlib.crc32(f"dvc-health/{namespace}".encode()) & 0x7FFFFFFF


def _proj_block(seed: int, dim: int, block_idx: int, rows: int) -> np.ndarray:
    key = (seed, dim, block_idx)
    with _CACHE_LOCK:
        r = _PROJ_CACHE.get(key)
    if r is None or r.shape[0] < rows:
        rng = np.random.default_rng((seed, dim, block_idx))
        r = rng.standard_normal((_SKETCH_BLOCK, dim)).astype(np.float32)
        with _CACHE_LOCK:
            if len(_PROJ_CACHE) >= _PROJ_CACHE_MAX:
                _PROJ_CACHE.clear()
            _PROJ_CACHE[key] = r
    return r[:rows]


def _sample_idx(seed: int, n: int, sample: int) -> np.ndarray:
    key = (seed, n, sample)
    with _CACHE_LOCK:
        idx = _IDX_CACHE.get(key)
    if idx is None:
        # With-replacement: O(sample) regardless of n, deterministic per
        # (seed, n) — every peer picks the SAME coordinates.
        idx = np.random.default_rng((seed, n)).integers(0, n, size=sample)
        with _CACHE_LOCK:
            if len(_IDX_CACHE) >= _IDX_CACHE_MAX:
                _IDX_CACHE.clear()
            _IDX_CACHE[key] = idx
    return idx


def params_sketch(
    buf: np.ndarray,
    seed: int,
    dim: int = DEFAULT_SKETCH_DIM,
    sample: int = DEFAULT_SKETCH_SAMPLE,
) -> np.ndarray:
    """Seeded random-projection sketch of a flat f32 parameter buffer.

    ``sketch = x_sel @ R / sqrt(dim)`` where ``x_sel`` is a seeded
    coordinate subsample (all coordinates when the buffer is small) and
    ``R`` is a blocked seeded Gaussian matrix — the classic JL map, so
    for two peers sharing a seed ``||s_a - s_b|| ~= ||x_a_sel - x_b_sel||``
    with relative error ~1/sqrt(2·dim). Deterministic: same (buf, seed,
    dim, sample) always yields the same sketch on every peer."""
    x = np.ascontiguousarray(buf, np.float32).ravel()
    if x.size > sample:
        x = x[_sample_idx(seed, x.size, sample)]
    out = np.zeros(dim, np.float64)
    for bi, e0 in enumerate(range(0, x.size, _SKETCH_BLOCK)):
        chunk = x[e0 : e0 + _SKETCH_BLOCK]
        out += chunk.astype(np.float64) @ _proj_block(seed, dim, bi, chunk.size)
    return (out / np.sqrt(float(dim))).astype(np.float32)


def sketch_dispersion(sketches: List[np.ndarray]) -> Optional[dict]:
    """Cross-peer dispersion of a set of same-space sketches: the live
    mixing-error estimate.

    ``rms`` = root-mean-square deviation from the sketch mean (same units
    as the sketched values); ``rel`` = rms normalized by the RMS sketch
    norm — scale-free, directly comparable to a relative parameter
    dispersion computed offline (hierarchy_bench-style), and ~0 when all
    peers hold (numerically) equal parameters."""
    vs = [np.asarray(s, np.float64).ravel() for s in sketches if s is not None]
    if len(vs) < 2 or len({v.size for v in vs}) != 1:
        return None
    stack = np.stack(vs)
    mean = stack.mean(axis=0)
    dev = stack - mean[None, :]
    rms = float(np.sqrt((dev * dev).sum(axis=1).mean()))
    norm = float(np.sqrt((stack * stack).sum(axis=1).mean()))
    return {
        "n": len(vs),
        "rms": round(rms, 9),
        "rel": round(rms / norm, 9) if norm > 0 else 0.0,
    }


def row_d2(stack: np.ndarray, agg: np.ndarray) -> np.ndarray:
    """Per-row squared L2 distance to the aggregate, in float64 — THE
    contribution-quality attribution metric, shared by every vantage that
    holds rows next to a robust aggregate (window tile folds, the dense
    finalize paths, the sync leader's dense branch, the byzantine full
    mesh) so the metric can never silently diverge between them.

    Row-at-a-time: the dense call sites hold param-scale [n, D] stacks,
    and a whole-stack float64 upcast would transiently double-plus the
    round's resident memory; one O(D) f64 deviation per row accumulates
    to the same values."""
    agg64 = np.asarray(agg, np.float64).ravel()
    out = np.empty(stack.shape[0], np.float64)
    for i in range(stack.shape[0]):
        dev = np.asarray(stack[i], np.float64).ravel() - agg64
        out[i] = float(dev @ dev)
    return out


def mass_from_outcomes(
    expected: Iterable[str],
    included_w: Dict[str, float],
    aborted: Iterable[str] = (),
) -> dict:
    """Mass report for a DENSE (non-streaming) round, from what the
    aggregating vantage knows: arrived contributions carry their declared
    weight; an expected peer that never delivered counts one excluded
    slot at weight 0 (its undelivered mass is unknowable here)."""
    aborted = set(aborted)
    per_peer: Dict[str, dict] = {}
    for p in expected:
        if p in included_w:
            per_peer[p] = {"outcome": "included", "weight": float(included_w[p])}
        elif p in aborted:
            per_peer[p] = {"outcome": "aborted", "weight": 0.0}
        else:
            per_peer[p] = {"outcome": "excluded", "weight": 0.0}
    return mass_report_from_per_peer(per_peer)


def mass_report_from_per_peer(per_peer: Dict[str, dict]) -> dict:
    """Fold a per-peer outcome/weight classification into the balanced
    mass report (each peer in exactly one bucket, so the weights sum by
    construction — the property test's invariant). ``recovered`` is the
    tail-optimal pipeline's bucket: mass that COMMITTED, but only because
    hedged re-requests / summand redundancy finished a straggling
    contribution — split from ``included`` so the hedger's win is
    auditable per round while both count toward the committed fraction."""
    sums = {"included": 0.0, "recovered": 0.0, "excluded": 0.0, "aborted": 0.0}
    counts = {"included": 0, "recovered": 0, "excluded": 0, "aborted": 0}
    for rec in per_peer.values():
        oc = rec["outcome"]
        sums[oc] += float(rec["weight"])
        counts[oc] += 1
    armed_w = sum(sums.values())
    committed_w = sums["included"] + sums["recovered"]
    committed_n = counts["included"] + counts["recovered"]
    n = len(per_peer)
    if armed_w > 0:
        frac = committed_w / armed_w
    elif n:
        frac = committed_n / n
    else:
        frac = 1.0
    # Round the buckets first and report their EXACT sum as armed_weight:
    # independently-rounded buckets against an independently-rounded
    # total could miss the balance invariant by ~2e-6, which is exactly
    # what the property tests and the chaos verdict assert against.
    rounded = {oc: round(sums[oc], 6) for oc in sums}
    return {
        "armed_slots": n,
        "armed_weight": round(sum(rounded.values()), 6),
        "included_slots": counts["included"],
        "included_weight": rounded["included"],
        "recovered_slots": counts["recovered"],
        "recovered_weight": rounded["recovered"],
        "excluded_slots": counts["excluded"],
        "excluded_weight": rounded["excluded"],
        "aborted_slots": counts["aborted"],
        "aborted_weight": rounded["aborted"],
        "mass_committed_frac": round(frac, 6),
        # The slot view alongside the weight view: a SILENT peer's
        # undelivered weight is unknowable (counts 0 above), so the slot
        # fraction is what shows a deadline-dropped straggler's cost when
        # its push never declared a weight at all.
        "slot_committed_frac": round(committed_n / n, 6) if n else 1.0,
        "per_peer": per_peer,
    }


def mass_by_shard(report: dict) -> Dict[str, dict]:
    """Roll a balanced mass report up per shard domain (zone-sharded
    training): per_peer entries carrying a ``shard`` tag bucket under
    ``"s<k>"``, untagged entries under ``"~"``. Each sub-report is itself
    balanced (same rounding rule as the parent), so a shard-holder death
    reads as ONE shard's committed fraction dipping while the others hold
    at 1.0 — the signal the ``shard_zone_degraded`` doctor rule and the
    campaign verdict consume. An unsharded round returns a single ``"~"``
    bucket equal to the parent report."""
    groups: Dict[str, Dict[str, dict]] = {}
    for pid, rec in (report.get("per_peer") or {}).items():
        s = rec.get("shard")
        tag = f"s{int(s)}" if isinstance(s, int) and not isinstance(s, bool) else "~"
        groups.setdefault(tag, {})[pid] = rec
    return {tag: mass_report_from_per_peer(pp) for tag, pp in sorted(groups.items())}


class HealthMonitor:
    """Per-volunteer training-health state: quality, mass, sketch, codec.

    One per telemetry bundle (``Telemetry.health``), shared by the
    averager and the streaming aggregator. All record paths are advisory:
    they must never fail a round, so they swallow their own exceptions;
    a disabled monitor no-ops everything and ``summary()`` returns None —
    the report beat then carries no health bytes at all."""

    MAX_PEERS = 256
    MAX_SKETCH_HISTORY = 32
    # Quality flagging: a row whose squared distance to the robust
    # aggregate exceeds OUTLIER_FACTOR² x the (floored) median row's is
    # one outlier vote; votes EWMA into a flag rate, and a peer crosses
    # into FLAGGED at rate >= FLAG_RATE after >= FLAG_MIN_ROUNDS
    # observations (unflagged again once the rate decays under
    # UNFLAG_RATE — persistent, not one unlucky round).
    OUTLIER_FACTOR = 3.0
    FLAG_MIN_ROUNDS = 3
    FLAG_RATE = 0.5
    UNFLAG_RATE = 0.2
    QUALITY_ALPHA = 0.25
    # Absolute floor on the outlier threshold (squared distance): a round
    # where every row sits within numeric noise of the aggregate (the
    # all-equal degenerate case) must flag nobody — relative rules alone
    # would amplify 1e-12-scale jitter into votes.
    D2_FLOOR = 1e-9

    def __init__(
        self,
        registry,
        recorder=None,
        peer_id: str = "",
        enabled: bool = True,
        clock: Callable[[], float] = time.time,
        sketch_dim: int = DEFAULT_SKETCH_DIM,
        sketch_sample: int = DEFAULT_SKETCH_SAMPLE,
    ):
        self.registry = registry
        self.recorder = recorder
        self.peer_id = peer_id
        self.enabled = enabled
        self.clock = clock
        self.sketch_dim = int(sketch_dim)
        self.sketch_sample = int(sketch_sample)
        self.seed = sketch_seed("")
        # Zone advertised in the health summary (the rollup's per-zone
        # dispersion join key); the averager wires its zone property in.
        self.zone_fn: Optional[Callable[[], str]] = None
        # Called with the sorted flagged-peer list on every flag-set
        # change (the averager surfaces it into the membership record).
        self.on_flag: Optional[Callable[[List[str]], None]] = None
        self._lock = threading.Lock()
        # peer -> {rounds, outlier_rounds, rate (EWMA), flagged}
        self._quality: Dict[str, dict] = {}
        self._flagged: set = set()
        self._lost_mass: Dict[str, float] = {}
        self._sketches: "deque[dict]" = deque(maxlen=self.MAX_SKETCH_HISTORY)
        self._last_mass: Optional[dict] = None
        self._codec: Dict[str, dict] = {}
        self.rounds_observed = 0
        # Committed-round mass reports folded (the watchdog's "is there a
        # NEW mass observation this tick" cursor).
        self.mass_rounds = 0
        self.sketches_computed = 0
        if enabled and registry is not None:
            self._mass_gauge = registry.gauge(
                "swarm.health.mass_committed_frac",
                "fraction of armed gradient mass committed last round",
            )
            self._mass_ctr = registry.counter(
                "swarm.health.mass_weight_total",
                "cumulative armed weight by round outcome",
            )
            self._sketch_ctr = registry.counter(
                "swarm.health.sketches_total", "post-round parameter sketches"
            )
            self._flag_ctr = registry.counter(
                "swarm.health.quality_flags_total",
                "peers newly flagged by the contribution-quality score",
            )
            self._codec_gauge = registry.gauge(
                "swarm.health.codec_rel_err",
                "relative compression error by wire format",
            )
        else:
            self._mass_gauge = self._mass_ctr = None
            self._sketch_ctr = self._flag_ctr = self._codec_gauge = None

    def configure(self, namespace: str = "") -> None:
        """Adopt the swarm-constant sketch seed for this averaging
        namespace (every peer in a namespace projects identically)."""
        self.seed = sketch_seed(namespace)

    def _event(self, kind: str, **fields: Any) -> None:
        if self.recorder is not None:
            try:
                self.recorder.record(kind, **fields)
            except Exception:  # noqa: BLE001 — recording must not affect the caller
                pass

    # -- contribution quality ------------------------------------------------

    def observe_round_quality(
        self, d2_by_peer: Dict[str, float], *, trace: Optional[str] = None
    ) -> None:
        """One aggregated round's per-peer squared distances to the robust
        aggregate. Outlier votes are RELATIVE (vs the floored median row),
        so honest heterogeneity — every row somewhat off-center — votes
        nobody, while a scaled/garbage contributor votes itself every
        round."""
        if not self.enabled or len(d2_by_peer) < 3:
            return
        try:
            vals = np.array(list(d2_by_peer.values()), np.float64)
            med = float(np.median(vals))
            # Floor against degenerate all-(near-)equal rounds: med 0 must
            # not flag every row with any numeric noise.
            base = max(med, 0.01 * float(vals.mean()), 0.0)
            thr = max((self.OUTLIER_FACTOR ** 2) * base, self.D2_FLOOR)
            changed = False
            with self._lock:
                self.rounds_observed += 1
                for peer, d2 in d2_by_peer.items():
                    st = self._quality.get(peer)
                    if st is None:
                        if len(self._quality) >= self.MAX_PEERS:
                            continue
                        st = self._quality[peer] = {
                            "rounds": 0, "outlier_rounds": 0, "rate": 0.0,
                            "flagged": False,
                        }
                    outlier = bool(thr > 0 and float(d2) > thr)
                    st["rounds"] += 1
                    st["outlier_rounds"] += int(outlier)
                    a = self.QUALITY_ALPHA
                    st["rate"] = (1 - a) * st["rate"] + a * float(outlier)
                    if (
                        not st["flagged"]
                        and st["rounds"] >= self.FLAG_MIN_ROUNDS
                        and st["rate"] >= self.FLAG_RATE
                    ):
                        st["flagged"] = True
                        self._flagged.add(peer)
                        changed = True
                        if self._flag_ctr is not None:
                            self._flag_ctr.inc()
                        self._event(
                            "peer_quality_flagged",
                            peer=peer,
                            score=round(1.0 - st["rate"], 4),
                            flag_rate=round(st["rate"], 4),
                            rounds=st["rounds"],
                            trace=trace,
                        )
                    elif st["flagged"] and st["rate"] <= self.UNFLAG_RATE:
                        st["flagged"] = False
                        self._flagged.discard(peer)
                        changed = True
                flagged = sorted(self._flagged)
            if changed and self.on_flag is not None:
                try:
                    self.on_flag(flagged)
                except Exception as e:  # noqa: BLE001 — surfacing is advisory
                    log.debug("health flag hook failed: %s", errstr(e))
        except Exception as e:  # noqa: BLE001 — health must never fail a round
            log.debug("quality observation failed: %s", errstr(e))

    def quality_score(self, peer: str) -> float:
        """1.0 = never voted an outlier; 0.0 = outlier every recent round."""
        with self._lock:
            st = self._quality.get(peer)
            return 1.0 if st is None else round(1.0 - st["rate"], 4)

    def flagged_peers(self) -> List[str]:
        with self._lock:
            return sorted(self._flagged)

    # -- gradient-mass accounting -------------------------------------------

    def note_round_mass(self, report: dict, *, trace: Optional[str] = None) -> None:
        """One committed round's balanced mass report (see module doc)."""
        if not self.enabled or not report:
            return
        try:
            lost_w = float(report.get("excluded_weight", 0.0)) + float(
                report.get("aborted_weight", 0.0)
            )
            lost_slots = int(report.get("excluded_slots", 0)) + int(
                report.get("aborted_slots", 0)
            )
            with self._lock:
                self.mass_rounds += 1
                self._last_mass = {
                    k: report[k] for k in report if k != "per_peer"
                }
                # Per-shard rollup (zone-sharded training): only when some
                # slot carries a shard tag — unsharded rounds add nothing.
                if any(
                    "shard" in (rec or {})
                    for rec in (report.get("per_peer") or {}).values()
                ):
                    self._last_mass["by_shard"] = {
                        tag: {
                            "armed_weight": sub["armed_weight"],
                            "mass_committed_frac": sub["mass_committed_frac"],
                        }
                        for tag, sub in mass_by_shard(report).items()
                    }
                for pid, rec in (report.get("per_peer") or {}).items():
                    if rec.get("outcome") in ("excluded", "aborted"):
                        if pid not in self._lost_mass and len(
                            self._lost_mass
                        ) >= self.MAX_PEERS:
                            continue
                        self._lost_mass[pid] = self._lost_mass.get(pid, 0.0) + float(
                            rec.get("weight") or 0.0
                        )
            if self._mass_gauge is not None:
                self._mass_gauge.set(float(report.get("mass_committed_frac", 1.0)))
                for oc in ("included", "recovered", "excluded", "aborted"):
                    w = float(report.get(f"{oc}_weight", 0.0))
                    if w:
                        self._mass_ctr.inc(w, outcome=oc)
            rec_slots = int(report.get("recovered_slots", 0))
            if rec_slots:
                # The hedger's auditable win: mass that would have been
                # lost at the deadline, committed anyway. The doctor's
                # straggler rule demotes itself on this evidence.
                self._event(
                    "mass_recovered_by_hedge",
                    trace=trace,
                    recovered_weight=report.get("recovered_weight"),
                    recovered_slots=rec_slots,
                    recovered=sorted(
                        p for p, r in (report.get("per_peer") or {}).items()
                        if r.get("outcome") == "recovered"
                    ),
                    mass_committed_frac=report.get("mass_committed_frac"),
                )
            if lost_slots:
                self._event(
                    "mass_lost_at_deadline",
                    trace=trace,
                    lost_weight=round(lost_w, 6),
                    lost_slots=lost_slots,
                    mass_committed_frac=report.get("mass_committed_frac"),
                    slot_committed_frac=report.get("slot_committed_frac"),
                    recovered_weight=report.get("recovered_weight", 0.0),
                    recovered_slots=report.get("recovered_slots", 0),
                    excluded=sorted(
                        p for p, r in (report.get("per_peer") or {}).items()
                        if r.get("outcome") == "excluded"
                    ),
                    aborted=sorted(
                        p for p, r in (report.get("per_peer") or {}).items()
                        if r.get("outcome") == "aborted"
                    ),
                )
        except Exception as e:  # noqa: BLE001
            log.debug("mass accounting failed: %s", errstr(e))

    # -- mixing-error sketch -------------------------------------------------

    def note_sketch(self, buf: np.ndarray, *, trace: Optional[str] = None) -> None:
        """Sketch the post-round parameters (the committed aggregate this
        peer adopted). Called off the event loop — the projection is a
        few small matmuls against cached blocks (~ms)."""
        if not self.enabled:
            return
        try:
            sk = params_sketch(buf, self.seed, self.sketch_dim, self.sketch_sample)
            rec = {
                "trace": trace,
                "t": round(self.clock(), 6),
                "dim": self.sketch_dim,
                "seed": self.seed,
                "v": [round(float(x), 6) for x in sk],
            }
            with self._lock:
                self._sketches.append(rec)
                self.sketches_computed += 1
            if self._sketch_ctr is not None:
                self._sketch_ctr.inc()
        except Exception as e:  # noqa: BLE001
            log.debug("sketch failed: %s", errstr(e))

    def last_sketch(self) -> Optional[dict]:
        with self._lock:
            return dict(self._sketches[-1]) if self._sketches else None

    def sketch_history(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._sketches]

    # -- codec distortion ----------------------------------------------------

    def note_codec_error(self, wire: str, rel_err: float) -> None:
        """Per-round relative compression error for ``wire`` (EF residual
        norm / gradient norm on the lossy wires)."""
        if not self.enabled:
            return
        try:
            rel = float(rel_err)
            with self._lock:
                rec = self._codec.get(wire)
                if rec is None:
                    rec = self._codec[wire] = {"last": rel, "ewma": rel, "rounds": 0}
                a = 0.2
                rec["last"] = rel
                rec["ewma"] = (1 - a) * rec["ewma"] + a * rel
                rec["rounds"] += 1
            if self._codec_gauge is not None:
                self._codec_gauge.set(rel, wire=wire)
        except Exception as e:  # noqa: BLE001
            log.debug("codec error gauge failed: %s", errstr(e))

    # -- report summary ------------------------------------------------------

    MAX_REPORTED_PEERS = 16

    def summary(self) -> Optional[dict]:
        """Compact health summary for the volunteer report (rides the
        batched ``cp.exchange`` beat). None when disabled — the heartbeat
        then carries no sketch bytes at all (the --no-health-probe test's
        contract)."""
        if not self.enabled:
            return None
        with self._lock:
            # Worst-quality peers first; bounded so the beat stays small.
            worst = sorted(
                self._quality.items(), key=lambda kv: -kv[1]["rate"]
            )[: self.MAX_REPORTED_PEERS]
            lost_top = dict(
                sorted(self._lost_mass.items(), key=lambda kv: -kv[1])[
                    : self.MAX_REPORTED_PEERS
                ]
            )
            return {
                "schema_version": HEALTH_SCHEMA_VERSION,
                "zone": str(self.zone_fn() if self.zone_fn is not None else ""),
                "rounds_observed": self.rounds_observed,
                "mass": {
                    "last": dict(self._last_mass) if self._last_mass else None,
                    "lost_by_peer": {
                        p: round(w, 6) for p, w in lost_top.items()
                    },
                },
                "quality": {
                    p: {
                        "score": round(1.0 - st["rate"], 4),
                        "rounds": st["rounds"],
                        "flagged": st["flagged"],
                    }
                    for p, st in worst
                },
                "flagged": sorted(self._flagged),
                "codec": {
                    w: {
                        "rel_err_last": round(rec["last"], 8),
                        "rel_err_ewma": round(rec["ewma"], 8),
                    }
                    for w, rec in self._codec.items()
                },
                "sketch": dict(self._sketches[-1]) if self._sketches else None,
            }

    def scrape(self) -> Optional[dict]:
        """The debug/collection view (rides ``telemetry.scrape``): the
        summary plus the bounded sketch HISTORY, which is what lets
        trace_report compute a per-round mixing-error column by matching
        sketches across peers by trace id."""
        out = self.summary()
        if out is None:
            return None
        out["sketch_history"] = self.sketch_history()
        return out


# -- coord.status["health"] rollup -------------------------------------------

# The documented coord.status["health"] schema — walked by the test lane
# like STATUS_TELEMETRY_SCHEMA, so drift breaks CI instead of dashboards.
STATUS_HEALTH_SCHEMA: Dict[str, type] = {
    "schema_version": int,
    "age_s": float,          # staleness stamp (serve-time, freshest report)
    "reporting": int,        # volunteers whose fresh report carried health
    "mixing": dict,          # global + per-zone sketch dispersion (below)
    "mass": dict,            # committed-frac stats + cumulative lost weight
    "quality": dict,         # peer -> merged {score, rounds, flagged, reporters}
    "flagged_peers": list,   # union of reporters' flag sets
    "codec": dict,           # wire -> mean relative error across reporters
}


def rollup_status(fresh_reports: List[dict]) -> Optional[dict]:
    """Merge per-volunteer health summaries (from fresh reports) into the
    versioned ``coord.status["health"]`` rollup. None until some
    volunteer reports health — the telemetry rollup's contract.

    Mixing: sketches are grouped by (dim, seed) — only same-space
    sketches compare — then dispersed globally, per zone, and ACROSS
    zone means (the cross-zone mixing signal the hierarchy's
    ``cross_zone_every_k`` exists to converge)."""
    per_peer: Dict[str, dict] = {}
    for m in fresh_reports:
        h = m.get("health")
        if isinstance(h, dict) and h.get("schema_version") == HEALTH_SCHEMA_VERSION:
            per_peer[str(m.get("peer", "?"))] = h
    if not per_peer:
        return None
    # -- mixing ------------------------------------------------------------
    sketches: List[Tuple[str, str, dict]] = []  # (peer, zone, sketch rec)
    for pid, h in per_peer.items():
        sk = h.get("sketch")
        if isinstance(sk, dict) and sk.get("v"):
            sketches.append((pid, str(h.get("zone") or ""), sk))
    by_space: Dict[Tuple[int, int], list] = {}
    for pid, zone, sk in sketches:
        by_space.setdefault(
            (int(sk.get("dim") or 0), int(sk.get("seed") or 0)), []
        ).append((pid, zone, np.asarray(sk["v"], np.float64)))
    mixing: Dict[str, Any] = {
        "n_sketches": 0, "dispersion": None, "per_zone": {}, "across_zones": None,
    }
    if by_space:
        _, group = max(by_space.items(), key=lambda kv: len(kv[1]))
        mixing["n_sketches"] = len(group)
        mixing["dispersion"] = sketch_dispersion([v for _, _, v in group])
        zones: Dict[str, list] = {}
        for _, zone, v in group:
            zones.setdefault(zone, []).append(v)
        mixing["per_zone"] = {
            z: sketch_dispersion(vs) for z, vs in zones.items()
        }
        if len(zones) >= 2:
            mixing["across_zones"] = sketch_dispersion(
                [np.stack(vs).mean(axis=0) for vs in zones.values()]
            )
    # -- mass --------------------------------------------------------------
    fracs = []
    lost_total = 0.0
    recovered_total = 0.0
    for h in per_peer.values():
        last = (h.get("mass") or {}).get("last")
        if isinstance(last, dict):
            f = last.get("mass_committed_frac")
            if isinstance(f, (int, float)):
                fracs.append(float(f))
            recovered_total += float(last.get("recovered_weight") or 0.0)
        for w in ((h.get("mass") or {}).get("lost_by_peer") or {}).values():
            lost_total += float(w or 0.0)
    mass = {
        "reporting": len(fracs),
        "committed_frac_mean": round(sum(fracs) / len(fracs), 6) if fracs else None,
        "committed_frac_min": round(min(fracs), 6) if fracs else None,
        "lost_weight_total": round(lost_total, 6),
        # Mass the hedged-recovery pipeline saved in the reporters' latest
        # rounds: lost vs recovered side by side is the tail-optimal
        # pipeline's live scorecard.
        "recovered_weight_last": round(recovered_total, 6),
    }
    # -- quality -----------------------------------------------------------
    quality: Dict[str, dict] = {}
    flagged: set = set()
    for h in per_peer.values():
        flagged.update(h.get("flagged") or [])
        for pid, q in (h.get("quality") or {}).items():
            cur = quality.setdefault(
                str(pid),
                {"score": 1.0, "rounds": 0, "flagged": False, "reporters": 0},
            )
            cur["score"] = round(min(cur["score"], float(q.get("score", 1.0))), 4)
            cur["rounds"] += int(q.get("rounds") or 0)
            cur["flagged"] = cur["flagged"] or bool(q.get("flagged"))
            cur["reporters"] += 1
    # -- codec -------------------------------------------------------------
    codec_acc: Dict[str, list] = {}
    for h in per_peer.values():
        for wire, rec in (h.get("codec") or {}).items():
            v = rec.get("rel_err_ewma")
            if isinstance(v, (int, float)):
                codec_acc.setdefault(str(wire), []).append(float(v))
    return {
        "schema_version": HEALTH_SCHEMA_VERSION,
        "reporting": len(per_peer),
        "mixing": mixing,
        "mass": mass,
        "quality": quality,
        "flagged_peers": sorted(flagged),
        "codec": {
            w: round(sum(vs) / len(vs), 8) for w, vs in codec_acc.items()
        },
    }
