"""Closed-loop adaptive controller: the swarm retunes itself, live.

PRs 10-13 built the sensor suite Chameleon-style real-time policy
selection needs — per-round critical paths, per-level wall/failure
history, bandwidth EWMAs, codec-distortion telemetry, mixing-error
dispersion, the flight recorder — but every policy knob stayed hand-set.
This module closes the loop: one :class:`SwarmController` per volunteer
reads that telemetry and selects, per epoch, per hierarchy level:

- **regime** (the shared model): a per-level verdict in
  ``calm | churn | degraded`` from the level's round failure-rate EWMA,
  hysteresis-banded. Topology, hedge, and wire decisions all read THIS
  state instead of running three independent AIMD loops that fight each
  other (ROADMAP item 2's follow-on, folded in).
- **averaging topology**: a ladder ``sync-group -> butterfly -> gossip``
  over the rotating group schedule's geometry — one max-size gather
  group (best mixing per round, worst churn exposure), the configured
  Moshpit grid, or pairwise groups of two (maximum churn containment).
  Falling regime walks down the ladder; a recovered failure EWMA climbs
  back to the calm preference.
- **wire format**: dense f32 vs bf16 selected from measured
  convergence-per-byte — the PR-11 codec-distortion telemetry joined
  against the transport's bandwidth EWMAs and the current round budget.
  The compressed wires (q8 / topk / powersgd / sign) are RANKED in the
  same table and exported in the summary, but only the dense pair is
  switched live: they share tile geometry, so a flip re-keys the schema
  hash and nothing else (a disagreeing peer's push is rejected by
  schema, never mis-decoded — the documented mixed-wire degradation).
- **hierarchy cadence**: a learned ``k`` per zone pair replacing the
  static ``cross_zone_every_k`` — tightened (smaller k, more cross
  mixing) while the cross-round dispersion trend stalls above its
  floor (``mixing_stall`` risk), relaxed (larger k) once dispersion
  converges or the pair's bandwidth floor collapses (cross rounds that
  mostly fail spend committed-round rate for nothing). The schedule
  runs ONE k, so the applied value is the tightest (smallest) pair k —
  the neediest pair binds, and the per-pair state is what coord.status
  shows (the per-level cadence VECTOR is ROADMAP item 4e).
- **per-level round deadlines**: owned by the resilience policy's
  per-level AIMD split (``ResiliencePolicy.round_budget(level)``); the
  controller reports them and stamps its regime into the policy's hedge
  budget (``ResiliencePolicy.set_regime``).

Decision discipline (the whole point — no flapping, no mid-round mixes):

- every decision comes from a DETERMINISTIC policy table over
  hysteresis-guarded evidence gates (watchdog-style fire/clear bands
  with consecutive-breach counts) plus a per-knob dwell: a knob that
  just moved cannot move again for ``dwell_rounds`` rounds;
- every transition is **epoch-fenced like leadership**: staged when
  decided, applied only by :meth:`advance` — which the averager calls
  BEFORE forming the next round — so a mid-round regime shift can never
  mix two configurations into one round;
- every applied transition lands in the flight recorder as a
  ``policy_changed`` event carrying the knob, old/new value, reason, and
  the evidence snapshot it rode on, and annotates any in-window
  ``round_wall_inflation`` / ``commit_rate_collapse`` alert (an
  intentional retune must not page as an anomaly).

Everything follows the telemetry plane's contract: advisory and bounded.
The controller must never fail a round — observe/decide paths swallow
their own exceptions — and a disabled controller (``--no-adapt``) is
simply never constructed: no controller bytes ride the report beat.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)

# Version stamp carried by every controller summary and the coord.status
# rollup (independent of the telemetry/health/watchdog versions; pinned
# by tests/test_controller.py).
CONTROLLER_SCHEMA_VERSION = 1

# The topology ladder, calm-most first. Falling regime moves RIGHT
# (smaller, churn-tolerant groups); recovery climbs back LEFT toward the
# preference. The names map onto the rotating schedule's geometry:
# sync-group = one max_group-sized gather group, butterfly = the
# configured Moshpit grid, gossip = pairwise groups of two.
TOPOLOGY_LADDER = ("sync-group", "butterfly", "gossip")

REGIMES = ("calm", "churn", "degraded")

# Static wire cost table (bytes per element shipped) for the
# convergence-per-byte ranking. topk/powersgd costs depend on frac/rank;
# the entries here are the stock-config estimates, labeled as such in
# the ranking output.
WIRE_BYTES_PER_ELEM: Dict[str, float] = {
    "f32": 4.0,
    "bf16": 2.0,
    "q8": 1.0,
    "topk": 0.08,      # ~frac 0.01 of (index+value) pairs
    "powersgd": 0.25,  # rank-4 over typical layer shapes
    "sign": 0.125,
}


class EvidenceGate:
    """Watchdog-style fire/clear hysteresis over one scalar evidence
    series, applied to DECISIONS: ``observe`` returns the gate's firing
    state after folding the value in. Fires after ``min_breaches``
    consecutive observations past ``fire``; clears after
    ``clear_breaches`` consecutive observations inside ``clear``. A
    value between the bands changes nothing — the no-flap property the
    ISSUE-15 hysteresis test pins."""

    __slots__ = (
        "fire", "clear", "low", "min_breaches", "clear_breaches",
        "_breach", "_inband", "firing",
    )

    def __init__(
        self,
        fire: float,
        clear: float,
        *,
        low: bool = False,
        min_breaches: int = 2,
        clear_breaches: int = 2,
    ):
        # "low" gates fire when the value drops BELOW fire (bandwidth
        # collapse); default gates fire above it (failure rate).
        if low:
            assert clear > fire, "low gate needs clear above fire"
        else:
            assert clear < fire, "high gate needs clear below fire"
        self.fire = float(fire)
        self.clear = float(clear)
        self.low = bool(low)
        self.min_breaches = int(min_breaches)
        self.clear_breaches = int(clear_breaches)
        self._breach = 0
        self._inband = 0
        self.firing = False

    def observe(self, value: float) -> bool:
        v = float(value)
        bad = v < self.fire if self.low else v > self.fire
        ok = v > self.clear if self.low else v < self.clear
        if not self.firing:
            if bad:
                self._breach += 1
                if self._breach >= self.min_breaches:
                    self.firing = True
                    self._inband = 0
            else:
                self._breach = 0
        else:
            if ok:
                self._inband += 1
                if self._inband >= self.clear_breaches:
                    self.firing = False
                    self._breach = 0
            else:
                self._inband = 0
        return self.firing


class SwarmController:
    """One closed-loop controller per volunteer (see module doc).

    Wiring: the volunteer constructs it next to the resilience policy
    and passes it into the averager, which feeds evidence
    (:meth:`observe_round`, :meth:`observe_dispersion`,
    :meth:`observe_cross_pair`) after each round and calls
    :meth:`advance` before forming the next one. Decisions are purely
    local and advisory: a knob that changes schedule geometry or wire
    degrades exactly like every other view divergence in this codebase —
    an underfilled rendezvous or a schema-rejected push, never mixed
    tensors."""

    # Failure-rate EWMA bands per regime step (fraction of rounds that
    # failed or degraded). calm->churn at 0.35/0.15, churn->degraded at
    # 0.7/0.45 — wide enough apart that EWMA noise inside a band moves
    # nothing.
    CHURN_FIRE, CHURN_CLEAR = 0.35, 0.15
    DEGRADED_FIRE, DEGRADED_CLEAR = 0.7, 0.45
    FAIL_ALPHA = 0.3
    # Wire gate: estimated push transfer time as a fraction of the round
    # budget. Above WIRE_FIRE_FRAC the link is budget-bound (halve the
    # bytes); below WIRE_CLEAR_FRAC at f32 cost it is comfortably idle
    # (full precision is free again).
    WIRE_FIRE_FRAC, WIRE_CLEAR_FRAC = 0.5, 0.15
    # bf16 is only eligible while its measured relative distortion stays
    # under this bound (sampled by the health layer's codec gauge).
    WIRE_DISTORTION_BOUND = 2e-2
    # Cadence: per-pair k bounds as multiples of the configured base k,
    # and the dispersion-trend window (cross rounds) the trend verdict
    # needs. Convergence floor matches the watchdog's StallDetector.
    CADENCE_MAX_STRETCH = 8
    DISPERSION_WINDOW = 4
    DISPERSION_FLOOR = 0.05
    DISPERSION_IMPROVE_TOL = 0.1
    # Per-pair bandwidth floor (bytes/s) under which cross rounds to the
    # pair are judged not worth their cadence (thin/partitioned WAN).
    PAIR_BW_FLOOR = 64 * 1024
    PAIR_BW_CLEAR = 256 * 1024
    # A knob that just moved cannot move again for this many rounds.
    DWELL_ROUNDS = 4
    # Transition history window for transitions/hour + alert annotation.
    MAX_TRANSITIONS = 64
    ANNOTATE_WINDOW_S = 60.0

    def __init__(
        self,
        *,
        policy=None,
        telemetry=None,
        topology_preference: str = "butterfly",
        clock: Callable[[], float] = time.time,
    ):
        if topology_preference not in TOPOLOGY_LADDER:
            raise ValueError(
                f"unknown topology preference {topology_preference!r}; "
                f"known: {TOPOLOGY_LADDER}"
            )
        self.policy = policy
        self.telemetry = telemetry
        self.clock = clock
        self.enabled = True
        self.topology_preference = topology_preference
        self._pref_idx = TOPOLOGY_LADDER.index(topology_preference)
        # Round sequence (one per average() call on the owning averager):
        # the epoch fence every staged decision is keyed to.
        self._seq = 0
        # Per-level regime state: failure EWMA + the two hysteresis gates.
        self._levels: Dict[str, dict] = {}
        # Wire state (None until attach() learns the configured wire).
        self.wire: Optional[str] = None
        self._wire_configured: Optional[str] = None
        self._wire_gate = EvidenceGate(self.WIRE_FIRE_FRAC, self.WIRE_CLEAR_FRAC)
        # Cadence state: base k + per-zone-pair learned k and evidence.
        self._base_k = 0
        self.applied_k = 0
        self._pairs: Dict[str, dict] = {}
        # Cross-round dispersion trend (relative contribution dispersion
        # observed by round leaders; the local form of the health
        # rollup's across-zone sketch dispersion).
        self._disp: "deque[float]" = deque(maxlen=2 * self.DISPERSION_WINDOW)
        # Topology state.
        self.topology = topology_preference
        # Staged (decided, not yet applied) transitions: the epoch fence.
        self._pending: List[dict] = []
        # Applied-transition history (bounded) + totals.
        self._transitions: "deque[dict]" = deque(maxlen=self.MAX_TRANSITIONS)
        self.transitions_total = 0
        self._knob_last_move: Dict[Tuple[str, str], int] = {}
        self._t0 = clock()
        self._watchdog_wired = False

    # -- attachment ---------------------------------------------------------

    def attach(
        self,
        *,
        wire: str,
        schedule=None,
        max_group: int = 16,
    ) -> None:
        """Adopt the averager's static configuration: the configured wire
        (the calm point the wire knob clears back to), and the schedule's
        geometry the topology/cadence knobs operate on. Called once by
        the averager's constructor; idempotent."""
        if self._wire_configured is None:
            self._wire_configured = wire
            self.wire = wire
        if schedule is not None and not hasattr(self, "_sched_target"):
            self._base_k = int(schedule.cross_zone_every_k)
            self.applied_k = self._base_k
            self._sched_target = int(schedule.target_size)
            self._max_group = int(max_group)
        if self.telemetry is not None and not self._watchdog_wired:
            self._watchdog_wired = True
            wd = getattr(self.telemetry, "watchdog", None)
            if wd is not None and getattr(wd, "enabled", False):
                wd.add_probe(self._annotate_probe)

    # -- evidence -----------------------------------------------------------

    def _level(self, level: Optional[str]) -> dict:
        lv = level or "flat"
        rec = self._levels.get(lv)
        if rec is None:
            rec = self._levels[lv] = {
                "fail_ewma": 0.0,
                "rounds": 0,
                "churn": EvidenceGate(self.CHURN_FIRE, self.CHURN_CLEAR),
                "degraded": EvidenceGate(self.DEGRADED_FIRE, self.DEGRADED_CLEAR),
                "regime": "calm",
            }
        return rec

    def regime(self, level: Optional[str] = None) -> str:
        return self._level(level)["regime"]

    def observe_round(
        self,
        *,
        level: Optional[str] = None,
        ok: bool,
        degraded: bool = False,
        duration_s: float = 0.0,
        push_bytes: Optional[int] = None,
        bw_floor: Optional[float] = None,
        budget_s: Optional[float] = None,
    ) -> None:
        """One finished round's evidence from the owning averager: the
        outcome feeds the level's regime model, and (when known) the push
        size + slowest group link feed the wire gate. Runs the decision
        table — transitions STAGE here and apply at the next advance()."""
        if not self.enabled:
            return
        try:
            rec = self._level(level)
            rec["rounds"] += 1
            bad = 1.0 if (not ok or degraded) else 0.0
            rec["fail_ewma"] += self.FAIL_ALPHA * (bad - rec["fail_ewma"])
            churn = rec["churn"].observe(rec["fail_ewma"])
            degr = rec["degraded"].observe(rec["fail_ewma"])
            new_regime = "degraded" if degr else ("churn" if churn else "calm")
            if new_regime != rec["regime"]:
                self._stage(
                    "regime", level or "flat", rec["regime"], new_regime,
                    reason=(
                        "failure-rate EWMA %.2f crossed the %s band"
                        % (rec["fail_ewma"],
                           "fire" if new_regime != "calm" else "clear")
                    ),
                    evidence={
                        "fail_ewma": round(rec["fail_ewma"], 4),
                        "rounds": rec["rounds"],
                    },
                )
            if push_bytes and bw_floor and budget_s:
                self._decide_wire(push_bytes, bw_floor, budget_s)
            self._decide_topology()
        except Exception as e:  # noqa: BLE001 — the controller must never fail a round
            log.debug("controller observe_round failed: %s", errstr(e))

    def observe_shard_health(
        self, level: Optional[str] = None, *, ok: bool,
    ) -> None:
        """Shard-domain health (zone-sharded training, swarm/sharding.py)
        as a regime input: a shard manager reporting degraded/recovering
        feeds the SAME failure EWMA + evidence gates a failed round does
        — for the level the loss actually sits on ("intra": the zone's
        gather/scatter plane) — so a degraded shard zone widens that
        level's deadlines and floors its hedge budget through the
        existing regime→policy folding, with no new knob. A healthy beat
        feeds 0 and walks the gates back toward calm, exactly like a
        committed round."""
        if not self.enabled:
            return
        try:
            rec = self._level(level)
            bad = 0.0 if ok else 1.0
            rec["fail_ewma"] += self.FAIL_ALPHA * (bad - rec["fail_ewma"])
            churn = rec["churn"].observe(rec["fail_ewma"])
            degr = rec["degraded"].observe(rec["fail_ewma"])
            new_regime = "degraded" if degr else ("churn" if churn else "calm")
            if new_regime != rec["regime"]:
                self._stage(
                    "regime", level or "flat", rec["regime"], new_regime,
                    reason=(
                        "shard-domain health fed failure EWMA %.2f across "
                        "the %s band"
                        % (rec["fail_ewma"],
                           "fire" if new_regime != "calm" else "clear")
                    ),
                    evidence={
                        "fail_ewma": round(rec["fail_ewma"], 4),
                        "source": "shard_health",
                    },
                )
        except Exception as e:  # noqa: BLE001 — the controller must never fail a beat
            log.debug("controller observe_shard_health failed: %s", errstr(e))

    def observe_dispersion(self, level: Optional[str], rel: float) -> None:
        """One cross-round relative contribution dispersion (the leader's
        per-peer distance evidence, sqrt(mean d2)/|agg|): the local
        mixing-error trend the cadence knob tightens/relaxes on. Only
        cross-level observations feed the trend."""
        if not self.enabled or (level or "flat") != "cross":
            return
        try:
            self._disp.append(float(rel))
            self._decide_cadence()
        except Exception as e:  # noqa: BLE001
            log.debug("controller observe_dispersion failed: %s", errstr(e))

    def observe_cross_pair(
        self, pair: str, *, bw_floor: Optional[float] = None,
        ok: bool = True, degraded: bool = False,
    ) -> None:
        """Per-zone-pair evidence from a cross round this node saw: the
        pair's slowest observed link and the round outcome. ``pair`` is
        the sorted "zoneA|zoneB" key."""
        if not self.enabled:
            return
        try:
            rec = self._pairs.get(pair)
            if rec is None:
                if len(self._pairs) >= 32:
                    return
                base = max(self._base_k, 1)
                rec = self._pairs[pair] = {
                    "k": base,
                    "rounds": 0,
                    "fail_ewma": 0.0,
                    "bw_floor": None,
                    "thin": EvidenceGate(
                        self.PAIR_BW_FLOOR, self.PAIR_BW_CLEAR, low=True
                    ),
                }
            rec["rounds"] += 1
            bad = 1.0 if (not ok or degraded) else 0.0
            rec["fail_ewma"] += self.FAIL_ALPHA * (bad - rec["fail_ewma"])
            if bw_floor is not None:
                rec["bw_floor"] = float(bw_floor)
                rec["thin"].observe(float(bw_floor))
            self._decide_cadence()
        except Exception as e:  # noqa: BLE001
            log.debug("controller observe_cross_pair failed: %s", errstr(e))

    # -- the policy table ---------------------------------------------------

    def _dwell_ok(self, knob: str, key: str) -> bool:
        last = self._knob_last_move.get((knob, key))
        return last is None or self._seq - last >= self.DWELL_ROUNDS

    def _staged_value(self, knob: str, key: str):
        for p in reversed(self._pending):
            if p["knob"] == knob and p["key"] == key:
                return p["to"]
        return None

    def _stage(
        self, knob: str, key: str, frm, to, *, reason: str, evidence: dict,
    ) -> None:
        """Stage one transition behind the epoch fence (applies from the
        NEXT round — advance() promotes it). Dwell- and dedup-guarded:
        a knob mid-dwell, or one already staged to this value, stays
        put."""
        if to == frm or self._staged_value(knob, key) == to:
            return
        if not self._dwell_ok(knob, key):
            return
        self._pending.append({
            "knob": knob, "key": key, "from": frm, "to": to,
            "reason": reason, "evidence": evidence,
            "staged_t": round(self.clock(), 3),
            "fence": self._seq + 1,
        })
        # Dwell counts from the STAGE: a gate that keeps firing while the
        # fence is pending must not pile up duplicate transitions.
        self._knob_last_move[(knob, key)] = self._seq

    def _decide_topology(self) -> None:
        """Ladder walk from the worst live regime across levels: calm ->
        the preference, churn -> one step down, degraded -> gossip."""
        if not hasattr(self, "_sched_target"):
            return  # no schedule attached: geometry is not ours to move
        worst = max(
            (REGIMES.index(rec["regime"]) for rec in self._levels.values()),
            default=0,
        )
        idx = min(max(self._pref_idx + worst, worst), len(TOPOLOGY_LADDER) - 1)
        target = TOPOLOGY_LADDER[idx]
        self._stage(
            "topology", "", self.topology, target,
            reason=f"worst level regime is {REGIMES[worst]}",
            evidence={
                lv: round(rec["fail_ewma"], 4)
                for lv, rec in self._levels.items()
            },
        )

    def _decide_wire(
        self, push_bytes: int, bw_floor: float, budget_s: float
    ) -> None:
        """Dense-pair wire selection on the transfer-time share of the
        round budget, distortion-bounded (see module doc)."""
        if self._wire_configured not in ("f32", "bf16"):
            return  # compressed wires are recommendation-only
        # Evaluate the gate at f32 cost, so firing means "f32 does not
        # fit" and clearing means "f32 fits comfortably" — one series,
        # no discontinuity at the flip itself.
        f32_bytes = push_bytes * (2 if self.wire == "bf16" else 1)
        share = (f32_bytes / max(bw_floor, 1.0)) / max(budget_s, 1e-6)
        fired = self._wire_gate.observe(share)
        distortion = self._wire_distortion("bf16")
        evidence = {
            "f32_transfer_share": round(share, 4),
            "bw_floor_bps": round(bw_floor, 1),
            "push_bytes": int(push_bytes),
            "budget_s": round(budget_s, 3),
            "bf16_rel_err": distortion,
        }
        if (
            fired
            and self.wire == "f32"
            and distortion is not None
            and distortion < self.WIRE_DISTORTION_BOUND
        ):
            self._stage(
                "wire", "", "f32", "bf16",
                reason="push transfer share over budget; bf16 distortion "
                       "within bound (convergence-per-byte favors bf16)",
                evidence=evidence,
            )
        elif not fired and self.wire == "bf16" and self._wire_configured == "f32":
            self._stage(
                "wire", "", "bf16", "f32",
                reason="bandwidth recovered; full precision fits the budget",
                evidence=evidence,
            )

    def _wire_distortion(self, wire: str) -> Optional[float]:
        """Measured relative codec error for ``wire`` from the health
        layer's codec gauge (EWMA), or None before any sample."""
        h = getattr(self.telemetry, "health", None)
        if h is None or not getattr(h, "enabled", False):
            return None
        rec = getattr(h, "_codec", {}).get(wire)
        return round(float(rec["ewma"]), 8) if rec else None

    def _decide_cadence(self) -> None:
        """Per-pair k from the dispersion trend + the pair's bandwidth
        gate; the applied (schedule) k is the tightest pair's."""
        if self._base_k <= 0 or not self._pairs:
            return
        trend = self._dispersion_trend()
        for pair, rec in self._pairs.items():
            k = rec["k"]
            if rec["thin"].firing:
                # Thin/partitioned WAN: cross rounds to this pair mostly
                # burn budget — relax toward the stretch cap.
                target = min(k * 2, self._base_k * self.CADENCE_MAX_STRETCH)
                reason = "pair bandwidth floor collapsed; relaxing cross cadence"
            elif trend == "stalled":
                target = max(k // 2, 1)
                reason = "cross dispersion stalled above floor; tightening"
            elif trend == "converged":
                target = min(k * 2, self._base_k * self.CADENCE_MAX_STRETCH)
                reason = "cross dispersion converged; relaxing"
            else:
                continue
            self._stage(
                "cadence", pair, k, target,
                reason=reason,
                evidence={
                    "dispersion_trend": trend,
                    "bw_floor_bps": rec["bw_floor"],
                    "pair_fail_ewma": round(rec["fail_ewma"], 4),
                    "dispersion_recent": [round(d, 6) for d in list(self._disp)[-4:]],
                },
            )

    def _dispersion_trend(self) -> Optional[str]:
        """"stalled" | "converged" | None (not enough evidence) over the
        cross-round dispersion window — the StallDetector's
        new-low-vs-previous-window verdict, plus a convergence floor."""
        if len(self._disp) < 2 * self.DISPERSION_WINDOW:
            return None
        vals = list(self._disp)
        prev_min = min(vals[: self.DISPERSION_WINDOW])
        new_min = min(vals[self.DISPERSION_WINDOW:])
        if new_min < self.DISPERSION_FLOOR:
            return "converged"
        if new_min >= (1.0 - self.DISPERSION_IMPROVE_TOL) * prev_min:
            return "stalled"
        return None

    # -- the epoch fence ----------------------------------------------------

    def advance(self) -> List[dict]:
        """Promote staged transitions whose fence has passed and return
        them. The owning averager calls this ONCE per round, BEFORE
        rendezvous/formation — the fencing contract: a decision staged
        during round N applies from round N+1, never to a round already
        in flight."""
        self._seq += 1
        if not self._pending:
            return []
        due = [p for p in self._pending if p["fence"] <= self._seq]
        if not due:
            return []
        self._pending = [p for p in self._pending if p["fence"] > self._seq]
        for p in due:
            self._apply(p)
        return due

    def _apply(self, p: dict) -> None:
        knob, key, to = p["knob"], p["key"], p["to"]
        if knob == "regime":
            self._level(key)["regime"] = to
            if self.policy is not None and hasattr(self.policy, "set_regime"):
                # Fold the hedge budget into the shared regime model.
                self.policy.set_regime(key, to)
        elif knob == "topology":
            self.topology = to
        elif knob == "wire":
            self.wire = to
        elif knob == "cadence":
            rec = self._pairs.get(key)
            if rec is not None:
                rec["k"] = int(to)
            self.applied_k = min(
                (r["k"] for r in self._pairs.values()),
                default=self._base_k,
            )
        p["applied_t"] = round(self.clock(), 3)
        p["seq"] = self._seq
        self._transitions.append(p)
        self.transitions_total += 1
        log.info(
            "controller: %s[%s] %s -> %s (%s)",
            knob, key or "-", p["from"], to, p["reason"],
        )
        if self.telemetry is not None:
            try:
                self.telemetry.event(
                    "policy_changed",
                    knob=knob,
                    key=key,
                    **{"from": p["from"]},
                    to=to,
                    reason=p["reason"],
                    evidence=p["evidence"],
                )
            except Exception:  # noqa: BLE001 — recording is advisory
                pass
        self._annotate_alerts(p)

    # -- knob readouts (what the averager applies) --------------------------

    def target_group_size(self) -> Optional[int]:
        """Schedule target size for the CURRENT topology, or None when no
        schedule geometry was attached."""
        if not hasattr(self, "_sched_target"):
            return None
        if self.topology == "sync-group":
            return self._max_group
        if self.topology == "gossip":
            return 2
        return self._sched_target

    def cross_zone_k(self) -> Optional[int]:
        """The applied cross-zone cadence (the tightest pair k), or None
        when the hierarchy is off."""
        return (self.applied_k or None) if self._base_k else None

    # -- watchdog annotation ------------------------------------------------

    def last_transition(self) -> Optional[dict]:
        return dict(self._transitions[-1]) if self._transitions else None

    def _annotate_alerts(self, p: dict) -> None:
        """Stamp the transition onto any currently-firing wall/commit
        alert (an intentional retune is context, not an anomaly — the
        PR-13 hedge-annotation pattern)."""
        wd = getattr(self.telemetry, "watchdog", None)
        if wd is None or not getattr(wd, "enabled", False):
            return
        note = {
            "policy_changed": f"{p['knob']}[{p['key'] or '-'}] "
                              f"{p['from']}->{p['to']}",
            "policy_reason": p["reason"],
            "policy_t": p.get("applied_t"),
        }
        for kind in ("round_wall_inflation", "commit_rate_collapse"):
            for alert in wd.alerts():
                if alert["kind"] == kind:
                    wd.annotate(kind, alert["key"], **note)

    def _annotate_probe(self, now: float, dt: Optional[float]) -> None:
        """Watchdog tick probe: an alert RAISED shortly after a transition
        (the other ordering _annotate_alerts can't see) still gets the
        in-window policy_changed stamp."""
        last = self.last_transition()
        if last is None:
            return
        t = last.get("applied_t") or 0.0
        if now - t > self.ANNOTATE_WINDOW_S:
            return
        self._annotate_alerts(last)

    # -- status -------------------------------------------------------------

    def transitions_per_hour(self) -> float:
        now = self.clock()
        window = [
            p for p in self._transitions
            if now - (p.get("applied_t") or 0.0) <= 3600.0
        ]
        span = min(3600.0, max(now - self._t0, 60.0))
        return round(len(window) * 3600.0 / span, 2)

    def wire_ranking(self) -> List[dict]:
        """Candidate wires ranked by estimated convergence-per-byte:
        measured relative distortion (health codec gauge; None = never
        sampled) joined against the static bytes/element table. Score =
        (1 - penalized distortion) / bytes_per_elem — the live half of
        ROADMAP item 1's "r5 codec-horizon" ranking; unsampled wires
        rank after every measured one and are labeled unmeasured."""
        out = []
        for wire, bpe in WIRE_BYTES_PER_ELEM.items():
            rel = self._wire_distortion(wire)
            penalty = min((rel or 0.0) * 10.0, 0.95)
            out.append({
                "wire": wire,
                "bytes_per_elem": bpe,
                "rel_err_ewma": rel,
                "measured": rel is not None,
                "score": round((1.0 - penalty) / bpe, 4),
            })
        # Measured wires first: a wire nobody has distortion evidence for
        # must not out-rank one the swarm is actually running.
        out.sort(key=lambda r: (not r["measured"], -r["score"]))
        return out

    def summary(self) -> dict:
        """Compact controller view for the volunteer report (rides the
        batched cp.exchange beat; rolled into coord.status["controller"])."""
        last = self.last_transition()
        if last is not None:
            last = {
                k: last[k]
                for k in ("knob", "key", "from", "to", "reason", "applied_t")
                if k in last
            }
        return {
            "schema_version": CONTROLLER_SCHEMA_VERSION,
            "regime": {
                lv: rec["regime"] for lv, rec in self._levels.items()
            } or {"flat": "calm"},
            "topology": self.topology,
            "wire": self.wire or "",
            "cadence": {
                "base_k": self._base_k,
                "applied_k": self.applied_k,
                "per_pair": {
                    pair: {
                        "k": rec["k"],
                        "bw_floor_bps": rec["bw_floor"],
                        "fail_ewma": round(rec["fail_ewma"], 4),
                    }
                    for pair, rec in self._pairs.items()
                },
            },
            "deadlines": (
                self.policy.deadlines() if self.policy is not None else {}
            ),
            "transitions_total": self.transitions_total,
            "transitions_per_hour": self.transitions_per_hour(),
            "pending": len(self._pending),
            "last_transition": last,
        }

    def scrape(self) -> dict:
        """Debug/collection view: the summary plus the bounded transition
        history and the live wire ranking."""
        out = self.summary()
        out["transitions"] = [dict(p) for p in self._transitions]
        out["wire_ranking"] = self.wire_ranking()
        return out


# -- coord.status["controller"] rollup ----------------------------------------

# The documented coord.status["controller"] schema — walked by
# tests/test_controller.py like the telemetry/health/watchdog ones, so
# drift breaks CI instead of dashboards. `age_s` is the usual serve-time
# staleness stamp.
STATUS_CONTROLLER_SCHEMA: Dict[str, type] = {
    "schema_version": int,
    "age_s": float,          # staleness stamp (serve-time, freshest report)
    "reporting": int,        # volunteers whose fresh report carried controller
    "regime": dict,          # level -> worst reporter regime
    "topology": dict,        # topology -> reporter count
    "wire": dict,            # wire -> reporter count
    "cadence": dict,         # {applied_k_min, per_pair: pair -> k/bw evidence}
    "deadlines": dict,       # level -> max learned deadline across reporters
    "transitions_total": int,
    "transitions_per_hour": float,
    "per_peer": dict,        # peer -> its summary (verbatim)
}


def rollup_status(fresh_reports: List[dict]) -> Optional[dict]:
    """Merge per-volunteer controller summaries (from fresh reports) into
    the versioned ``coord.status["controller"]`` rollup. None until some
    volunteer reports a controller — the telemetry rollup's contract
    (a --no-adapt fleet serves no controller section at all)."""
    per_peer: Dict[str, dict] = {}
    for m in fresh_reports:
        c = m.get("controller")
        if isinstance(c, dict) and c.get("schema_version") == CONTROLLER_SCHEMA_VERSION:
            per_peer[str(m.get("peer", "?"))] = c
    if not per_peer:
        return None
    regime: Dict[str, str] = {}
    topology: Dict[str, int] = {}
    wire: Dict[str, int] = {}
    deadlines: Dict[str, float] = {}
    pair_k: Dict[str, dict] = {}
    applied_ks: List[int] = []
    transitions = 0
    tph = 0.0
    last = None
    for c in per_peer.values():
        for lv, r in (c.get("regime") or {}).items():
            # Unknown regime strings (version skew, a buggy reporter)
            # rank as "calm" instead of raising — one bad report must
            # not fail every coord.status serve (the set_regime rule).
            cur = regime.get(str(lv), "calm")
            rank = REGIMES.index(str(r)) if str(r) in REGIMES else 0
            if rank > REGIMES.index(cur):
                regime[str(lv)] = str(r)
            else:
                regime.setdefault(str(lv), cur)
        t = str(c.get("topology") or "")
        if t:
            topology[t] = topology.get(t, 0) + 1
        w = str(c.get("wire") or "")
        if w:
            wire[w] = wire.get(w, 0) + 1
        for lv, d in (c.get("deadlines") or {}).items():
            if isinstance(d, (int, float)):
                deadlines[str(lv)] = max(deadlines.get(str(lv), 0.0), float(d))
        cad = c.get("cadence") or {}
        if cad.get("applied_k"):
            applied_ks.append(int(cad["applied_k"]))
        for pair, rec in (cad.get("per_pair") or {}).items():
            cur = pair_k.setdefault(
                str(pair), {"k": None, "bw_floor_bps": None, "reporters": 0}
            )
            cur["reporters"] += 1
            if isinstance(rec, dict) and rec.get("k") is not None:
                k = int(rec["k"])
                cur["k"] = k if cur["k"] is None else min(cur["k"], k)
                bw = rec.get("bw_floor_bps")
                if isinstance(bw, (int, float)) and (
                    cur["bw_floor_bps"] is None or bw < cur["bw_floor_bps"]
                ):
                    cur["bw_floor_bps"] = float(bw)
        transitions += int(c.get("transitions_total") or 0)
        tph += float(c.get("transitions_per_hour") or 0.0)
        lt = c.get("last_transition")
        if isinstance(lt, dict) and (
            last is None
            or (lt.get("applied_t") or 0) > (last.get("applied_t") or 0)
        ):
            last = lt
    return {
        "schema_version": CONTROLLER_SCHEMA_VERSION,
        "reporting": len(per_peer),
        "regime": regime,
        "topology": topology,
        "wire": wire,
        "cadence": {
            "applied_k_min": min(applied_ks) if applied_ks else None,
            "per_pair": pair_k,
        },
        "deadlines": deadlines,
        "transitions_total": transitions,
        "transitions_per_hour": round(tph, 2),
        "last_transition": last,
        "per_peer": per_peer,
    }
