"""Adaptive resilience policy for averaging rounds (Chameleon-style).

One object per volunteer that watches how rounds actually go and adjusts
the knobs the averaging tier runs on, instead of static configuration:

- **round deadline** (``round_budget(level)``): the wall-clock budget a
  round is allowed before it commits with partial participation. Learned
  from COMPLETE rounds' durations (EWMA + 4 deviations, the classic
  adaptive-RTO shape) and AIMD-backed-off on failures — a healthy swarm
  converges to tight deadlines where a stalled peer costs little; a
  genuinely slow network ratchets the budget back toward the configured
  ceiling instead of failing forever. The AIMD state is split PER
  HIERARCHY LEVEL (flat / intra / cross): intra-zone rounds run on fat
  local links and cross-zone rounds on thin WAN links BY DESIGN, so one
  shared estimate would either starve cross rounds or slacken intra ones.
  A level's estimator seeds from the flat record's current operating
  point the first time that level runs, then diverges on its own
  evidence; ``round_budget()`` with no level keeps the pre-split
  behavior (the flat record) for every existing caller.
- **retry backoff** (``backoff_s()``): consecutive failed rounds back off
  exponentially (capped), so a partitioned volunteer stops hammering
  matchmaking at full cadence and re-probes on a widening schedule.
- **robust-estimator escalation** (``recommend_method()``): per-peer
  rejected-contribution counts (size/schema/token mismatches at
  aggregation, plus estimator-flagged outlier rows) escalate the
  aggregation method at runtime — a swarm configured with the cheap
  ``mean`` switches itself to ``trimmed_mean``/``median`` while rejection
  evidence persists, Chameleon's select-the-policy-from-observed-failures
  idea applied to the estimator choice.
- **pre-exclusion** (``should_preexclude()``): per-peer outcome history
  (absent/late streaks) combined with the phi-accrual detector's suspicion
  marks peers the matchmaker should leave out of group formation.
- **hedge budget** (``hedge_params()``): the tail-optimal recovery loop's
  two knobs — what fraction of the round budget to wait before the first
  hedged re-request (the *soft deadline*) and how many hedges may be in
  flight at once — learned per hierarchy level with AIMD, the same shape
  the round deadline uses: mass still lost at the deadline despite
  hedging opens the budget (additive increase in-flight, earlier soft
  deadline); rounds where hedges only duplicated tiles the original
  delivered anyway close it (multiplicative decrease, later soft
  deadline). Cross-zone rounds hedge on slow links by design, so each
  level learns its own operating point.
- **per-peer tail quantiles** (``stats()["peers"][p]["lat_p50_s"/"lat_p95_s"]``):
  observed contribution-completion latencies (arming -> seal, recorded by
  the leader per committed round) kept as a bounded per-peer sample
  window — the hedge-target ranking evidence, visible in coord.status and
  citable by the doctor.

The policy is advisory and local: every averager consults its own
instance; nothing is negotiated over the wire (the leader's deadline
travels in the round's begin message, which is the one place a single
node's policy binds a group — bounded by every member's own ceiling).

Thread-safety: all mutation happens on the asyncio loop (averager round
paths); reads from other threads see atomically-replaced floats.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Iterable, Optional, Tuple

from distributedvolunteercomputing_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Escalation ladder for the estimator recommendation. Only estimators with
# parameter-free (derived) robustness knobs — krum/bulyan need an explicit
# n_byzantine and stay operator-chosen.
_METHOD_LADDER = ("mean", "trimmed_mean", "coordinate_median")


@dataclasses.dataclass
class PeerOutcomes:
    """Per-peer round-outcome counters (sliding decay, see _decay)."""

    on_time: float = 0.0
    late: float = 0.0
    absent: float = 0.0
    rejected: float = 0.0
    # Consecutive not-on-time rounds; resets on any on-time arrival.
    miss_streak: int = 0
    # Observed contribution-completion latencies (seconds, arming -> seal;
    # recorded by the round leader). Bounded window: the tail quantiles
    # exported in stats() are what rank hedge targets.
    lat: "deque[float]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=64)
    )

    def total(self) -> float:
        return self.on_time + self.late + self.absent + self.rejected


class ResiliencePolicy:
    def __init__(
        self,
        *,
        max_deadline_s: float = 20.0,
        min_deadline_s: float = 2.0,
        initial_deadline_s: Optional[float] = None,
        decay: float = 0.9,
        preexclude_misses: int = 3,
        escalate_rejections: float = 3.0,
        failure_detector=None,
        clock=time.monotonic,
        recorder=None,
    ):
        if min_deadline_s <= 0 or max_deadline_s < min_deadline_s:
            raise ValueError(
                f"need 0 < min_deadline_s <= max_deadline_s, got "
                f"{min_deadline_s} / {max_deadline_s}"
            )
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.max_deadline_s = float(max_deadline_s)
        self.min_deadline_s = float(min_deadline_s)
        init_deadline = float(
            max_deadline_s if initial_deadline_s is None else initial_deadline_s
        )
        init_deadline = min(max(init_deadline, min_deadline_s), max_deadline_s)
        self.decay = float(decay)
        self.preexclude_misses = int(preexclude_misses)
        self.escalate_rejections = float(escalate_rejections)
        self.failure_detector = failure_detector
        self.clock = clock
        # Flight recorder (swarm/telemetry.py FlightRecorder, or anything
        # with .record(kind, **fields)): escalation/backoff transitions are
        # exactly the events a chaos post-mortem wants timestamped. The
        # averager attaches its telemetry bundle's recorder when one isn't
        # supplied; None = transitions are logged only.
        self.recorder = recorder
        self.peers: Dict[str, PeerOutcomes] = {}
        # Adaptive-deadline estimate over COMPLETE (non-degraded) rounds,
        # PER HIERARCHY LEVEL. "flat" is the default record every
        # level-less caller reads and writes — byte-identical to the
        # pre-split single estimator; "intra"/"cross" records are created
        # on first use, seeded from flat's current deadline so a level
        # starts at the shared operating point and then diverges on its
        # own evidence (the ISSUE-15 acceptance: cross > intra on a
        # two-zone swarm with a slow WAN).
        self._deadline_levels: Dict[str, dict] = {
            "flat": {
                "deadline": init_deadline,
                "rt_ewma": None,
                "rt_ewdev": 0.0,
            }
        }
        self._consecutive_failures = 0
        self.rounds_seen = 0
        self.rounds_degraded = 0
        # Leader depositions this node participated in (failover recovery):
        # each one also counts as an absent outcome against the deposed
        # peer, so a crash-prone leader accrues the same miss-streak
        # evidence a straggler does and pre-exclusion (and the matchmaker's
        # leadership exclusion) fires on it.
        self.leaders_deposed = 0
        self._method_level = 0
        # Per-group round records (multi-group schedule): group ids rotate
        # every window, so this is a bounded most-recent map plus it keeps
        # the LEARNING unit honest — deadlines and outcome history stay
        # per-PEER (peers persist across rotating groups; a group id does
        # not), while these gauges expose per-group commit health so an
        # operator can see which group is slow instead of one flat number.
        self.group_rounds: Dict[str, dict] = {}
        # Per-hierarchy-level round records (flat | intra | cross), the
        # level-scoped twin of group_rounds: the hierarchical schedule
        # runs intra-zone rounds on fast links every rotation and
        # cross-zone rounds on slow links every k-th, so their durations,
        # degradation rates, and learned-deadline pressure differ BY
        # DESIGN — folding both into one gauge would hide exactly the
        # asymmetry the hierarchy exists to exploit. (Learning stays
        # per-peer and global: a deadline per level is a follow-on.)
        self.level_rounds: Dict[str, dict] = {}
        # Tail-optimal hedge budget, learned PER HIERARCHY LEVEL (flat /
        # intra / cross — cross-zone rounds hedge on slow links by design,
        # so one shared operating point would be wrong for both).
        self._hedge_levels: Dict[str, dict] = {}
        # Per-level regime stamped by the closed-loop controller
        # (swarm/controller.py): "calm" | "churn" | "degraded". Folds the
        # hedge budget into the controller's shared regime model — under
        # churn the hedger's own AIMD would need several lossy rounds to
        # re-open a budget the regime change already predicts, so
        # hedge_params() floors the operating point instead of waiting
        # for the loss evidence. Empty (every level "calm") without a
        # controller: the PR-13 behavior, unchanged.
        self._hedge_regime: Dict[str, str] = {}
        # One slow round must count ONCE: a peer whose push lands after the
        # commit is seen twice (absent in the commit batch, late on the RPC
        # path), in either order. These two sets reconcile the duplicate —
        # _last_absent remembers who the latest flush counted absent (so a
        # late arrival after it reclassifies instead of re-counting), and
        # _late_noted who record_late_arrival already counted (so a flush
        # arriving after it skips them).
        self._last_absent: set = set()
        self._late_noted: set = set()

    # -- deadline (per hierarchy level) ------------------------------------

    @property
    def _deadline(self) -> float:
        """The flat record's deadline — the pre-split scalar every legacy
        reader (group gauges, stats headline) still sees."""
        return self._deadline_levels["flat"]["deadline"]

    def _dl_rec(self, level: Optional[str]) -> dict:
        lv = level or "flat"
        rec = self._deadline_levels.get(lv)
        if rec is None:
            # Seed a new level at the FLAT record's current operating
            # point: a cross-zone round's first deadline should start
            # where the swarm already learned to run, not back at the
            # ceiling — then diverge on its own durations/failures.
            rec = self._deadline_levels[lv] = {
                "deadline": self._deadline_levels["flat"]["deadline"],
                "rt_ewma": None,
                "rt_ewdev": 0.0,
            }
        return rec

    def round_budget(self, level: Optional[str] = None) -> float:
        """Wall-clock budget for the NEXT round at ``level`` (flat when
        None — the pre-split behavior), in seconds."""
        return self._dl_rec(level)["deadline"]

    def deadlines(self) -> Dict[str, float]:
        """Current learned deadline per hierarchy level (stats/status)."""
        return {
            lv: round(rec["deadline"], 3)
            for lv, rec in self._deadline_levels.items()
        }

    def backoff_s(self) -> float:
        """Extra wait before retrying after failed rounds (0 when healthy)."""
        k = self._consecutive_failures
        if k <= 0:
            return 0.0
        return float(min(0.5 * (2.0 ** (k - 1)), 30.0))

    def _observe_duration(self, dt: float, level: Optional[str] = None) -> None:
        rec = self._dl_rec(level)
        if rec["rt_ewma"] is None:
            rec["rt_ewma"], rec["rt_ewdev"] = dt, dt / 2.0
        else:
            rec["rt_ewdev"] += 0.25 * (abs(dt - rec["rt_ewma"]) - rec["rt_ewdev"])
            rec["rt_ewma"] += 0.25 * (dt - rec["rt_ewma"])
        est = rec["rt_ewma"] + 4.0 * rec["rt_ewdev"] + 0.5
        # Multiplicative decrease TOWARD the estimate (never jumping below
        # it): one fast outlier round must not slam the deadline down onto
        # the next round's normal tail.
        target = min(max(est, self.min_deadline_s), self.max_deadline_s)
        if target < rec["deadline"]:
            rec["deadline"] = max(0.7 * rec["deadline"] + 0.3 * target, target)
        else:
            rec["deadline"] = target

    def _observe_failure(self, level: Optional[str] = None) -> None:
        # AIMD: a failed round doubles the budget toward the ceiling — a
        # genuinely slow network recovers instead of timing out forever.
        # Only the failing LEVEL pays: a partitioned WAN must not slacken
        # the intra-zone deadline that is still committing fine.
        rec = self._dl_rec(level)
        rec["deadline"] = min(rec["deadline"] * 2.0, self.max_deadline_s)
        rec["rt_ewma"] = None  # re-learn at the new regime

    # -- outcomes ----------------------------------------------------------

    def _peer(self, peer: str) -> PeerOutcomes:
        st = self.peers.get(peer)
        if st is None:
            st = self.peers[peer] = PeerOutcomes()
        return st

    def _decay_all(self) -> None:
        for st in self.peers.values():
            st.on_time *= self.decay
            st.late *= self.decay
            st.absent *= self.decay
            st.rejected *= self.decay

    MAX_GROUP_RECORDS = 16

    def _note_group(
        self, group_id: Optional[str], *, ok: bool, degraded: bool,
        duration_s: float, absent_n: int,
    ) -> None:
        if group_id is None:
            return
        rec = self.group_rounds.get(group_id)
        if rec is None:
            while len(self.group_rounds) >= self.MAX_GROUP_RECORDS:
                self.group_rounds.pop(next(iter(self.group_rounds)))
            rec = self.group_rounds[group_id] = {
                "rounds": 0, "ok": 0, "degraded": 0,
                "excluded": 0, "last_dt_s": None, "deadline_s": None,
            }
        rec["rounds"] += 1
        rec["ok"] += int(ok)
        rec["degraded"] += int(degraded)
        rec["excluded"] += absent_n
        rec["last_dt_s"] = round(duration_s, 3)
        rec["deadline_s"] = round(self._deadline, 3)

    def _note_level(
        self, level: Optional[str], *, ok: bool, degraded: bool,
        duration_s: float,
    ) -> None:
        if not level:
            return
        rec = self.level_rounds.setdefault(
            level, {"rounds": 0, "ok": 0, "degraded": 0, "last_dt_s": None},
        )
        rec["rounds"] += 1
        rec["ok"] += int(ok)
        rec["degraded"] += int(degraded)
        rec["last_dt_s"] = round(duration_s, 3)
        # The level's LEARNED deadline rides its round record so stats()
        # (and coord.status) show the per-level split next to the
        # outcomes that drove it.
        rec["deadline_s"] = round(self._dl_rec(level)["deadline"], 3)

    def record_round(
        self,
        *,
        duration_s: float,
        ok: bool,
        degraded: bool = False,
        on_time: Iterable[str] = (),
        late: Iterable[str] = (),
        absent: Iterable[str] = (),
        rejected: Iterable[str] = (),
        group_id: Optional[str] = None,
        level: Optional[str] = None,
    ) -> None:
        """One finished round, from whichever vantage this node had (a
        leader knows per-peer arrivals; a member may only know ok/duration).

        A DEGRADED round (committed at the deadline with a subset) counts
        as success for the deadline estimate's failure logic but its
        duration is NOT observed — it took ~the deadline by construction,
        and observing it would ratchet the estimate to the ceiling in
        exactly the persistent-straggler case this policy targets."""
        self.rounds_seen += 1
        absent = list(absent)
        self._note_group(
            group_id, ok=ok, degraded=degraded,
            duration_s=duration_s, absent_n=len(absent),
        )
        self._note_level(level, ok=ok, degraded=degraded, duration_s=duration_s)
        self._decay_all()
        for p in on_time:
            st = self._peer(p)
            st.on_time += 1.0
            st.miss_streak = 0
        for p in late:
            st = self._peer(p)
            st.late += 1.0
            st.miss_streak += 1
        counted_absent = set()
        for p in absent:
            if p in self._late_noted:
                # Its late arrival already counted this round's miss (the
                # push landed between the commit and this flush).
                continue
            st = self._peer(p)
            st.absent += 1.0
            st.miss_streak += 1
            counted_absent.add(p)
        self._last_absent = counted_absent
        self._late_noted.clear()
        for p in rejected:
            st = self._peer(p)
            st.rejected += 1.0
            st.miss_streak += 1
        if ok:
            self._consecutive_failures = 0
            if degraded:
                self.rounds_degraded += 1
            else:
                self._observe_duration(duration_s, level)
        else:
            self._consecutive_failures += 1
            self._observe_failure(level)
        self._maybe_escalate()

    def record_late_arrival(self, peer: str) -> None:
        """A contribution that landed AFTER its round committed (detected
        on the RPC path, outside record_round's batch). The commit usually
        counted the same peer absent already — that one event reclassifies
        absent -> late rather than advancing the miss streak twice."""
        st = self._peer(peer)
        if peer in self._last_absent:
            self._last_absent.discard(peer)
            st.absent = max(0.0, st.absent - 1.0)
            st.late += 1.0
            return  # the absent count already advanced the streak
        st.late += 1.0
        st.miss_streak += 1
        self._late_noted.add(peer)

    def note_leader_deposed(self, peer: str) -> None:
        """A round this node was a member of deposed ``peer`` as its leader
        (connection-level death / suspicion mid-round, recovered by a
        successor). Counts one absent outcome and advances the miss streak
        — the same evidence trail any other failure leaves — so
        ``should_preexclude`` (and the matchmaker's leadership exclusion,
        which consults it) keeps a crash-looping leader out of the lead."""
        self.leaders_deposed += 1
        st = self._peer(peer)
        st.absent += 1.0
        st.miss_streak += 1

    def record_rejection(self, peer: str) -> None:
        """A contribution dropped at aggregation (bad size/schema/token, or
        flagged as an outlier row by the robust estimator)."""
        self._peer(peer).rejected += 1.0
        self._maybe_escalate()

    def record_contribution_latency(self, peer: str, dt: float) -> None:
        """One observed contribution-completion latency (seconds from round
        arming to the peer's seal, recorded by the leader). Feeds the
        per-peer tail quantiles in ``stats()`` — the evidence the hedge
        loop ranks re-request targets by."""
        if dt < 0 or not dt < float("inf"):
            return
        self._peer(peer).lat.append(float(dt))

    def peer_latency_quantiles(self, peer: str) -> Optional[Tuple[float, float]]:
        """(p50, p95) of the peer's observed contribution latencies, or
        None before any sample."""
        st = self.peers.get(peer)
        if st is None or not st.lat:
            return None
        xs = sorted(st.lat)
        return (
            xs[int(0.5 * (len(xs) - 1))],
            xs[int(round(0.95 * (len(xs) - 1)))],
        )

    # -- hedge budget (tail-optimal recovery) -------------------------------

    HEDGE_SOFT_FRAC_INIT = 0.6
    HEDGE_SOFT_FRAC_MIN = 0.3
    HEDGE_SOFT_FRAC_MAX = 0.9
    HEDGE_SOFT_FRAC_STEP = 0.05
    HEDGE_INFLIGHT_INIT = 2
    HEDGE_INFLIGHT_MIN = 1
    HEDGE_INFLIGHT_MAX = 8

    def _hedge_rec(self, level: Optional[str]) -> dict:
        lv = level or "flat"
        rec = self._hedge_levels.get(lv)
        if rec is None:
            rec = self._hedge_levels[lv] = {
                "soft_frac": self.HEDGE_SOFT_FRAC_INIT,
                "max_inflight": float(self.HEDGE_INFLIGHT_INIT),
                "rounds": 0,
                "issued": 0,
                "tiles_recovered": 0,
                "duplicate_tiles": 0,
                "slots_recovered": 0,
                "lost_weight_after": 0.0,
            }
        return rec

    def set_regime(self, level: Optional[str], regime: str) -> None:
        """Adopt the controller's regime verdict for ``level`` (one shared
        model for topology/wire/hedge instead of three AIMD loops fighting
        each other). Unknown regimes are treated as "calm"."""
        self._hedge_regime[level or "flat"] = str(regime)

    def hedge_params(self, level: Optional[str] = None) -> Tuple[float, int]:
        """(soft_deadline_frac, max_inflight_hedges) for the NEXT round at
        ``level``: wait soft_frac x the round budget before the first
        hedged re-request, and keep at most max_inflight in flight.

        The controller's regime (``set_regime``) floors the learned
        operating point: under "churn" the soft deadline is pulled to at
        most 0.5x the budget with >= 2 hedges allowed, under "degraded"
        to 0.4x with >= 3 — the AIMD state itself is untouched, so when
        the regime clears the learned point resumes exactly where the
        loss evidence left it."""
        rec = self._hedge_rec(level)
        soft = float(rec["soft_frac"])
        inflight = max(1, int(round(rec["max_inflight"])))
        regime = self._hedge_regime.get(level or "flat", "calm")
        if regime == "churn":
            soft = min(soft, 0.5)
            inflight = max(inflight, 2)
        elif regime == "degraded":
            soft = min(soft, 0.4)
            inflight = max(inflight, 3)
        return soft, inflight

    def record_hedge_outcome(
        self,
        level: Optional[str] = None,
        *,
        issued: int,
        tiles_recovered: int = 0,
        duplicate_tiles: int = 0,
        slots_recovered: int = 0,
        lost_weight: float = 0.0,
    ) -> None:
        """One committed round's hedge scorecard, AIMD'd into the level's
        budget the way round deadlines learn: mass STILL lost at the
        deadline means the hedger was too little / too late — additive
        increase of in-flight budget, earlier soft deadline; a round whose
        hedges only duplicated tiles the original delivered anyway means
        the hedger fired on a healthy tail — multiplicative decrease,
        later soft deadline. Rounds with no hedges and no loss leave the
        operating point alone (no evidence either way)."""
        rec = self._hedge_rec(level)
        rec["rounds"] += 1
        rec["issued"] += int(issued)
        rec["tiles_recovered"] += int(tiles_recovered)
        rec["duplicate_tiles"] += int(duplicate_tiles)
        rec["slots_recovered"] += int(slots_recovered)
        rec["lost_weight_after"] += float(lost_weight)
        if lost_weight > 0:
            rec["max_inflight"] = min(
                rec["max_inflight"] + 1.0, float(self.HEDGE_INFLIGHT_MAX)
            )
            rec["soft_frac"] = max(
                rec["soft_frac"] - self.HEDGE_SOFT_FRAC_STEP,
                self.HEDGE_SOFT_FRAC_MIN,
            )
        elif issued and tiles_recovered == 0 and duplicate_tiles > 0:
            rec["max_inflight"] = max(
                rec["max_inflight"] * 0.7, float(self.HEDGE_INFLIGHT_MIN)
            )
            rec["soft_frac"] = min(
                rec["soft_frac"] + self.HEDGE_SOFT_FRAC_STEP,
                self.HEDGE_SOFT_FRAC_MAX,
            )

    # -- decisions ---------------------------------------------------------

    def should_preexclude(self, peer: str) -> bool:
        """Should group formation leave this peer out? True when the
        phi-accrual detector suspects it, or its recent outcome history is
        a miss streak (absent/late/rejected ``preexclude_misses`` rounds
        running)."""
        if self.failure_detector is not None and self.failure_detector.suspect(peer):
            return True
        st = self.peers.get(peer)
        return st is not None and st.miss_streak >= self.preexclude_misses

    def _maybe_escalate(self) -> None:
        worst = max(
            (st.rejected for st in self.peers.values()), default=0.0
        )
        if worst >= 2.0 * self.escalate_rejections:
            level = 2
        elif worst >= self.escalate_rejections:
            level = 1
        else:
            level = 0
        if level > self._method_level:
            log.warning(
                "resilience: escalating aggregation to %s "
                "(peer rejection score %.1f)", _METHOD_LADDER[level], worst,
            )
            self._record_event(
                "method_escalated",
                method=_METHOD_LADDER[level],
                rejection_score=round(worst, 2),
            )
            self._method_level = level
        elif level < self._method_level and worst < 0.5:
            # De-escalate only once the evidence has decayed away entirely —
            # flapping between estimators round-to-round helps nobody.
            log.info("resilience: rejection evidence decayed; back to %s",
                     _METHOD_LADDER[level])
            self._record_event(
                "method_deescalated", method=_METHOD_LADDER[level]
            )
            self._method_level = level

    def _record_event(self, kind: str, **fields) -> None:
        if self.recorder is not None:
            try:
                self.recorder.record(kind, **fields)
            except Exception:  # noqa: BLE001 — recording must not affect policy
                pass

    def recommend_method(self, configured: str) -> str:
        """Estimator to aggregate with THIS round. Only ever escalates an
        explicitly-cheap configuration (``mean``) up the derived-knob ladder;
        an operator-chosen robust method is respected as the floor."""
        if configured != _METHOD_LADDER[0]:
            return configured
        return _METHOD_LADDER[self._method_level]

    def stats(self) -> dict:
        out = {
            "deadline_s": round(self._deadline, 3),
            # The per-level deadline split (ISSUE 15): flat always
            # present; intra/cross appear once those levels have run.
            "deadlines": self.deadlines(),
            "rounds_seen": self.rounds_seen,
            "rounds_degraded": self.rounds_degraded,
            "leaders_deposed": self.leaders_deposed,
            "consecutive_failures": self._consecutive_failures,
            "method_level": _METHOD_LADDER[self._method_level],
            "peers": {
                p: self._peer_stats_dict(p, st) for p, st in self.peers.items()
            },
        }
        if self.group_rounds:
            out["groups"] = {g: dict(r) for g, r in self.group_rounds.items()}
        if self.level_rounds:
            out["levels"] = {lv: dict(r) for lv, r in self.level_rounds.items()}
        if self._hedge_levels:
            out["hedge"] = {
                lv: {
                    "soft_frac": round(rec["soft_frac"], 3),
                    "max_inflight": max(1, int(round(rec["max_inflight"]))),
                    "regime": self._hedge_regime.get(lv, "calm"),
                    "rounds": rec["rounds"],
                    "issued": rec["issued"],
                    "tiles_recovered": rec["tiles_recovered"],
                    "duplicate_tiles": rec["duplicate_tiles"],
                    "slots_recovered": rec["slots_recovered"],
                    "lost_weight_after": round(rec["lost_weight_after"], 6),
                }
                for lv, rec in self._hedge_levels.items()
            }
        return out

    def _peer_stats_dict(self, peer: str, st: PeerOutcomes) -> dict:
        out = {
            "on_time": round(st.on_time, 2),
            "late": round(st.late, 2),
            "absent": round(st.absent, 2),
            "rejected": round(st.rejected, 2),
            "miss_streak": st.miss_streak,
        }
        q = self.peer_latency_quantiles(peer)
        if q is not None:
            # Observed contribution-latency tail — the hedge-target
            # ranking, visible in coord.status and citable by the doctor.
            out["lat_p50_s"] = round(q[0], 4)
            out["lat_p95_s"] = round(q[1], 4)
            out["lat_samples"] = len(st.lat)
        return out
