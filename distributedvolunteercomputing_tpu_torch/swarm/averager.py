"""GradientAverager family: the four WAN averaging modes of the reference.

Reference parity (BASELINE.json:5,7-11):
- ``SyncAverager``      — "synchronous GradientAverager" (config 2)
- ``GossipAverager``    — "async gossip averaging" (config 3)
- ``ButterflyAverager`` — "butterfly allreduce across heterogeneous
                          volunteers" (config 4, Moshpit-style)
- ``ByzantineAverager`` — "Byzantine-tolerant aggregation under volunteer
                          churn" (config 5)

Two-tier TPU design (BASELINE.json:5): gradients are ALREADY reduced across
the chips of one slice by ``jax.lax.psum`` inside the compiled train step
(parallel/train_step.py) — what crosses here is one float32 buffer per
volunteer SLICE, exchanged over the DCN Transport and averaged on host.

Churn rules (SURVEY.md §7 hard part a): every tensor message carries the
round EPOCH from matchmaking; stale/foreign messages are dropped; any
timeout degrades the round (skip stage / aggregate the subset / return None)
instead of wedging — a dead peer costs one timeout, never a hang.

Deadline-bounded rounds (OptiReduce genre, PAPERS.md): every gather-style
round carries an absolute wall-clock DEADLINE on the consensus clock
(stamped by the leader at begin, from swarm/clocksync.py time). The round
COMMITS at the deadline with whatever contributions arrived — the weighted
mean re-normalizes over the subset, excluded peers are recorded and served
back in the fetch meta — instead of blocking on the slowest participant.
A straggler therefore costs the round its contribution, never the round
its deadline. Paired with the phi-accrual failure detector
(swarm/failure_detector.py) and the adaptive resilience policy
(swarm/resilience.py), which set the budget and pre-exclude likely
stragglers from formation in the first place.

Leader failover (sync mode): the gather leader used to be the round's last
single point of failure — a dead leader failed everyone's fetch and the
round was skipped, discarding every member's streamed contribution. Sync
rounds now carry a FENCING GENERATION alongside the matchmaking epoch
(Group.gen; 0 for the original leader). A member that observes the leader
die at the connection level (refused dial, reset socket), lose its round
state, or trip phi-accrual suspicion mid-fetch DEPOSES it: the
deterministic successor — the next live member in epoch order, skipping
peers the local policy suspects — re-leads a RECOVERY round over the same
epoch at generation+1, re-collecting the contributions members retained in
compressed wire form (nothing is recompressed, so error-feedback state
cannot double-apply). Handlers check the generation on every
sync.contribute/sync.fetch, so a deposed or partitioned ex-leader's late
serve — and a member's stale push — is rejected instead of mixing into the
newer round (Moshpit's restructure-around-the-failure applied to the
leader itself; see docs/RESILIENCE.md).
"""

from __future__ import annotations

import asyncio
import copy
import hashlib
import os
import random
import signal
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mesh_codec_mod
from distributedvolunteercomputing_tpu_torch.ops import robust
from distributedvolunteercomputing_tpu_torch.swarm.agg_stream import (
    StreamingAggregator,
    encode_wire_elems,
)
from distributedvolunteercomputing_tpu_torch.swarm.agg_stream import (
    wire_geometry as agg_wire_geometry,
)
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.matchmaking import (
    Group,
    GroupAssignment,
    GroupSchedule,
    Matchmaker,
)
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm import health as health_mod
from distributedvolunteercomputing_tpu_torch.swarm import telemetry as telemetry_mod
from distributedvolunteercomputing_tpu_torch.swarm.transport import (
    Addr,
    RPCError,
    StreamPayload,
    Transport,
)
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger, log_context
from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer, unflatten_from_buffer

log = get_logger(__name__)

# Sign-wire result-leg tag: a round result over the sign wire is q8 bytes
# behind this magic, so the receive path can tell it from a 1-bit
# contribution (SG1) by construction (raw q8's leading u64 count could
# collide with SG1 for unlucky model sizes).
_SIGN_RESULT_MAGIC = b"SQ8"


class _Streamed:
    """Sentinel "buffer" for a contribution that was folded into the round's
    StreamingAggregator on arrival: the leader never held its dense copy, so
    there is nothing to stack — the aggregator owns that mass."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "<streamed>"


STREAMED = _Streamed()


class _LeaderDown(Exception):
    """Member-side verdict that the round's leader is gone: connection-level
    failure on the push/fetch leg, lost round state, or phi-accrual
    suspicion mid-fetch. Internal control flow only — `_member_round`
    converts it into a recovery attempt, never lets it escape."""


class _Round:
    """Leader-side state for one gather round."""

    def __init__(self, expected: List[str]):
        self.expected = set(expected)
        # byzantine: peer -> (weight, buf); sync: (peer, token) -> (weight, buf).
        self.contribs: Dict[Any, Tuple[float, np.ndarray]] = {}
        # sync leader sets this to its issued-token table so the early "all
        # contributions in" check can't be tripped by forged entries.
        self.tokens: Optional[Dict[str, str]] = None
        self.full = asyncio.Event()
        # powersgd only: raw wire payloads per contribution key, kept so the
        # sync leader can serve the EXACT factored mean (concatenated
        # weighted factor pairs) instead of a dense result — by linearity
        # decode(merge(payloads)) == weighted mean of the decoded denses.
        self.payloads: Dict[Any, bytes] = {}
        self.result: Optional[np.ndarray] = None
        self.result_wire: bytes = b""  # encoded once; served to every fetch
        self.result_ready = asyncio.Event()
        # Peer ids whose contributions actually entered the aggregate —
        # served back in sync.fetch meta so a member with a pending top-k
        # error-feedback residual knows whether its shipped mass landed
        # (a degraded round may have dropped its late push).
        self.included: List[str] = []
        # Expected peers whose contributions did NOT make the deadline —
        # recorded at commit, served in fetch meta, and fed to the
        # resilience policy as this round's absent set.
        self.excluded: List[str] = []
        # Streaming leader aggregation (f32/bf16 wires, armed by the LEADER
        # when it enters the round): contribution chunks decode and fold as
        # they arrive instead of materializing per-peer dense buffers. None
        # on member side, parked rounds, and non-elementwise wires.
        self.stream: Optional[StreamingAggregator] = None
        # Leader-side round prologue ran (tokens fixed, estimator chosen,
        # stream armed): _prepare_lead_round is idempotent through this.
        self.armed = False
        self.method: Optional[str] = None
        self.kw_fn: Optional[Callable[[int], dict]] = None
        # (peer, token) -> weight for pushes the transport's request sink
        # folded COMPLETELY into the stream (its close(ok=True) ran); the
        # contribute handler and the commit adopt these into ``contribs``.
        self.stream_done: Dict[Any, float] = {}
        # Fencing generation this round state serves (Group.gen): 0 for the
        # original leader, bumped per failover recovery. Armed handlers
        # reject contribute/fetch traffic carrying any other generation.
        self.gen = 0
        # Tail-optimal recovery: XOR redundancy sidecars received for this
        # round (pred peer -> (succ peer, pred weight, xor bytes, t0 tile))
        # and the number of hedged re-requests this round issued.
        self.redund: Dict[str, tuple] = {}
        self.hedges_issued = 0
        self.t0 = time.monotonic()
        # (peer, token) keys whose dense buffer a contribute handler is still
        # folding into ``stream`` on a worker thread. They do not count
        # toward ``full``: a commit that froze the stream first would refuse
        # the feed and drop an on-time contribution as late.
        self.feeding: set = set()


class AveragerBase:
    """Shared packing, schema guard, and round bookkeeping."""

    mode = "base"

    def __init__(
        self,
        transport: Transport,
        dht: DHTNode,
        membership: SwarmMembership,
        *,
        min_group: int = 2,
        max_group: int = 16,
        gather_timeout: float = 20.0,
        join_timeout: float = 10.0,
        method: str = "mean",
        method_kw: Optional[dict] = None,
        namespace: str = "",
        wire: str = "f32",
        topk_frac: float = 0.01,
        topk_warmup_rounds: int = 0,
        powersgd_rank: int = 4,
        adaptive_timeout: bool = False,
        clock: Optional[Callable[[], float]] = None,
        round_deadline_s: Optional[float] = None,
        resilience=None,
        failure_detector=None,
        mesh_codec=None,
        group_schedule: Optional[GroupSchedule] = None,
        control_plane=None,
        telemetry=None,
        hedge: bool = True,
        tail_redundancy_frac: float = 0.0,
        controller=None,
        shard_manager=None,
    ):
        if wire not in ("f32", "bf16", "q8", "topk", "powersgd", "sign"):
            raise ValueError(f"unknown wire dtype {wire!r}")
        if wire == "sign":
            # 1-bit EF-signSGD is a GRADIENT compressor for gather-style
            # protocols (the topk reasoning: pairwise mixing compounds the
            # quantization per hop with no error feedback; sign of a
            # parameter tree is meaningless). Unlike topk it composes with
            # the robust estimators — reconstructions are DENSE ±scale
            # vectors, ordinary rows to krum/trimmed/bulyan.
            if self.mode not in ("sync", "byzantine"):
                raise ValueError(
                    f"wire='sign' is not supported for {self.mode} averaging "
                    "(gather-style sync/byzantine only)"
                )
        if wire == "powersgd":
            # Low-rank is a GRADIENT compressor for gather-style protocols,
            # same reasoning as topk below — but unlike topk it composes
            # with the robust estimators (reconstructions are DENSE, so
            # krum/trimmed/bulyan see ordinary vectors): any method is fine.
            if self.mode not in ("sync", "byzantine"):
                raise ValueError(
                    f"wire='powersgd' is not supported for {self.mode} averaging "
                    "(gather-style sync/byzantine only)"
                )
            if powersgd_rank < 1:
                raise ValueError(f"powersgd_rank must be >= 1, got {powersgd_rank}")
        if wire == "topk":
            # Top-k is a GRADIENT compressor for gather-style protocols:
            # pairwise mixing (gossip/butterfly) compounds the truncation at
            # every hop with no error feedback, and top-k of a parameter
            # tree is meaningless (it would zero most of the model).
            if self.mode not in ("sync", "byzantine"):
                raise ValueError(
                    f"wire='topk' is not supported for {self.mode} averaging "
                    "(gather-style sync/byzantine only)"
                )
            if method != "mean":
                # Coordinate-wise robust statistics over near-disjoint sparse
                # supports collapse to ~zero (at most coordinates the values
                # are {x, 0, 0, ...} and the median/trim keeps the zeros):
                # training would silently stall. Only the weighted mean is
                # sound over sparse contributions.
                raise ValueError(
                    f"wire='topk' requires method='mean' (got {method!r}): "
                    "robust estimators over sparse supports aggregate to zero"
                )
            if not 0.0 < topk_frac <= 1.0:
                raise ValueError(f"topk_frac must be in (0, 1], got {topk_frac}")
            if topk_warmup_rounds < 0:
                raise ValueError(
                    f"topk_warmup_rounds must be >= 0, got {topk_warmup_rounds}"
                )
        self.topk_frac = topk_frac
        # DGC-style sparsity warmup (Deep Gradient Compression's remedy for
        # early-training divergence under aggressive sparsification, which
        # the measured 80-round comparison shows: topk@1% converges behind
        # dense): over the first N SUCCESSFUL rounds the kept fraction ramps
        # exponentially from 1.0 (dense) to topk_frac, so early rounds — the
        # ones that contract init noise — ship (nearly) everything and the
        # aggressive fraction only applies once training stabilizes.
        self.topk_warmup_rounds = int(topk_warmup_rounds)
        self.powersgd_rank = int(powersgd_rank)
        self._psgd_codec = None  # built lazily: needs _specs from first _pack
        # Error-feedback residual (Deep Gradient Compression): entries a
        # contribution drops are banked and added to the NEXT contribution,
        # so every gradient coordinate eventually ships. The residual is
        # committed only when the round SUCCEEDS (_commit_ef): committing at
        # compression time would lose the shipped top-k mass forever on a
        # failed round (the trainer falls back to its raw local grad).
        self._ef_residual: Optional[np.ndarray] = None
        self._ef_pending: Optional[np.ndarray] = None
        # Checkpointed compressor state (EF residual + PowerSGD warm Q)
        # waiting for the first _pack, which fixes the specs it is
        # validated against. See wire_state()/load_wire_state().
        self._pending_wire_state: Optional[dict] = None
        # Whether the last round's contribution actually entered the
        # aggregate (sync members learn this from fetch meta; see average()).
        self._contribution_included = True
        self.transport = transport
        self.dht = dht
        self.membership = membership
        self.peer_id = membership.peer_id
        # Consensus wall clock (ClockSync.now from the volunteer): round
        # deadlines are ABSOLUTE times on this clock, so every member of a
        # group closes the round at the same instant regardless of skew.
        # Without one (step-cadence swarms) deadlines fall back to raw wall
        # time, which volunteer hardware can skew by more than a whole
        # budget — _deadline_wait then prefers the skew-free local bound.
        self._clock_synced = clock is not None
        self.clock = clock or time.time
        # Static per-round wall budget (seconds); None = the adaptive/
        # configured gather timeout. The resilience policy, when attached,
        # supersedes both with its learned deadline.
        self.round_deadline_s = round_deadline_s
        self.resilience = resilience
        self.failure_detector = failure_detector
        # Straggler pre-exclusion predicate consulted when WE lead group
        # formation: policy (phi + outcome history) when present, raw phi
        # suspicion otherwise.
        if resilience is not None:
            exclude = resilience.should_preexclude
        elif failure_detector is not None:
            exclude = failure_detector.suspect
        else:
            exclude = None
        # Leaders this node deposed via failover recovery (peer -> mono
        # time, TTL'd): consulted by the matchmaker's LEADERSHIP exclusion —
        # a peer that just crashed out of the lead is not handed it again
        # the moment it reappears — and by sync members refusing to join a
        # round such a peer leads while the strike is fresh.
        self._deposed_leaders: Dict[str, float] = {}
        # Replicated control plane (swarm/control_plane.py): matchmaking's
        # rendezvous polls read through a replica's micro-cache when one
        # answers (N members polling one forming round amortize to ~one
        # DHT lookup per cache window), with automatic fallback to direct
        # DHT reads — matchmaking never depends on a coordinator.
        self.control_plane = control_plane
        self.matchmaker = Matchmaker(
            transport, dht, self.peer_id, clock=self.clock, exclude=exclude,
            lead_exclude=self._lead_excluded,
            lead_weight=self._advertised_bw,
            rendezvous_get=(
                control_plane.rendezvous_get if control_plane is not None else None
            ),
        )
        self.min_group = min_group
        self.max_group = max_group
        self.gather_timeout = gather_timeout
        self.join_timeout = join_timeout
        self.method = method
        self.method_kw = method_kw or {}
        self.namespace = namespace
        # Wire codec for WAN payloads: "bf16" halves DCN traffic (the
        # averaging round's dominant cost at param scale) at bf16 rounding
        # error — acceptable for PARAMETER averaging in this genre. Part of
        # the schema hash, so mixed-wire swarms reject each other's rounds
        # instead of mis-decoding bytes.
        self.wire = wire
        # On-mesh data path (ops.mesh_codec): bf16 pack/unpack, PowerSGD
        # matmuls, and the leader's tile folds run on this volunteer's
        # local device mesh when the codec is active; None = the process
        # default, selected once at volunteer startup and surfaced in
        # stats()["mesh_codec"].
        self._mesh_codec = mesh_codec
        # Tail-optimal hedged recovery (OptiReduce, ROADMAP item 2): when
        # this node LEADS a streaming round, predicted-late peers' missing
        # tile ranges are re-requested over a second stream ahead of the
        # deadline (sync.refetch), with duplicates idempotent by (peer,
        # tile, fence). Advisory and leader-local — nothing is negotiated
        # on the wire; hedge=False restores pure deadline-drop.
        self.hedge = bool(hedge)
        # Optional summand redundancy: each member's last-k% tiles ride
        # XOR-coded on its ring successor's sidecar, decodable by the
        # leader iff the original misses commit. 0.0 = off.
        if not 0.0 <= tail_redundancy_frac <= 0.5:
            raise ValueError(
                f"tail_redundancy_frac must be in [0, 0.5], got {tail_redundancy_frac}"
            )
        self.tail_redundancy_frac = float(tail_redundancy_frac)
        # Cumulative hedge counters (stats()["hedge"] / volunteer summary).
        self.hedges_issued = 0
        self.hedges_failed = 0
        self.slots_recovered = 0
        self.redund_decodes = 0
        self._specs = None
        self._treedef = None
        self._schema: Optional[str] = None
        self.rounds_ok = 0
        self.rounds_skipped = 0
        # Adaptive round deadlines (Chameleon-style, PAPERS.md:6): observe
        # successful rounds' wall time and bound the NEXT round's waits by
        # EWMA + 4 deviations instead of the full configured timeout, so a
        # dead peer costs seconds, not the worst-case budget. Off by default
        # (opt-in via --adaptive-timeout); the configured value stays the
        # ceiling and is always used until the first success.
        self.adaptive_timeout = adaptive_timeout
        self._rt_ewma: Optional[float] = None
        self._rt_ewdev = 0.0
        self._round_degraded = False
        # Rounds that COMMITTED at the deadline with a partial group (vs
        # blocking on the slowest peer) — the deadline-bounded commit path.
        self.rounds_degraded = 0
        # Per-peer outcome detail for the round in flight, filled by the
        # paths that know it (leader gather, byzantine mesh) and flushed to
        # the resilience policy once per average() call. The epoch tags
        # which round those outcomes (and the policy's absent/late
        # reconciliation) belong to — late pushes for OLDER epochs are not
        # re-reported (their miss was already counted at their own flush).
        self._last_outcomes: Optional[dict] = None
        self._last_outcomes_epoch: Optional[str] = None
        # Cumulative leader-side aggregation-pipeline gauges (peak bytes
        # held, tiles aggregated early vs at the deadline, aggregate-thread
        # busy fraction) — filled by rounds this node LED with a streaming
        # aggregator; surfaced via stats()/volunteer summary/coord.status.
        self._agg_gauges: Dict[str, Any] = {}
        # Rotating multi-group schedule (Moshpit-style; None = the classic
        # one-group-per-epoch rendezvous). When attached, every round
        # rendezvouses under a group-scoped key — the group id folds into
        # the epoch hash, so fencing/tokens/retained bytes are group-scoped
        # without touching the round protocol itself.
        self.group_schedule = group_schedule
        if group_schedule is not None:
            # The per-round split reads a one-beat-stale membership view
            # (alive_peers(max_age=ttl/3)); keep the snapshot warm from the
            # heartbeat loop so the round path never walks the DHT for it.
            membership.keep_snapshot_fresh = True
        # The assignment of the round IN FLIGHT (reset by _rendezvous);
        # None on the single-group path. _last_seen_assignment persists
        # past the round for stats(). _last_group_expected is the
        # assignment's (pid, addr) set when every member's address was in
        # the membership records — the direct-join fast path's input.
        self._last_group: Optional[GroupAssignment] = None
        self._last_seen_assignment: Optional[GroupAssignment] = None
        self._last_group_expected: List[Tuple[str, Addr]] = []
        # Per-group gauges (schedule-attached nodes only): bounded
        # most-recent map — group ids rotate every window, so an unbounded
        # dict would grow one entry per rotation forever — plus cumulative
        # multigroup totals and a distinct-group counter.
        self._group_recent: Dict[str, dict] = {}
        self._group_totals: Dict[str, Any] = {
            "rounds_ok": 0, "rounds_skipped": 0, "rounds_degraded": 0,
            "rounds_led": 0, "last_commit_t": None,
        }
        self._groups_seen = 0
        # Per-hierarchy-level round counters (flat | intra | cross), only
        # populated on schedule-attached nodes: the observability half of
        # the hierarchical schedule — an operator must be able to see the
        # intra/cross cadence actually happening, per level, not folded
        # into one gauge.
        self._level_totals: Dict[str, Dict[str, int]] = {}
        # Telemetry plane (swarm/telemetry.py): round tracing, the unified
        # metrics registry, and the flight recorder. The volunteer passes a
        # shared per-process bundle (ClockSync-aligned clock, RPCs
        # registered); bare averagers get a private enabled one so the
        # surfaces exist in every test/bench construction.
        self.telemetry = (
            telemetry
            if telemetry is not None
            else telemetry_mod.Telemetry(peer_id=self.peer_id, clock=self.clock)
        )
        self._register_telemetry()
        # Training-health layer (swarm/health.py): sketch seed fixed to the
        # averaging namespace (every peer in a namespace projects into the
        # SAME space), the zone joined from membership for the per-zone
        # dispersion rollup, and quality flags surfaced into the membership
        # record so the swarm can see who this vantage distrusts.
        self.health = getattr(self.telemetry, "health", None)
        if self.health is not None and self.health.enabled:
            self.health.configure(self.namespace)
            self.health.zone_fn = lambda: self.zone
            if self.health.on_flag is None:
                self.health.on_flag = self._surface_quality_flags
        # Closed-loop adaptive controller (swarm/controller.py): reads
        # the telemetry this averager produces and retunes topology /
        # wire / cadence / per-level deadlines / hedge regime, epoch-
        # fenced (decisions apply from the NEXT round — _apply_controller
        # runs before formation). None = every knob stays hand-set (the
        # --no-adapt contract).
        self.controller = controller
        # Zone-sharded training (swarm/sharding.py): when attached, this
        # averager's tree is the volunteer's OWN shard slice and the
        # rendezvous scopes groups to same-shard peers (the ``shards``
        # map below), so cross-zone rounds move ~1/K of the tree. The
        # manager itself stays off the round path — it only moves state
        # when membership does.
        self.shard_manager = shard_manager
        # gates: the transport's measured per-peer downlink EWMA by
        # default. Pluggable because the chaos link model shapes WALL
        # TIME but not measured arrival rates (the documented set_link
        # fidelity limit) — campaigns and benches inject modeled
        # advertisements here, the hierarchy_bench extra_info pattern.
        self.bw_probe = self.transport.peer_bw_down
        if controller is not None:
            controller.attach(
                wire=self.wire, schedule=group_schedule, max_group=max_group,
            )
            self.telemetry.registry.source("controller", controller.summary)
        if shard_manager is not None:
            self.telemetry.registry.source("sharding", shard_manager.summary)
            if getattr(shard_manager, "telemetry", None) is None:
                # shard_lost/shard_recovered/fence events land in this
                # volunteer's flight recorder.
                shard_manager.telemetry = self.telemetry

    def _surface_quality_flags(self, flagged: List[str]) -> None:
        """Carry this vantage's flagged-peer list in the next heartbeat
        record (bounded: the flag set is a few ids)."""
        update = getattr(self.membership, "update_info", None)
        if update is not None:
            update(health_flagged=list(flagged))

    def _health_note_commit(
        self,
        buf: Optional[np.ndarray],
        trace: str,
        mass: Optional[dict] = None,
        quality: Optional[Dict[str, float]] = None,
    ) -> None:
        """One committed round's health bookkeeping (runs off the event
        loop): per-peer quality votes, the balanced mass report, and the
        post-round parameter sketch. Advisory — never fails the round."""
        h = self.health
        if h is None or not h.enabled:
            return
        try:
            if quality:
                h.observe_round_quality(quality, trace=trace)
                if self.controller is not None and buf is not None:
                    # Relative contribution dispersion for the cadence
                    # knob: sqrt(mean per-peer d2) over the aggregate
                    # norm — the leader-local form of the cross-zone
                    # sketch-dispersion trend (only cross rounds feed
                    # the trend; the controller filters by level).
                    den = float(np.linalg.norm(buf))
                    if den > 0:
                        rel = float(
                            np.sqrt(sum(quality.values()) / len(quality))
                        ) / den
                        self.controller.observe_dispersion(
                            self._last_group.level
                            if self._last_group is not None else None,
                            rel,
                        )
            if mass is not None:
                h.note_round_mass(mass, trace=trace)
            if buf is not None:
                h.note_sketch(buf, trace=trace)
        except Exception as e:  # noqa: BLE001 — health must never fail a round
            log.debug("health commit bookkeeping failed: %s", errstr(e))

    def _register_telemetry(self) -> None:
        """Re-register the pre-existing stats() surfaces into the unified
        registry as callback sources: every scrape flattens their numeric
        leaves into gauges under a stable dotted namespace, so the ad-hoc
        dicts PRs 1-9 accreted are all reachable from one scrape without
        rewriting the code that fills them."""
        reg = self.telemetry.registry
        reg.gauge_fn("swarm.rounds_ok", lambda: self.rounds_ok)
        reg.gauge_fn("swarm.rounds_skipped", lambda: self.rounds_skipped)
        reg.gauge_fn("swarm.rounds_degraded", lambda: self.rounds_degraded)
        reg.source("transport", self.transport.stats)
        reg.source("mesh_codec", lambda: self.mesh_codec.stats())
        if self._mesh_codec is not None and getattr(self._mesh_codec, "recorder", None) is None:
            # Slice-loss degrades land in this volunteer's flight recorder.
            # (The lazily-resolved process default is hooked by the
            # volunteer, which configures it.)
            self._mesh_codec.recorder = self.telemetry.recorder
        reg.source("aggregation", lambda: dict(self._agg_gauges))
        if self.group_schedule is not None:
            reg.source("groups", self.group_stats)
        if self.resilience is not None:
            reg.source("resilience", self.resilience.stats)
            if getattr(self.resilience, "recorder", None) is None:
                # Escalation/backoff transitions land in this volunteer's
                # flight recorder (resilience event hooks).
                self.resilience.recorder = self.telemetry.recorder
        mem_stats = getattr(self.membership, "stats", None)
        if mem_stats is not None:
            reg.source("control_plane", mem_stats)

    MAX_GROUP_GAUGES = 16

    @property
    def zone(self) -> str:
        """This volunteer's advertised zone ("" = unzoned), read from the
        membership record fields so the schedule, the stats, and the wire
        advertisement can never disagree."""
        return str(self.membership.extra_info.get("zone") or "")

    def _advertised_bw(self, pid: str) -> Optional[float]:
        """Advertised uplink bandwidth (bytes/s) for a leadership
        candidate, from the cached membership snapshot — the deterministic
        rendezvous input for bandwidth-weighted leader election (no extra
        RPCs; one-heartbeat staleness resolves via begin-wins)."""
        rec = self.membership.peer_record(pid)
        bw = (rec or {}).get("bw_up")
        if isinstance(bw, (int, float)) and not isinstance(bw, bool) and bw > 0:
            return float(bw)
        return None

    async def _rendezvous(self) -> str:
        """Rendezvous key for the NEXT round: the constant per-mode key
        (no schedule, lookup failure, or a swarm too small to split), or
        the group-scoped key from the rotating schedule. Side effect:
        ``self._last_group`` holds the round's assignment for gauges and
        ``self._last_group_expected`` the group's (pid, addr) set when every
        member's address is known — the direct-join formation input."""
        self._last_group = None
        self._last_group_expected = []
        if self.group_schedule is None:
            return self.round_key
        try:
            # One-heartbeat staleness is the membership system's native
            # resolution; accepting it here keeps the iterative DHT lookup
            # off every round's critical path (worst case: a just-dead
            # peer stays expected for one beat and costs a refused dial).
            peers = await self.membership.alive_peers(
                include_self=True, max_age=self.membership.ttl / 3.0
            )
        except Exception as e:  # noqa: BLE001 — a lookup hiccup must not kill rounds
            log.debug("group schedule: membership lookup failed (%s)", errstr(e))
            return self.round_key
        # Same population filter gossip partner-selection applies: only
        # peers averaging the same namespace count toward the split (a
        # record without avg_ns — bare test swarms — is not excluded).
        ids = [
            pid for pid, rec in peers.items()
            if pid == self.peer_id
            or not self.namespace
            or rec.get("avg_ns", self.namespace) == self.namespace
        ]
        # Zone advertisements for the hierarchical split (peers without one
        # — mixed-version swarms — schedule as the "" pseudo-zone; our own
        # zone comes from our record, or the local config if the snapshot
        # predates our join).
        zones = {
            pid: str(peers.get(pid, {}).get("zone") or "") for pid in ids
        }
        zones.setdefault(self.peer_id, self.zone)
        # Shard advertisements (zone-sharded training): peers carrying a
        # "shard" field in their record group only with same-shard peers,
        # and the shard rides in the group id — the round key, and hence
        # the epoch hash and fencing tokens, become shard-scoped. Peers
        # without the advertisement schedule exactly as before.
        shards: Dict[str, int] = {}
        for pid in ids:
            s = (peers.get(pid) or {}).get("shard")
            if isinstance(s, int) and not isinstance(s, bool):
                shards[pid] = s
        if self.shard_manager is not None and self.peer_id not in shards:
            p = self.shard_manager.primary_shard()
            if p is not None:
                shards[self.peer_id] = int(p)
        asg = self.group_schedule.assign(
            ids, self.peer_id, zones=zones, shards=shards or None
        )
        if asg is None:
            return self.round_key
        self._last_group = asg
        self._last_seen_assignment = asg
        # Direct-join needs every expected member's address. A member whose
        # record lacks one (can't happen for records membership itself
        # wrote, but belt-and-braces) is simply not expected — it can still
        # join us via its own view; if WE are the address-less one, the
        # self entry below fixes it (our own transport knows our addr).
        expected: List[Tuple[str, Addr]] = []
        for pid in asg.members:
            if pid == self.peer_id:
                expected.append((pid, self.transport.addr))
                continue
            addr = (peers.get(pid) or {}).get("addr")
            if isinstance(addr, (list, tuple)) and len(addr) == 2:
                expected.append((pid, (str(addr[0]), int(addr[1]))))
        self._last_group_expected = expected
        return f"{self.round_key}/{asg.group_id}"

    async def _form_group(self, round_key: str):
        """Form this round's group: the direct-join fast path when a
        schedule assignment (with addresses) is in hand — the group is
        deterministic, so the generic DHT rendezvous (K-replica store +
        iterative lookup per poll, ~60 DHT RPCs per member-round at N=16)
        collapses to ~4 direct RPCs — else the classic DHT rendezvous."""
        if (
            self._last_group is not None
            and len(self._last_group.members) < max(2, self.min_group)
        ):
            # A scheduled group below the configured floor (a lone peer —
            # or an undersized zone — at an intra rotation): the schedule
            # is deterministic, so the members that could rendezvous under
            # this key can never reach min_group — skip in O(1) instead of
            # burning the whole join timeout, and never run a round
            # beneath the operator's robustness minimum (a byzantine
            # min_group is a breakdown-point guarantee, not a preference).
            # The members keep training locally and re-mix at the next
            # cross rotation.
            log.debug(
                "round %s: scheduled group of %d below min_group %d, "
                "skipping", round_key, len(self._last_group.members),
                self.min_group,
            )
            return None
        if self._last_group is not None and len(self._last_group_expected) >= 2:
            group = await self.matchmaker.form_group_direct(
                round_key, self._last_group_expected,
                self.min_group, self.max_group, self.join_timeout,
                round_budget_s=self._round_budget(),
            )
            if group is None:
                # A scheduled group that never formed is the signature of
                # a stale/divergent membership view (churn, join burst):
                # make the next round's split read fresh.
                self.membership.invalidate_snapshot()
        else:
            group = await self.matchmaker.form_group(
                round_key, self.min_group, self.max_group, self.join_timeout,
                round_budget_s=self._round_budget(),
            )
        if group is not None and self._last_group is not None:
            # Stamp the schedule's group id here, once for every averaging
            # mode — stats and failover logs name the group by it.
            group.group_id = self._last_group.group_id
        return group

    def _note_group_round(
        self,
        ok: Optional[bool],
        *,
        degraded: bool = False,
        led: bool = False,
        size: int = 0,
    ) -> None:
        """Roll one finished round into the per-group gauges (``ok`` None =
        the round never formed — a matchmaking skip). No-op without a
        schedule: single-group stats stay byte-identical to before."""
        if self.group_schedule is None:
            return
        asg = self._last_group
        gid = asg.group_id if asg is not None else "single"
        level = asg.level if asg is not None else "flat"
        rec = self._group_recent.get(gid)
        if rec is None:
            self._groups_seen += 1
            while len(self._group_recent) >= self.MAX_GROUP_GAUGES:
                self._group_recent.pop(next(iter(self._group_recent)))
            rec = self._group_recent[gid] = {
                "rounds_ok": 0, "rounds_skipped": 0, "rounds_degraded": 0,
                "rounds_led": 0, "size": 0, "last_commit_t": None,
                "level": level,
                "zone": asg.zone if asg is not None else "",
            }
        if size:
            rec["size"] = size
        lv = self._level_totals.setdefault(
            level, {"rounds_ok": 0, "rounds_skipped": 0, "rounds_degraded": 0}
        )
        if ok:
            lv["rounds_ok"] += 1
            if degraded:
                lv["rounds_degraded"] += 1
        else:
            lv["rounds_skipped"] += 1
        tot = self._group_totals
        if ok:
            rec["rounds_ok"] += 1
            tot["rounds_ok"] += 1
            t = self.clock()
            rec["last_commit_t"] = t
            tot["last_commit_t"] = t
            if degraded:
                rec["rounds_degraded"] += 1
                tot["rounds_degraded"] += 1
            if led:
                rec["rounds_led"] += 1
                tot["rounds_led"] += 1
        else:
            rec["rounds_skipped"] += 1
            tot["rounds_skipped"] += 1

    def zone_traffic(self) -> dict:
        """WAN bytes split by zone locality, from the transport's per-peer
        counters joined against the membership snapshot's addr -> zone map
        (all traffic to a peer counts — averaging payloads dominate, and
        DHT/heartbeat bytes cross the same links). Peers whose address is
        not in the snapshot (departed, or the coordinator) are uncharged.
        This is the live, per-volunteer form of the hierarchical
        schedule's headline metric: cross-zone bytes, rollable into
        cross_zone_bytes_per_commit at the coordinator."""
        myz = self.zone
        zmap = self.membership.zone_by_addr()
        out = {
            "cross_zone_bytes_sent": 0, "cross_zone_bytes_received": 0,
            "intra_zone_bytes_sent": 0, "intra_zone_bytes_received": 0,
        }
        # Same-package read of the transport's per-peer counters (the
        # public stats() form stringifies the addr key).
        for addr, st in self.transport._peer_stats.items():
            z = zmap.get(addr)
            if z is None:
                continue
            side = "cross" if z != myz else "intra"
            out[f"{side}_zone_bytes_sent"] += st.bytes_sent
            out[f"{side}_zone_bytes_received"] += st.bytes_received
        return out

    def group_stats(self) -> dict:
        """Group-schedule gauges for stats()/volunteer report/coord.status:
        the current assignment (rotation, group id, split), cumulative
        multigroup round counters, and a bounded per-group breakdown so
        dashboards can see per-group commit health instead of one flat
        number silently averaging across groups. Hierarchy-aware: the
        volunteer's zone, the current assignment's level, per-level round
        counters, and the cross/intra-zone byte split ride along so the
        coordinator can roll up per-zone health and cross-zone bytes per
        committed round."""
        sched = self.group_schedule
        out: Dict[str, Any] = {"enabled": sched is not None}
        if sched is None:
            return out
        out["target_size"] = sched.target_size
        out["rotation_s"] = sched.rotation_s
        if sched.cross_zone_every_k:
            out["cross_zone_every_k"] = sched.cross_zone_every_k
        out["zone"] = self.zone
        asg = self._last_seen_assignment
        if asg is not None:
            out["rot"] = asg.rot
            out["group_id"] = asg.group_id
            out["n_groups_view"] = asg.n_groups
            out["n_peers_view"] = asg.n_peers
            out["level"] = asg.level
            if asg.shard is not None:
                out["shard"] = asg.shard
        out.update(self._group_totals)
        out["distinct_groups"] = self._groups_seen
        if self._level_totals:
            out["levels"] = {lv: dict(c) for lv, c in self._level_totals.items()}
        out.update(self.zone_traffic())
        out["recent"] = {g: dict(r) for g, r in self._group_recent.items()}
        return out

    @property
    def round_key(self) -> str:
        """Constant rendezvous key per mode+model — see Matchmaker.form_group.

        The namespace (the model name, set by the Volunteer) keeps volunteers
        training DIFFERENT models from ever rendezvousing into one group:
        without it a bert volunteer could join a gpt2 round and every
        exchange would be a wrong-size buffer.
        """
        ns = f"/{self.namespace}" if self.namespace else ""
        return f"avg/{self.mode}{ns}"

    # Distinct epochs a remote peer can allocate round state under between
    # our own average() calls. Combined with MAX_PARKED_CONTRIBS this bounds
    # attacker-driven memory to ROUNDS x CONTRIBS x payload even if the local
    # trainer never averages again.
    MAX_PARKED_ROUNDS = 32
    # Per-round cap on parked contributions (param-sized buffers under
    # unvalidated peer ids). One bound for every subclass that parks — a
    # per-subclass copy is how the byz path shipped uncapped in round 1.
    MAX_PARKED_CONTRIBS = 64

    def _observe_round_time(self, dt: float) -> None:
        """Feed a COMPLETE round's wall time into the deadline estimate.

        Callers must only report rounds where every expected peer arrived:
        a degraded round (subset aggregated after the deadline fired) takes
        ~the current deadline by construction, and observing it would
        ratchet the estimate geometrically back to the ceiling — defeating
        the feature in exactly the persistent-churn case it targets."""
        if self._rt_ewma is None:
            self._rt_ewma, self._rt_ewdev = dt, dt / 2.0
        else:
            self._rt_ewdev += 0.25 * (abs(dt - self._rt_ewma) - self._rt_ewdev)
            self._rt_ewma += 0.25 * (dt - self._rt_ewma)

    def _observe_round_failure(self) -> None:
        """A FAILED round doubles the estimate toward the configured
        ceiling (AIMD-style): without this, an estimate warmed on a fast
        network can never recover when latency genuinely rises — the peer
        would time out every round forever and silently train solo."""
        if self._rt_ewma is not None:
            self._rt_ewma = min(self._rt_ewma * 2.0, self.gather_timeout)
            self._rt_ewdev = min(self._rt_ewdev * 2.0 + 0.1, self.gather_timeout / 2.0)

    @property
    def effective_gather_timeout(self) -> float:
        if not self.adaptive_timeout or self._rt_ewma is None:
            return self.gather_timeout
        est = self._rt_ewma + 4.0 * self._rt_ewdev + 1.0
        return float(min(self.gather_timeout, max(est, 2.0)))

    # -- deadline-bounded rounds -------------------------------------------

    def _round_budget(self) -> float:
        """Wall-clock budget (seconds) for the NEXT round: the resilience
        policy's learned deadline when attached — PER HIERARCHY LEVEL,
        read off the round-in-flight's assignment, so a cross-zone round
        on a slow WAN runs its own learned budget while intra rounds stay
        tight — else the static ``round_deadline_s``, else the (possibly
        EWMA-adapted) gather timeout. The leader stamps ``clock() +
        budget`` into the begin."""
        if self.resilience is not None:
            level = self._last_group.level if self._last_group is not None else None
            return float(self.resilience.round_budget(level))
        if self.round_deadline_s:
            return float(self.round_deadline_s)
        return self.effective_gather_timeout

    def _deadline_remaining(self, group) -> Optional[float]:
        """Seconds until the group's commit deadline, or None when the
        begin carried none. Skew guard: without a ClockSync the deadline is
        raw wall time, and clocks on volunteer hardware can disagree by
        more than the whole budget — a member running ahead of the leader
        would see every round as already expired and collapse every wait to
        the floor (timing out its own pushes round after round, straight
        into pre-exclusion). The budget counted from when WE learned the
        round is skew-free; we learned it after the stamp, so it errs only
        toward waiting a little longer (the begin fan-out time)."""
        if group is None or group.deadline is None:
            return None
        if group.budget is not None and not self._clock_synced:
            return group.budget - (time.monotonic() - group.formed_mono)
        return group.deadline - self.clock()

    def _deadline_wait(self, group, floor: float = 0.5) -> float:
        """Seconds this node may still wait before the group's deadline.

        Clamped: the floor keeps a round that formed slowly (fan-out spent
        the budget) from committing with nothing at all, and the ceiling
        bounds a crafted/skewed deadline from a foreign leader to what this
        node would have waited anyway."""
        ceiling = max(self.gather_timeout, self._round_budget())
        remaining = self._deadline_remaining(group)
        if remaining is None:
            return min(self._round_budget(), ceiling)
        return float(min(max(remaining, floor), ceiling))

    async def _maybe_backoff(self) -> None:
        """Honor the policy's retry backoff after consecutive failed rounds
        (a partitioned volunteer stops paying full matchmaking cadence)."""
        if self.resilience is not None:
            delay = self.resilience.backoff_s()
            if delay > 0:
                log.info("%s round backoff %.1fs after failures", self.mode, delay)
                self.telemetry.event(
                    "backoff", mode=self.mode, delay_s=round(delay, 3)
                )
                await asyncio.sleep(delay)

    def _flush_round_outcome(self, duration_s: float, ok: bool) -> None:
        """Report the finished round to the resilience policy (once per
        average() call; per-peer detail only where this node observed it)
        and feed the closed-loop controller's evidence stream."""
        level = self._last_group.level if self._last_group is not None else None
        if self.resilience is not None:
            detail = self._last_outcomes or {}
            self.resilience.record_round(
                duration_s=duration_s,
                ok=ok,
                degraded=self._round_degraded,
                group_id=(
                    self._last_group.group_id
                    if self._last_group is not None else None
                ),
                level=level,
                **detail,
            )
        self._last_outcomes = None
        self._feed_controller(level, ok, duration_s)

    def _feed_controller(
        self, level: Optional[str], ok: bool, duration_s: float
    ) -> None:
        """One finished round's evidence for the controller: outcome +
        push size + the group's slowest measured link (the wire gate's
        inputs), and — on cross rounds — the per-zone-pair bandwidth
        floors the cadence knob learns from. Advisory: a controller bug
        must never fail a round."""
        c = self.controller
        if c is None:
            return
        try:
            push_bytes = bw_floor = None
            if self._specs is not None and self.wire in ("f32", "bf16"):
                esz = 4 if self.wire == "f32" else 2
                push_bytes = sum(s.size for s in self._specs) * esz
            expected = self._last_group_expected
            bws = [
                bw for bw in (
                    self.bw_probe(addr)
                    for pid, addr in expected if pid != self.peer_id
                ) if bw
            ]
            if bws:
                bw_floor = min(bws)
            c.observe_round(
                level=level, ok=ok, degraded=self._round_degraded,
                duration_s=duration_s, push_bytes=push_bytes,
                bw_floor=bw_floor, budget_s=self._round_budget(),
            )
            if level == "cross":
                # Zone-pair evidence: my zone against each other zone in
                # the MEMBERSHIP view (not just this round's group — the
                # hashed cross arcs give each vantage a different member
                # mix per rotation, and pair evidence fed only from group
                # composition left different volunteers' cadence gates
                # firing on different rounds, the exact divergence the
                # shared-evidence design exists to avoid). The pair's
                # floor is the slowest probed link to that zone.
                myz = self.zone
                my_addr = (str(self.transport.addr[0]), int(self.transport.addr[1]))
                by_zone: Dict[str, list] = {}
                for addr, z in self.membership.zone_by_addr().items():
                    if addr == my_addr or z == myz:
                        continue
                    by_zone.setdefault(z, []).append(addr)
                for z, addrs in by_zone.items():
                    pair = "|".join(sorted((myz, z)))
                    pbws = [
                        bw for bw in (self.bw_probe(a) for a in addrs) if bw
                    ]
                    c.observe_cross_pair(
                        pair,
                        bw_floor=min(pbws) if pbws else None,
                        ok=ok, degraded=self._round_degraded,
                    )
        except Exception as e:  # noqa: BLE001 — controller evidence is advisory
            log.debug("controller feed failed: %s", errstr(e))

    def _apply_controller(self) -> None:
        """Promote the controller's fenced decisions and apply them to
        the knobs this averager owns: schedule geometry (topology),
        cross-zone cadence, and the dense wire. Called ONCE per
        average() call, BEFORE rendezvous/formation — the epoch-fence
        contract: a decision staged during round N takes effect from
        round N+1 and can never mix two configurations into one round."""
        c = self.controller
        if c is None:
            return
        try:
            if not c.advance():
                return
            sched = self.group_schedule
            if sched is not None:
                ts = c.target_group_size()
                if ts:
                    sched.retune(
                        target_size=min(
                            max(ts, max(2, self.min_group)), self.max_group
                        )
                    )
                k = c.cross_zone_k()
                if k:
                    sched.retune(cross_zone_every_k=k)
            if c.wire in ("f32", "bf16") and c.wire != self.wire:
                self.set_wire(c.wire)
                if self.wire != c.wire:
                    # set_wire refused (chunk-alignment guard): the
                    # controller must adopt the ACTUAL wire or its gate
                    # evidence (push bytes at the wrong element size)
                    # and every future flip decision desync from
                    # reality.
                    c.wire = self.wire
        except Exception as e:  # noqa: BLE001 — a controller bug must not kill rounds
            log.warning("controller apply failed: %s", errstr(e))

    # -- leader failover bookkeeping ---------------------------------------

    # How long a deposed-leader strike keeps a peer out of the lead (and,
    # for sync members, out of rounds it leads). Long enough to cover a
    # crash-loop's restart, short enough that a genuinely-healed peer gets
    # the lead back within a few formation cadences.
    DEPOSED_LEADER_TTL_S = 90.0

    def _recently_deposed(self, pid: str) -> bool:
        t = self._deposed_leaders.get(pid)
        if t is None:
            return False
        if time.monotonic() - t > self.DEPOSED_LEADER_TTL_S:
            del self._deposed_leaders[pid]
            return False
        return True

    def _lead_excluded(self, pid: str) -> bool:
        """Leadership-exclusion predicate handed to the matchmaker: a
        recently-deposed ex-leader, a policy-pre-excluded straggler, or a
        phi/connection-suspected peer should not self-elect (from THIS
        node's vantage; divergent views cost one underfilled round, never
        mixed tensors — see Matchmaker._pick_leader)."""
        if self._recently_deposed(pid):
            return True
        try:
            if self.resilience is not None and self.resilience.should_preexclude(pid):
                return True
            if self.failure_detector is not None and self.failure_detector.suspect(pid):
                return True
        except Exception:  # noqa: BLE001 — a policy bug must not kill rounds
            pass
        return False

    def _effective_method(self, n_peers: int) -> Tuple[str, dict]:
        """(method, kwargs) to aggregate with THIS round. Consults the
        policy's runtime estimator escalation — except on the topk wire,
        where robust statistics over sparse supports are unsound and mean
        is forced at construction time."""
        method = self.method
        if self.resilience is not None and self.wire != "topk":
            method = self.resilience.recommend_method(self.method)
        return method, self._robust_kw(n_peers, method=method)

    def _sweep_rounds(self, rounds: Dict[str, "_Round"], max_age: Optional[float] = None) -> None:
        """Evict stale round state (parked contributions hold param-sized
        buffers; a round nobody finishes must not leak them)."""
        if max_age is None:
            max_age = self.gather_timeout * 3 + 30.0
        now = time.monotonic()
        for epoch in [e for e, st in rounds.items() if now - st.t0 > max_age]:
            del rounds[epoch]

    def _get_or_park_round(self, rounds: Dict[str, "_Round"], epoch: str) -> "_Round":
        """Round state for a remote-initiated epoch, swept + capped.

        Contributions can legitimately arrive before the local peer enters
        the round; but every unknown epoch string allocates a fresh _Round,
        so sweep on each RPC (not only in average()) and refuse once the
        number of remotely-created rounds hits the cap."""
        st = rounds.get(epoch)
        if st is None:
            self._sweep_rounds(rounds)
            parked = sum(1 for s in rounds.values() if not s.expected)
            if parked >= self.MAX_PARKED_ROUNDS:
                raise RPCError("parked round cap reached")
            st = rounds[epoch] = _Round([])
        return st

    # -- packing -----------------------------------------------------------

    def _pack(self, tree: Any) -> np.ndarray:
        buf, specs, treedef = flatten_to_buffer(tree)
        if self._schema is None:
            self._specs, self._treedef = specs, treedef
            self._schema = self._compute_schema()
        self._apply_pending_wire_state()
        return buf

    def _compute_schema(self) -> str:
        """Schema hash over (specs, wire, namespace) — ``self._specs``
        must exist. The namespace is part of the hash: a params tree and
        a grads tree of the same model flatten to IDENTICAL shapes, so
        shapes+dtypes+wire alone can't stop a cross-mode payload from
        being accepted on the receive path (e.g. a gossip push banked
        into the wrong inbox). With the namespace folded in, every
        averager's _check_schema rejects it at the door. The wire is in
        the hash too, which is what makes a controller wire flip safe by
        construction: a peer still on the old wire pushes under the old
        schema and is REJECTED (one excluded contribution), never
        mis-decoded."""
        wire_tag = self.wire
        if self.wire == "topk":
            wire_tag = f"topk:{self.topk_frac}"
        elif self.wire == "powersgd":
            wire_tag = f"powersgd:{self.powersgd_rank}"
        return hashlib.sha1(
            repr(
                [(s.shape, s.dtype) for s in self._specs]
                + [wire_tag, self.namespace]
            ).encode()
        ).hexdigest()[:16]

    def set_wire(self, wire: str) -> None:
        """Adopt a controller-selected DENSE wire (f32 <-> bf16), between
        rounds only (the controller's epoch fence guarantees the call
        site). Restricted to the dense elementwise pair: they share tile
        geometry and carry no compressor state, so the flip re-keys the
        schema hash and changes nothing else. Compressed wires (topk /
        powersgd / sign) carry error-feedback and warm factors whose
        churn would cost real gradient mass — those stay construction-
        time choices (the controller only RANKS them)."""
        if wire == self.wire:
            return
        if wire not in ("f32", "bf16") or self.wire not in ("f32", "bf16"):
            raise ValueError(
                f"live wire switch only supports f32<->bf16, "
                f"got {self.wire!r} -> {wire!r}"
            )
        esz = 4 if wire == "f32" else 2
        if self.transport.chunk_bytes % esz:
            log.warning(
                "wire switch to %s refused: chunk_bytes %d not divisible "
                "by element size %d", wire, self.transport.chunk_bytes, esz,
            )
            return
        old = self.wire
        self.wire = wire
        if self._specs is not None:
            self._schema = self._compute_schema()
        log.info("wire: %s -> %s (schema re-keyed)", old, wire)

    def _unpack(self, buf: np.ndarray) -> Any:
        return unflatten_from_buffer(buf, self._specs, self._treedef, device=None)

    # -- checkpointable compressor state -----------------------------------
    # A preempted volunteer on a lossy wire used to rejoin COLD: the
    # error-feedback residual (gradient mass owed to the swarm) and
    # PowerSGD's warm Q factors (which buy the power iteration its accuracy)
    # both lived only in process memory (r4 VERDICT #7; the outer-state
    # sidecar in training/checkpoint.py is the same pattern for the same
    # reason). wire_state() is read on the checkpoint thread while rounds
    # may be in flight — safe because every array in play is REPLACED
    # wholesale (new object assignment), never mutated in place, so a copy
    # taken here is a consistent value from some recent round per tensor.

    def wire_state(self) -> Optional[dict]:
        """Compressor state worth persisting, as a flat npz-able dict, or
        None when there is nothing learned yet (dense wires, or no round
        has run)."""
        if self.wire not in ("topk", "powersgd", "sign"):
            return None
        out: dict = {"wire": np.bytes_(self.wire.encode())}
        ef = self._ef_residual
        if ef is not None:
            out["ef"] = ef.copy()
        codec = self._psgd_codec
        if codec is not None and codec._warm_q:
            out["rank"] = np.int64(codec.rank)
            for idx, q in list(codec._warm_q.items()):
                out[f"q_{idx}"] = q.copy()
        return out if len(out) > 1 else None

    def load_wire_state(self, d: dict) -> None:
        """Adopt checkpointed compressor state. Parked until the first
        ``_pack``: sizes/shapes can only be validated against the specs,
        and a mismatch (different model, different wire, different rank)
        re-seeds LOUDLY — one warning naming the old/new wire+rank+size —
        with the same cold-start semantics as the outer-state sidecar."""
        self._pending_wire_state = {k: v for k, v in d.items()}
        if self._specs is not None:
            self._apply_pending_wire_state()

    def _apply_pending_wire_state(self) -> None:
        d, self._pending_wire_state = self._pending_wire_state, None
        if d is None:
            return
        wire = d.get("wire")
        if wire is not None:
            wire = np.asarray(wire).item()  # npz round-trips scalars as 0-d
            if isinstance(wire, bytes):
                wire = wire.decode()
        total = sum(s.size for s in self._specs)
        if wire != self.wire:
            # LOUD re-seed (VERDICT r5 #6): name exactly what mismatched so
            # a fleet-wide wire/rank change is diagnosable from one line —
            # the silent version cost the EF residual (gradient mass owed
            # to the swarm) with nothing in the logs.
            ef = d.get("ef")
            log.warning(
                "wire-state sidecar mismatch: checkpointed wire=%s rank=%s "
                "ef_size=%s vs configured wire=%s rank=%d schema_size=%d; "
                "re-seeding compressor state (EF residual and warm factors "
                "start cold)",
                wire, int(d.get("rank", -1)) if "rank" in d else None,
                getattr(ef, "size", None), self.wire, self.powersgd_rank, total,
            )
            return
        ef = d.get("ef")
        if ef is not None:
            if ef.size == total:
                self._ef_residual = np.asarray(ef, np.float32).reshape(-1).copy()
            else:
                log.warning(
                    "wire-state sidecar mismatch: checkpointed wire=%s EF "
                    "residual size %d vs configured wire=%s schema size %d; "
                    "re-seeding EF residual", wire, ef.size, self.wire, total,
                )
        if self.wire == "powersgd":
            ckpt_rank = int(d.get("rank", -1))
            if ckpt_rank == self.powersgd_rank:
                codec = self._psgd()
                for k, v in d.items():
                    if not k.startswith("q_"):
                        continue
                    idx = int(k[2:])
                    if idx < len(codec.plan) and codec.plan[idx][2] is not None:
                        _, m, r = codec.plan[idx][2]
                        if v.shape == (m, r):
                            codec._warm_q[idx] = np.asarray(v, np.float32).copy()
            elif ckpt_rank != -1:
                log.warning(
                    "wire-state sidecar mismatch: checkpointed wire=%s "
                    "rank=%d vs configured wire=%s rank=%d (schema size %d); "
                    "re-seeding PowerSGD warm factors (power iteration "
                    "restarts cold)",
                    wire, ckpt_rank, self.wire, self.powersgd_rank, total,
                )

    def _check_schema(self, args: dict) -> bool:
        # Before our first pack we don't know the schema yet — accept and let
        # the buffer-length guard at stack time catch real mismatches (an
        # early-arriving contribution from a faster peer is normal).
        return self._schema is None or args.get("schema") == self._schema

    @property
    def mesh_codec(self) -> mesh_codec_mod.MeshCodec:
        """This averager's on-mesh codec: the injected one, or the process
        default (resolved LAZILY so a volunteer that configures the default
        after constructing its averager is still honored)."""
        mc = self._mesh_codec
        return mc if mc is not None else mesh_codec_mod.get_default()

    def _psgd(self):
        """The PowerSGD codec for this averager's buffers (lazy: the plan
        needs ``_specs``, which exist after the first ``_pack``)."""
        if self._psgd_codec is None:
            from distributedvolunteercomputing_tpu_torch.swarm import powersgd

            self._psgd_codec = powersgd.PowerSGDCodec(
                self._specs, rank=self.powersgd_rank,
                mesh_codec=self.mesh_codec,
            )
        return self._psgd_codec

    def _to_wire(self, buf: np.ndarray) -> bytes:
        if self.wire == "bf16":
            return self.mesh_codec.encode_bf16(buf).tobytes()
        if self.wire == "q8":
            return native.q8_encode(buf)
        if self.wire == "topk":
            # Auto mode: results/other sends keep their full support (or go
            # dense); top-k TRUNCATION is only ever applied to contributions
            # via _compress_contribution, where error feedback catches it.
            return native.topk_encode(buf)
        if self.wire == "powersgd":
            # Results ship dense (in the self-describing container): no
            # error feedback exists on the result path, so low-rank
            # truncation there would be silent, uncorrected error — the
            # same dense-results policy as topk above.
            return self._psgd().encode_dense(buf)
        if self.wire == "sign":
            # Results ship q8, NOT 1-bit: the result path has no error
            # feedback, and a sign-quantized aggregate would hand every
            # member an uncorrected ±scale caricature of the mean. q8 is
            # the same near-exact result fidelity the q8 wire itself runs on
            # (per-chunk scales, idempotent round-trip), at 1/4 the f32
            # bytes — so the sign wire's fetch leg matches the q8 wire and
            # its push leg is 32x. Tagged with its own magic: raw q8 starts
            # with a u64 count whose low bytes CAN collide with SIGN_MAGIC
            # for unlucky model sizes (n % 2^24 == 0x314753), so the two
            # legs must be distinguishable by construction, not probability.
            return _SIGN_RESULT_MAGIC + native.q8_encode(buf)
        return buf.tobytes()

    def _compress_contribution(
        self, buf: np.ndarray
    ) -> Tuple[bytes, Callable[[], np.ndarray]]:
        """(wire bytes, lazy dense-as-peers-see-it) for THIS round's
        contribution.

        For topk: add the error-feedback residual, keep the top k entries,
        and stage the remainder as PENDING — the caller commits it via
        ``_commit_ef(ok)`` once the round's outcome is known. For every other
        codec this is (_to_wire, lazy decode of the same bytes); the dense
        view is lazy because sync members never need it — only the leader
        and the byzantine path stack their own contribution.

        The f32/bf16 wires return a StreamPayload instead of bytes when the
        payload is big: chunks are encoded lazily while the transport is
        already writing earlier chunks (encode/send overlap), and the
        factory re-iterates for the byzantine full-mesh fan-out (one lazy
        encoding per push, none of them materializing the whole buffer)."""
        if self.wire not in ("topk", "powersgd", "sign"):
            self._note_codec_distortion(buf)
            if self.wire == "f32":
                return self._wire_stream(buf), lambda: buf
            if self.wire == "bf16":
                # Dense view via the roundtrip helper, not the wire bytes —
                # the wire may be a lazy stream that is never materialized.
                return self._wire_stream(buf), lambda: self._wire_roundtrip(buf)
            wire = self._to_wire(buf)
            return wire, lambda: self._buf_from_payload(wire)
        # Lossy-truncation codecs share the error-feedback protocol: add the
        # banked residual, truncate, stage (buf - sent) as PENDING until the
        # round's outcome commits or discards it (_commit_ef).
        if self._ef_residual is not None and self._ef_residual.size == buf.size:
            buf = buf + self._ef_residual
        if self.wire == "powersgd":
            from distributedvolunteercomputing_tpu_torch.swarm import powersgd

            wire = self._psgd().encode(buf)
            # Own round-trip: the exact size is known — don't let the
            # anti-abuse default cap reject a legitimately huge model.
            sent = powersgd.decode(
                wire, max_floats=buf.size, mesh_codec=self.mesh_codec
            )
        elif self.wire == "sign":
            wire = native.sign_encode(buf)
            sent = native.sign_decode(wire, max_floats=buf.size)
        else:
            wire = native.topk_encode(buf, frac=self._effective_topk_frac())
            # Own round-trip: exact size known — same anti-abuse-cap
            # exemption as the powersgd branch above.
            sent = native.topk_decode(wire, max_floats=buf.size)
        self._ef_pending = buf - sent
        self._note_codec_distortion(buf, residual=self._ef_pending)
        return wire, lambda: sent

    def _note_codec_distortion(
        self, buf: np.ndarray, residual: Optional[np.ndarray] = None
    ) -> None:
        """Per-round relative compression error for the configured wire
        (training-health layer): the EF-residual norm over the gradient
        norm on the lossy wires — exactly the mass error feedback
        re-stages — and a sampled round-trip estimate on bf16/q8 (f32 is
        exact). The raw material for ranking wire formats by
        convergence-per-byte (ROADMAP item 1)."""
        h = self.health
        if h is None or not h.enabled:
            return
        try:
            if residual is not None:
                den = float(np.linalg.norm(buf))
                rel = float(np.linalg.norm(residual)) / den if den > 0 else 0.0
                h.note_codec_error(self.wire, rel)
                return
            if self.wire == "f32":
                h.note_codec_error("f32", 0.0)
                if self.controller is not None:
                    # Prospective bf16 sample: the controller's f32->bf16
                    # flip is gated on MEASURED bf16 distortion, which a
                    # fleet running f32 would otherwise never produce
                    # (the gauge only samples the active wire). One
                    # 64Ki-slice round-trip per round is the cheap probe
                    # that keeps the flip reachable.
                    p = buf[: min(buf.size, 65_536)]
                    mc = self.mesh_codec
                    prt = mc.decode_bf16(mc.encode_bf16(p))
                    pden = float(np.linalg.norm(p))
                    h.note_codec_error(
                        "bf16",
                        float(np.linalg.norm(prt - p)) / pden if pden > 0 else 0.0,
                    )
                return
            s = buf[: min(buf.size, 65_536)]
            if self.wire == "bf16":
                mc = self.mesh_codec
                rt = mc.decode_bf16(mc.encode_bf16(s))
            elif self.wire == "q8":
                rt = native.q8_decode(native.q8_encode(s))
            else:
                return
            den = float(np.linalg.norm(s))
            rel = float(np.linalg.norm(rt - s)) / den if den > 0 else 0.0
            h.note_codec_error(self.wire, rel)
        except Exception as e:  # noqa: BLE001 — a gauge bug must not fail the encode
            log.debug("codec distortion gauge failed: %s", errstr(e))

    def _robust_kw(self, n_peers: int, method: Optional[str] = None) -> dict:
        """Estimator kwargs adjusted to THIS round's group size — shared by
        the sync and byzantine aggregation paths so neither can regress to
        an unprotected (or crashing) state the other guards against:

        - explicit trim is clamped (with a warning) to the most robustness
          the group admits — never silently zeroed;
        - the DERIVED trim is len//4 floored at 1 once n >= 3: trim=0 under
          a robust method's name is a plain mean that includes an attacker
          at full weight (r5 review — len//4 alone was 0 for the 3..7-peer
          groups real churn produces; n=3 with trim=1 degenerates to the
          coordinate median, strictly more robust);
        - n=2 can't trim at all: trim=0 beats a ValueError killing every
          round (the sync path used to pass the function default trim=1
          straight through — a 2-peer trimmed_mean swarm failed forever)."""
        method = self.method if method is None else method
        kw = dict(self.method_kw) if method == self.method else {}
        if method != "trimmed_mean":
            return kw
        if "trim" in kw:
            trim = int(kw["trim"])
            if trim * 2 >= n_peers:
                feasible = (n_peers - 1) // 2
                log.warning(
                    "trimmed_mean trim=%d infeasible for %d peers; "
                    "clamping to %d this round", trim, n_peers, feasible,
                )
                kw["trim"] = feasible
        else:
            kw["trim"] = max(1, n_peers // 4) if n_peers >= 3 else 0
        return kw

    def _effective_topk_frac(self) -> float:
        """Current kept fraction under the warmup schedule (see __init__);
        the configured topk_frac once warmup completes or when disabled."""
        n = self.topk_warmup_rounds
        if n <= 0 or self.rounds_ok >= n:
            return self.topk_frac
        return float(self.topk_frac ** (self.rounds_ok / n))

    def _commit_ef(self, ok: bool) -> None:
        """Resolve the staged error-feedback residual for the last
        compressed contribution: on success the remainder is banked for the
        next round; on failure the PREVIOUS residual stands (nothing was
        delivered, and the trainer applies its raw local grad instead)."""
        if self._ef_pending is not None:
            if ok:
                self._ef_residual = self._ef_pending
            self._ef_pending = None

    def _wire_roundtrip(self, buf: np.ndarray) -> np.ndarray:
        """The local buffer as PEERS see it after the wire codec. Pairwise
        protocols (butterfly) mix this instead of the raw f32 buffer so both
        sides of a pair operate on identical inputs; idempotent for every
        codec (a round-trip of already-codec'd values is exact: bf16 by
        representability, q8 because the per-chunk scale reconstructs)."""
        if self.wire == "bf16":
            mc = self.mesh_codec
            return mc.decode_bf16(mc.encode_bf16(buf))
        if self.wire == "q8":
            return native.q8_decode(native.q8_encode(buf))
        if self.wire == "topk":
            return native.topk_decode(native.topk_encode(buf), max_floats=buf.size)
        # powersgd: pairwise modes are refused at construction; the only
        # non-contribution sends are dense-container results, an exact
        # round-trip — so the raw buffer IS the as-peers-see-it view.
        return buf

    def _buf_from_payload(self, payload: bytes) -> Optional[np.ndarray]:
        if self.wire == "bf16":
            return self.mesh_codec.decode_bf16(np.frombuffer(payload, np.uint16))
        if self.wire == "q8":
            return native.q8_decode(payload)
        if self.wire == "topk":
            # Same deferral story as powersgd below: the sparse header's n is
            # sender-controlled, so pre-schema the decode is unbounded —
            # park raw and resolve at aggregation; post-schema, cap at the
            # exact expected size.
            if self._specs is None:
                return None
            return native.topk_decode(
                payload, max_floats=sum(s.size for s in self._specs)
            )
        if self.wire == "sign":
            if payload[:3] == native.SIGN_MAGIC:
                # A 1-bit contribution: n is sender-controlled and expands
                # 32x on decode — same pre-schema deferral as topk below.
                if self._specs is None:
                    return None
                return native.sign_decode(
                    payload, max_floats=sum(s.size for s in self._specs)
                )
            if payload[:3] == _SIGN_RESULT_MAGIC:
                # Round RESULT leg: tagged q8 (see _to_wire) — linear 4x
                # expansion, bounded by the payload's own size, no deferral.
                return native.q8_decode(payload[3:])
            raise ValueError("sign-wire payload with unknown leg tag")
        if self.wire == "powersgd":
            # Self-describing container (low-rank contributions AND dense
            # results). The decode is capped at EXACTLY the expected size —
            # a low-rank entry expands (n+m)*r wire floats to n*m, so
            # without the cap a few-KB container could buy a multi-GB
            # allocation. Before our first _pack the expected size is
            # unknown and no generic cap is safe (r4 advisor: 64 parked
            # contribs x 32 rounds x 2 GiB decodes = multi-TiB amplification
            # from MBs of attacker bandwidth) — so pre-schema pushes are NOT
            # decoded here: return the deferred sentinel, park the raw
            # payload (memory then costs the attacker its own bandwidth,
            # bounded by transport MAX_PAYLOAD), and decode at aggregation
            # time when specs exist (see _decode_deferred).
            if self._specs is None:
                return None
            from distributedvolunteercomputing_tpu_torch.swarm import powersgd

            return powersgd.decode(
                payload, max_floats=sum(s.size for s in self._specs),
                mesh_codec=self.mesh_codec,
            )
        return np.frombuffer(payload, np.float32).copy()

    # -- off-loop wrappers for payload-sized work --------------------------
    # Flatten/codec/aggregate over a full param tree is seconds of CPU at
    # GPT-2 scale (measured: q8 of the 498 MB tree ~2.6 s). Run synchronously
    # it stalls the event loop — heartbeats, DHT RPCs, and matchmaking
    # begins all miss their (5 s) deadlines, failing rounds that would
    # otherwise succeed. Same policy as state_sync's _serialize: the loop
    # schedules, worker threads move bytes. Per-averager work stays serial
    # (one average() at a time); RPC-path decodes may run concurrently on
    # distinct payloads, so callers must re-check insert conditions after
    # the await (the loop may have run other handlers meanwhile).

    async def _pack_and_compress(self, tree: Any):
        """(buf, wire_bytes, dense_fn) off the event loop."""

        def work():
            buf = self._pack(tree)
            wire, sent = self._compress_contribution(buf)
            return buf, wire, sent

        return await asyncio.to_thread(work)

    async def _decode_payload(self, payload: bytes) -> Optional[np.ndarray]:
        return await asyncio.to_thread(self._buf_from_payload, payload)

    async def _decode_deferred(self, st: "_Round") -> None:
        """Decode contributions parked BEFORE this node's first ``_pack``
        (powersgd only: ``_buf_from_payload`` defers pre-schema decodes and
        the contribute handlers park the raw payload instead). Runs on the
        aggregation path, where specs are guaranteed — the caller just
        packed its own contribution — so every decode is capped at exactly
        the expected dense size. Entries whose payload is missing or fails
        to decode are dropped, the same fate a size-mismatched buffer meets
        at aggregation."""
        deferred = [k for k, c in st.contribs.items() if c[1] is None]
        for k in deferred:
            pl = st.payloads.get(k)
            buf = None
            if pl is not None:
                try:
                    buf = await self._decode_payload(pl)
                except (ValueError, RPCError):
                    buf = None
            if buf is None:
                st.contribs.pop(k, None)
                st.payloads.pop(k, None)
            elif k in st.contribs:  # re-check: handlers ran during decode
                st.contribs[k] = (st.contribs[k][0], buf)

    async def _encode_wire(self, buf: np.ndarray) -> bytes:
        return await asyncio.to_thread(self._to_wire, buf)

    def _wire_stream(self, buf: np.ndarray):
        """Wire form of ``buf`` as a lazily-encoded StreamPayload when the
        codec is elementwise (f32/bf16: encoding a slice == slice of the
        encoding) and the payload is big enough to chunk. The transport
        pulls each chunk on a worker thread while the previous chunk is
        already on the socket — encode/send overlap — instead of paying a
        full encode before the first byte moves. Other codecs (q8's
        scales-then-data layout, the sparse/low-rank containers) are not
        slice-concatenable and return whole bytes, which the transport
        still chunk-frames on the wire."""
        cb = self.transport.chunk_bytes
        if self.wire == "f32" and buf.nbytes > cb:
            step = cb // 4

            def gen(b=buf, step=step):
                for i in range(0, b.size, step):
                    yield b[i : i + step].tobytes()

            return StreamPayload(buf.size * 4, gen)
        if self.wire == "bf16" and buf.size * 2 > cb:
            step = cb // 2

            def gen(b=buf, step=step):
                mc = self.mesh_codec
                if mc.active:
                    # One whole-buffer device encode, chunks sliced from the
                    # result: the pack is 4-5x the per-chunk host encode, so
                    # paying it up front still beats the chunk cadence, and
                    # the first chunk is ready after one kernel.
                    bits = mc.encode_bf16(b)
                    for i in range(0, bits.size, step):
                        yield bits[i : i + step].tobytes()
                    return
                for i in range(0, b.size, step):
                    yield native.f32_to_bf16(b[i : i + step]).tobytes()

            return StreamPayload(buf.size * 2, gen)
        return self._to_wire(buf)

    async def _encode_wire_stream(self, buf: np.ndarray):
        """``_encode_wire`` that prefers the lazy stream: cheap closure
        creation for f32/bf16 (the encode itself happens chunk-by-chunk off
        the loop during the write), full off-loop encode otherwise."""
        if self.wire in ("f32", "bf16"):
            return self._wire_stream(buf)
        return await self._encode_wire(buf)

    def _result_sink(self):
        """(sink, state) for decode-on-arrival of a round-result fetch on
        the f32/bf16 wires: each verified chunk lands straight in the final
        f32 buffer (f32: a byte copy; bf16: the native widening) while later
        chunks are still in flight — fetch-side decode starts on the FIRST
        chunk, and the full payload is never held as a separate byte
        buffer. Returns (None, None) when the wire or schema doesn't allow
        it; the caller then falls back to the plain payload decode."""
        if self.wire not in ("f32", "bf16") or self._specs is None:
            return None, None
        n = sum(s.size for s in self._specs)
        esz = 4 if self.wire == "f32" else 2
        expect = n * esz
        state: dict = {"filled": 0, "out": None, "expect": expect}
        wire = self.wire

        def sink(off: int, total: int, data: bytes) -> None:
            # Raising rejects the payload at the transport (the call fails
            # with an RPCError; the connection survives) — the same fate a
            # wrong-size result meets in the buffered decode path.
            if total != expect:
                raise ValueError(f"result payload {total}B != schema {expect}B")
            if off % esz or len(data) % esz:
                raise ValueError("result chunk not element-aligned")
            out = state["out"]
            if out is None:
                out = state["out"] = np.empty(n, np.float32)
            if wire == "f32":
                out.view(np.uint8)[off : off + len(data)] = np.frombuffer(
                    data, np.uint8
                )
            else:
                out[off // 2 : (off + len(data)) // 2] = native.bf16_to_f32(
                    np.frombuffer(data, np.uint16)
                )
            state["filled"] += len(data)

        def reset() -> None:
            # The transport's transparent retry re-delivers the response
            # from offset 0: forget anything the dead stream handed us.
            state["filled"] = 0

        sink.reset = reset
        return sink, state

    # -- public API --------------------------------------------------------

    async def average(self, tree: Any, round_no: int, weight: float = 1.0) -> Optional[Any]:
        raise NotImplementedError

    def stats(self) -> dict:
        out = {
            "mode": self.mode,
            "rounds_ok": self.rounds_ok,
            "rounds_skipped": self.rounds_skipped,
            "rounds_degraded": self.rounds_degraded,
            # Per-peer transport counters (bytes in/out, RPC count, connect
            # count, latency EWMA): the WAN-tier evidence operators and
            # experiments read off the volunteer summary.
            "transport": self.transport.stats(),
            # Which data-path backend this volunteer selected at startup
            # (mesh = codec+folds on the local device mesh; host = numpy),
            # plus degrade evidence — the per-volunteer selection the
            # ROADMAP item calls for.
            "mesh_codec": self.mesh_codec.stats(),
        }
        if self._agg_gauges:
            out["aggregation"] = dict(self._agg_gauges)
        if self.group_schedule is not None:
            out["groups"] = self.group_stats()
        if self.resilience is not None:
            out["resilience"] = self.resilience.stats()
        if self.controller is not None:
            out["controller"] = self.controller.summary()
        # Control-plane accounting: messages this node spends per heartbeat
        # interval (the batching headline metric) plus the failover
        # client's replica view — proves the batched path is actually in
        # use and shows where traffic fails over during replica churn.
        cp_stats = self.membership.stats() if hasattr(self.membership, "stats") else None
        if cp_stats is not None and (
            cp_stats.get("beats") or self.control_plane is not None
        ):
            out["control_plane"] = cp_stats
        if self.hedges_issued or self.slots_recovered or self.redund_decodes:
            # Tail-optimal recovery scorecard (cumulative, leader vantage):
            # per-round detail lives in aggregation gauges + mass reports.
            out["hedge"] = {
                "enabled": self.hedge,
                "issued": self.hedges_issued,
                "failed": self.hedges_failed,
                "slots_recovered": self.slots_recovered,
                "redund_decodes": self.redund_decodes,
            }
        out["telemetry"] = self.telemetry.summary()
        # SNAPSHOT semantics: several sub-dicts above are filled in place by
        # background work (round paths, the aggregation worker, heartbeat
        # loops), and before this deep-copy a held stats() reference kept
        # mutating under the reader — a bench could record one number and
        # report another. A stats() return is now frozen at read time.
        return copy.deepcopy(out)

    def _note_agg_round(self, stream: Optional[StreamingAggregator]) -> None:
        """Roll one led round's streaming-aggregation gauges into the
        cumulative counters behind ``stats()['aggregation']``."""
        if stream is None:
            return
        g = stream.gauges()
        agg = self._agg_gauges
        agg["mode"] = g["mode"]
        agg["rounds_streamed"] = agg.get("rounds_streamed", 0) + 1
        agg["peak_bytes_held"] = max(agg.get("peak_bytes_held", 0), g["peak_bytes_held"])
        for k in (
            "tiles_early", "tiles_deadline", "streamed_contribs",
            "dense_contribs", "aborted_contribs", "folder_flushes",
            "tiles_recovered", "hedge_duplicates", "hedge_dropped",
        ):
            agg[k] = agg.get(k, 0) + g[k]
        agg["ring_flushes"] = agg.get("ring_flushes", 0) + g.get("ring_flushes", 0)
        if g.get("folder_kind"):
            agg["folder_kind"] = g["folder_kind"]
        agg["codec_backend"] = g["codec_backend"]
        agg["agg_busy_s"] = round(agg.get("agg_busy_s", 0.0) + g["agg_busy_s"], 6)
        agg["last_busy_frac"] = g["agg_busy_frac"]


class SyncAverager(AveragerBase):
    """Leader-gather allreduce: members push, leader aggregates, members fetch.

    The inter-slice half of the synchronous GradientAverager (config 2). At
    reference swarm scale (2-8 slices) a leader-gather round is one RTT
    cheaper than a ring and churn-safe on both sides: missing contributions
    are dropped at the deadline, and a DEAD LEADER is deposed mid-round —
    the deterministic successor re-leads a fenced recovery round over the
    same retained contributions (generation bump on the epoch), so one
    crashed volunteer costs the group its contribution, not everyone's
    streamed work (see the module doc's leader-failover section).
    """

    mode = "sync"

    # Longest a member waits for a successor's recovery begin after
    # deposing the leader. The successor detects the same death on its own
    # push/fetch leg, so the lag between depositions is connection-error
    # scale (seconds), not deadline scale.
    RECOVERY_BEGIN_WAIT_S = 6.0
    # TTL for a recovery begin that arrived before its member started
    # waiting (the successor can depose faster than a slow member).
    RECOVER_PARKED_TTL_S = 8.0
    # Fencing generations accepted per epoch: one original round plus a
    # bounded failover chain — a runaway (or malicious) recovery cascade
    # stops here.
    MAX_RECOVERY_GEN = 3
    # Bound on per-epoch generation records a remote peer can allocate.
    MAX_EPOCH_GENS = 256

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._rounds: Dict[str, _Round] = {}
        self.transport.register("sync.contribute", self._rpc_contribute)
        self.transport.register("sync.fetch", self._rpc_fetch)
        # Leader-failover recovery plumbing: recovery begins land here
        # (future when a member is already waiting, parked otherwise —
        # the matchmaking begin pattern), and _epoch_gen fences each epoch
        # at the highest generation this node accepted.
        self.transport.register("sync.recover", self._rpc_recover)
        self._recover_futs: Dict[str, asyncio.Future] = {}
        self._recover_parked: Dict[str, Tuple[float, dict]] = {}
        self._epoch_gen: Dict[str, Tuple[float, int]] = {}
        # Failover observability (stats()["failover"], volunteer report,
        # coord.status): depositions this node decided, rounds whose result
        # arrived via a recovery generation, failed recovery attempts, and
        # deposition->recovered-result latency.
        self.leaders_deposed = 0
        self.rounds_recovered = 0
        self.recoveries_failed = 0
        self._recovery_lat_last: Optional[float] = None
        self._recovery_lat_ewma: Optional[float] = None
        # Test/chaos instrumentation: named leader-round phase points fire
        # these hooks (chaos campaigns kill/partition the leader at exact
        # protocol points) and honor DVC_CHAOS_LEADER_DIE_PHASE (subprocess
        # e2e: the leader SIGKILLs itself at the named phase). Production
        # leaves both empty/unset.
        self._phase_hooks: Dict[str, Callable[[], Any]] = {}
        # Streaming leader aggregation: chunked contribute payloads decode
        # and fold into the round's aggregator AS THEY ARRIVE instead of
        # buffering per-peer dense vectors (swarm/agg_stream.py).
        self.transport.register_request_sink(
            "sync.contribute", self._contribute_stream_factory
        )
        # Tail-optimal hedged recovery plumbing. sync.refetch serves tile
        # RANGES of a member's retained (PR-4) contribution back to the
        # round leader over a second stream — re-encoded from the retained
        # dense form, bit-identical for the elementwise wires, so EF can
        # never double-stage. sync.redund_share / sync.redund carry the
        # optional summand-redundancy sidecars (ring neighbor's last-k%
        # tiles, XOR-coded).
        self.transport.register("sync.refetch", self._rpc_refetch)
        self.transport.register("sync.redund_share", self._rpc_redund_share)
        self.transport.register("sync.redund", self._rpc_redund)
        # epoch -> {"gen", "token", "buf" (dense f32), "weight", "group"}:
        # the member-side registry behind sync.refetch, set around the
        # push/fetch leg and dropped when the round resolves.
        self._push_retained: Dict[str, dict] = {}
        # (epoch, pred peer) -> (mono, weight, t0 tile, tail bytes,
        # fence): ring neighbors' redundancy shares, stashed until our
        # own round state for that epoch exists (then XOR-coded to the
        # leader), and retained as the replica-holder refetch source
        # (served by fence+share alone when our own retention is gone).
        self._redund_shares: Dict[Tuple[str, str], tuple] = {}

    # The four instrumented leader-round phases, in protocol order (the
    # kill-at-phase chaos matrix iterates these).
    LEADER_PHASES = ("pre_arm", "mid_stream", "post_partial_commit", "pre_fetch")

    def _phase_armed(self, name: str) -> bool:
        return (
            name in self._phase_hooks
            or os.environ.get("DVC_CHAOS_LEADER_DIE_PHASE") == name
        )

    async def _phase(self, name: str) -> None:
        """Fire the instrumentation hook for a leader-round phase point.
        No-op in production (no hooks registered, env unset)."""
        hook = self._phase_hooks.get(name)
        if hook is not None:
            res = hook()
            if asyncio.iscoroutine(res):
                await res
        if os.environ.get("DVC_CHAOS_LEADER_DIE_PHASE") == name:
            # Subprocess e2e chaos: die EXACTLY like a preempted/crashed
            # volunteer — no cleanup, no tombstone, sockets reset by the
            # kernel. Test-only; unset in production.
            log.warning("chaos: leader dying at phase %r (SIGKILL)", name)
            os.kill(os.getpid(), signal.SIGKILL)

    def failover_stats(self) -> dict:
        return {
            "leaders_deposed": self.leaders_deposed,
            "rounds_recovered": self.rounds_recovered,
            "recoveries_failed": self.recoveries_failed,
            "recovery_latency_s_last": (
                round(self._recovery_lat_last, 3)
                if self._recovery_lat_last is not None else None
            ),
            "recovery_latency_s_ewma": (
                round(self._recovery_lat_ewma, 3)
                if self._recovery_lat_ewma is not None else None
            ),
        }

    def stats(self) -> dict:
        out = super().stats()
        out["failover"] = self.failover_stats()
        return out

    def _contribute_stream_factory(self, args: dict, total: int):
        """Per-request sink for a member's chunked contribution, or None to
        buffer normally. Only an ARMED round streams (the leader entered it:
        tokens and aggregator exist) — pre-arming pushes park as before, and
        every condition a streamed push skips here is re-checked the same
        way the buffered handler would have checked it."""
        if self.wire not in ("f32", "bf16"):
            return None
        epoch = args.get("epoch")
        st = self._rounds.get(epoch) if isinstance(epoch, str) else None
        if st is None or st.stream is None or st.result_ready.is_set():
            return None
        if self._fence_of(args) != st.gen:
            return None  # stale generation: the buffered handler rejects it loudly
        if not self._check_schema(args):
            return None
        peer = args.get("peer")
        token = args.get("token", "")
        key = (peer, token)
        if st.tokens is None or not peer or st.tokens.get(peer) != token:
            return None  # forgery: the buffered handler rejects it loudly
        if key in st.contribs or key in st.stream_done:
            return None  # duplicate/retry: idempotent ack via the handler
        try:
            weight = float(args.get("weight"))
        except (TypeError, ValueError):
            return None

        def on_done(ok: bool) -> None:
            if ok:
                # Sealed BEFORE the handler task runs (the transport closes
                # the sink while still reading the frame), so the handler —
                # and a commit racing it — can adopt the entry.
                st.stream_done[key] = weight

        return st.stream.make_sink(peer, weight, total, on_done=on_done)

    @staticmethod
    def _fence_of(args: dict) -> int:
        """The fencing generation a request carries (0 for legacy/original
        traffic; malformed values read as -1, matching no round)."""
        fence = args.get("fence", 0)
        try:
            return int(fence)
        except (TypeError, ValueError):
            return -1

    def _note_fence_rejected(self, rpc: str, args: dict, have_gen: int) -> None:
        """Flight-record + count one fenced-off request: the post-mortem
        evidence a chaos verdict wants when stale traffic was refused."""
        if not self.telemetry.enabled:
            return  # --no-telemetry: every record path is a no-op
        self.telemetry.event(
            "fence_rejected",
            rpc=rpc,
            epoch=str(args.get("epoch", "?")),
            have_gen=have_gen,
            got_gen=self._fence_of(args),
            peer_from=str(args.get("peer", "?")),
        )
        self.telemetry.registry.counter(
            "swarm.fences_rejected_total", "stale-generation requests refused"
        ).inc(rpc=rpc)

    async def _rpc_contribute(self, args: dict, payload: bytes):
        # Handler-side span: the member's push carried its round trace in
        # the frame meta, so this span stitches into the member's tree —
        # the leader-side evidence of where a push's bytes went. Wrapped
        # here (not inline) so REJECTED pushes record too: the error paths
        # are exactly what a post-mortem wants timed.
        push_sp = self.telemetry.tracer.start(
            "fold.push", role="leader", peer_from=str(args.get("peer", "?"))
        )
        try:
            ret = await self._contribute_inner(args, payload)
        except BaseException:
            if push_sp is not None:
                push_sp.end(ok=False)
            raise
        if push_sp is not None:
            push_sp.end(ok=True)
        return ret

    async def _contribute_inner(self, args: dict, payload: bytes):
        if not self._check_schema(args):
            raise RPCError("schema mismatch")
        # Members can push before the leader enters its round: park it
        # (swept + capped against fabricated-epoch flooding).
        st = self._get_or_park_round(self._rounds, args["epoch"])
        if st.tokens is not None and self._fence_of(args) != st.gen:
            # Epoch fencing: this (armed) round state serves generation
            # st.gen; a push stamped with any other generation is a stale
            # member (or a deposed ex-leader's relayed traffic) and must
            # not mix into this round. Unarmed (parked) rounds skip the
            # check — their entries are re-filtered against the token
            # table at arming anyway.
            self._note_fence_rejected(
                "sync.contribute", args, have_gen=st.gen
            )
            raise RPCError(
                f"fencing mismatch: round epoch is at generation {st.gen}, "
                f"push carries {self._fence_of(args)} (deposed/stale)"
            )
        # Keyed by (peer, token): a push can neither OVERWRITE another entry
        # (no displacement of an honest contribution by a later forgery) nor
        # PRE-BLOCK one (an early forgery under peer P doesn't stop P's real
        # push landing under its correct token). At aggregation the leader
        # keeps only the entry whose token it actually issued to that peer.
        key = (args["peer"], args.get("token", ""))
        if (
            st.result_ready.is_set()
            and self.resilience is not None
            and st.tokens is not None
            and st.tokens.get(key[0]) == key[1]
            # Only for the MOST RECENT round this leader scored: round state
            # outlives its commit by the fetch window, and a push for an
            # older epoch already had its miss counted (absent) at that
            # round's own flush — reporting it late now would double-count
            # one slow round against whatever the peer did since.
            and args.get("epoch") == self._last_outcomes_epoch
        ):
            # Authentic contribution from an expected member, landing AFTER
            # the deadline committed the round: the definition of LATE (the
            # absent set at commit only proves non-arrival; this proves the
            # peer was alive but slow — exactly what the policy tracks).
            self.resilience.record_late_arrival(key[0])
        if st.tokens is not None and st.tokens.get(key[0]) != key[1]:
            # Leader has entered the round, so the issued-token table is
            # known: reject forgeries OUTRIGHT rather than parking them —
            # otherwise 64 fabricated keys fill the cap and pre-block every
            # honest push for the rest of the round.
            raise RPCError("invalid contribution token for this round")
        if key in st.stream_done:
            # The transport's request sink already decoded and folded this
            # push chunk-by-chunk as it arrived (streaming aggregation):
            # record the contribution without a dense copy — there is none.
            st.contribs.setdefault(key, (st.stream_done[key], STREAMED))
            if st.expected and {
                p for p, t in st.contribs
                if (st.tokens is None or st.tokens.get(p) == t) and (p, t) not in st.feeding
            } >= st.expected:
                st.full.set()
            return {"ok": True}, b""
        if st.stream is not None and st.stream.taints(key[0]):
            # An earlier streamed push under this key died AFTER committing
            # tiles into the aggregate; a replacement can't enter the round
            # coherently (its sealed tiles already count, per-tile).
            raise RPCError(
                "contribution partially streamed into committed tiles; "
                "peer sits this round out"
            )
        if key not in st.contribs and len(st.contribs) >= self.MAX_PARKED_CONTRIBS:
            raise RPCError("round contribution cap reached")
        buf = await self._decode_payload(payload)
        # Re-check after the await (other handlers ran while we decoded):
        # a same-key entry landed -> idempotent ack without overwriting
        # (first write wins, retries succeed); cap reached -> refuse.
        if key not in st.contribs:
            if len(st.contribs) >= self.MAX_PARKED_CONTRIBS:
                raise RPCError("round contribution cap reached")
            st.contribs[key] = (float(args["weight"]), buf)
            if (self.wire == "powersgd" and self.method == "mean") or buf is None:
                # Keep the compressed form too: for powersgd+mean the leader
                # serves the round result as the exact factored mean of
                # these (see _Round); for a pre-schema deferred decode
                # (buf None — powersgd or topk) the raw payload IS the
                # contribution until _decode_deferred resolves it at
                # aggregation time.
                st.payloads[key] = payload
            elif (
                st.stream is not None
                and buf is not None
                and buf.size == st.stream.n_elems
                and st.tokens is not None
                and st.tokens.get(key[0]) == key[1]
            ):
                # Round is armed but this payload rode inline (sub-chunk) or
                # the sink declined: fold the dense buffer into the stream
                # and drop the copy — the aggregator owns that mass now. A
                # feed refused (frozen round, tainted slot) keeps the dense
                # entry, which the commit then ignores as late.
                w = float(args["weight"])
                st.feeding.add(key)
                try:
                    fed = await asyncio.to_thread(st.stream.add_dense, key[0], w, buf)
                finally:
                    st.feeding.discard(key)
                if fed and st.contribs.get(key, (None, None))[1] is buf:
                    st.contribs[key] = (w, STREAMED)
        if st.expected:
            valid = {
                p for p, t in st.contribs
                if (st.tokens is None or st.tokens.get(p) == t) and (p, t) not in st.feeding
            }
            if valid >= st.expected:
                st.full.set()
        return {"ok": True}, b""

    # Extra wait beyond the gather deadline for the leader's OFF-LOOP
    # aggregation + encode to land: with aggregation on a worker thread the
    # member-side timers now actually fire on schedule, so the old +3s
    # margin expired mid-aggregation at param scale.
    AGGREGATION_HEADROOM = 30.0

    async def _rpc_fetch(self, args: dict, payload: bytes):
        st = self._rounds.get(args["epoch"])
        if st is None:
            raise RPCError("unknown or finished round epoch")
        if st.tokens is not None and self._fence_of(args) != st.gen:
            # Epoch fencing, BEFORE parking on result_ready: a revived
            # ex-leader (this node, if it was partitioned and healed) must
            # refuse to serve its stale generation-(st.gen) result to a
            # member that has moved on — and refuse fast, not after the
            # gather-deadline wait below. Unarmed (parked) rounds skip the
            # check, as in the contribute handler: a recovery successor
            # parks its followers' pushes and fetches before it arms at
            # their generation.
            self._note_fence_rejected("sync.fetch", args, have_gen=st.gen)
            raise RPCError(
                f"fencing mismatch: round epoch is at generation {st.gen}, "
                f"fetch asks for {self._fence_of(args)} (leader deposed?)"
            )
        # Must outwait the leader's own gather deadline plus its off-loop
        # aggregation, or a member's fetch races the result and loses.
        await asyncio.wait_for(
            st.result_ready.wait(),
            timeout=self.gather_timeout + self.AGGREGATION_HEADROOM,
        )
        if self._fence_of(args) != st.gen:
            # A fetch parked on an unarmed round: its generation is known now.
            self._note_fence_rejected("sync.fetch", args, have_gen=st.gen)
            raise RPCError(
                f"fencing mismatch: round epoch is at generation {st.gen}, "
                f"fetch asks for {self._fence_of(args)} (leader deposed?)"
            )
        if st.result is None:
            raise RPCError("round skipped by leader (too few contributions)")
        # result_wire is encoded ONCE when the result lands (n members
        # fetching must not cost n identical codec passes).
        return (
            {"ok": True, "included": st.included, "excluded": st.excluded},
            st.result_wire,
        )

    # -- tail-optimal hedged recovery ---------------------------------------
    #
    # The leader's soft-deadline pipeline (ROADMAP item 2 / OptiReduce):
    # ahead of the round deadline, peers whose remaining tiles are
    # predicted late (phi-accrual suspicion, transport latency/bandwidth
    # EWMAs, stalled-stream age) get their missing tile ranges re-requested
    # over a second stream — first from the straggler's own retained bytes
    # (sync.refetch), then, when summand redundancy is on, from the ring
    # successor holding the straggler's XOR-coded tail. Duplicate arrivals
    # are idempotent by (peer, tile, fence) in the aggregator, so a hedge
    # and the original can never double-fold.

    REDUND_SHARE_TTL_S = 60.0
    MAX_REDUND_SHARES = 128
    # Hedged re-requests per straggler per round. Each attempt runs under
    # a SHORT per-attempt timeout (a fraction of the round budget, not
    # the whole remainder): tail latency is per-request, so a hedge that
    # itself straggles is cancelled and re-drawn instead of squatting on
    # the in-flight budget until the deadline.
    HEDGE_MAX_PER_PEER = 3
    HEDGE_ATTEMPT_FRAC = 0.35
    HEDGE_POLL_S = 0.2

    def _wire_geometry(self, n_elems: int) -> Tuple[int, int, int, int]:
        """(element size, chunk bytes, tile elems, n tiles) for this wire
        — delegated to agg_stream.wire_geometry, the tiling rule's one
        home, so refetch/sidecar tile addressing can never drift from the
        aggregator's bitmap."""
        return agg_wire_geometry(self.wire, self.transport.chunk_bytes, n_elems)

    def _redund_tiles(self, n_tiles: int) -> int:
        """Tail tiles covered by summand redundancy (0 = off)."""
        if not self.tail_redundancy_frac or self.wire not in ("f32", "bf16"):
            return 0
        return min(n_tiles, max(1, int(round(self.tail_redundancy_frac * n_tiles))))

    def _encode_range(self, buf: np.ndarray, e0: int, e1: int) -> bytes:
        """Element range -> wire bytes, bit-identical to the original
        push's encoding (f32/bf16 are elementwise, so a slice of the
        encoding IS the encoding of the slice; bf16 re-encode of the
        retained f32 form is exact — no second EF staging). One shared
        encoder (agg_stream.encode_wire_elems) guards that invariant."""
        if self.wire == "bf16" and self.mesh_codec.active:
            # The push's own encoder: a device codec's pushes are K4's bits
            # (canonical NaNs), which the host encoder does not reproduce.
            return self.mesh_codec.encode_bf16(np.ascontiguousarray(buf[e0:e1], np.float32)).tobytes()
        return encode_wire_elems(self.wire, buf[e0:e1])

    async def _rpc_refetch(self, args: dict, payload: bytes):
        """Serve a tile range of a retained contribution back to a round
        leader: our OWN contribution (args peer == us), or — replica-holder
        mode — a ring neighbor's stashed redundancy tail. Authenticated by
        the round token the leader issued to THIS node; fenced by the
        generation the bytes were retained under."""
        epoch = args.get("epoch")
        target = args.get("peer")
        try:
            t0, t1 = int(args.get("t0", -1)), int(args.get("t1", -1))
        except (TypeError, ValueError):
            raise RPCError("malformed refetch range")
        rec = self._push_retained.get(epoch) if isinstance(epoch, str) else None
        if target == self.peer_id:
            if rec is None:
                raise RPCError("no retained contribution for this round epoch")
            if self._fence_of(args) != rec["gen"]:
                raise RPCError(
                    f"fencing mismatch: retained bytes are generation "
                    f"{rec['gen']}, refetch asks for {self._fence_of(args)}"
                )
            if rec["token"] and args.get("token") != rec["token"]:
                raise RPCError("invalid refetch token for this round")
            buf: np.ndarray = rec["buf"]
            esz, cb, tile_elems, n_tiles = self._wire_geometry(buf.size)
            if not 0 <= t0 < t1 <= n_tiles:
                raise RPCError(
                    f"refetch range [{t0}, {t1}) outside 0..{n_tiles}"
                )
            data = await asyncio.to_thread(
                self._encode_range, buf, t0 * tile_elems,
                min(t1 * tile_elems, buf.size),
            )
            return {"ok": True, "weight": rec["weight"]}, data
        # Replica-holder mode: serve the neighbor's stashed tail share.
        # Keyed on the SHARE, not this node's own round state — the whole
        # point of the replica hop is the degraded case, where this
        # node's own round may already have resolved (and dropped its
        # retention) while the leader's is still open. The share carries
        # its own fence; the token check applies when our retention is
        # still around to validate against (residual trust otherwise:
        # the predecessor explicitly shared these bytes for recovery,
        # and they are TTL'd).
        share = self._redund_shares.get((epoch, target)) if target else None
        if share is None:
            raise RPCError(f"no retained bytes for peer {target!r}")
        _, share_w, share_t0, share_bytes, share_fence = share
        if self._fence_of(args) != share_fence:
            raise RPCError(
                f"fencing mismatch: share is generation {share_fence}, "
                f"refetch asks for {self._fence_of(args)}"
            )
        if rec is not None and rec["token"] and args.get("token") != rec["token"]:
            raise RPCError("invalid refetch token for this round")
        cb = self.transport.chunk_bytes
        if t0 < share_t0 or t1 <= t0:
            raise RPCError(
                f"refetch range [{t0}, {t1}) outside share (covers {share_t0}..)"
            )
        off0 = (t0 - share_t0) * cb
        # Clamp the end to the share: the final tile is short, and the
        # leader's add_hedged enforces exact per-tile lengths anyway.
        off1 = min(len(share_bytes), (t1 - share_t0) * cb)
        if off0 >= len(share_bytes):
            raise RPCError("refetch range outside the retained share")
        return {"ok": True, "weight": share_w}, share_bytes[off0:off1]

    def _retain_push(self, group: Group, buf: np.ndarray, weight: float) -> None:
        """Register this member round's dense contribution for sync.refetch
        (and drain any parked ring-neighbor shares now that the round's
        leader/token are known)."""
        self._push_retained[group.epoch] = {
            "gen": group.gen,
            "token": group.token,
            "buf": buf,
            "weight": float(weight),
            "group": group,
        }
        if self.tail_redundancy_frac:
            for (epoch, pred) in list(self._redund_shares):
                if epoch == group.epoch:
                    self._spawn_task(self._send_sidecar(group.epoch, pred))

    def _drop_retained(self, epoch: str) -> None:
        self._push_retained.pop(epoch, None)

    def _sweep_redund_shares(self) -> None:
        now = time.monotonic()
        stale = [
            k for k, (t, *_rest) in self._redund_shares.items()
            if now - t > self.REDUND_SHARE_TTL_S
        ]
        for k in stale:
            self._redund_shares.pop(k, None)
        while len(self._redund_shares) >= self.MAX_REDUND_SHARES:
            self._redund_shares.pop(next(iter(self._redund_shares)), None)

    def _spawn_task(self, coro) -> Optional[asyncio.Task]:
        """Fire-and-forget helper task (redundancy sends): errors are
        logged, never raised — redundancy is strictly best-effort."""
        async def run():
            try:
                await coro
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — advisory path
                log.debug("tail-redundancy task failed: %s", errstr(e))
        try:
            return asyncio.get_running_loop().create_task(run())
        except RuntimeError:
            coro.close()
            return None

    async def _send_redund_share(
        self, group: Group, buf: np.ndarray, weight: float
    ) -> None:
        """Member side: ship our last-k% tiles' wire bytes to the ring
        successor, which XOR-codes them with its own tail into the
        leader-bound sidecar. Best-effort — a lost share just means no
        replica for this round."""
        esz, cb, tile_elems, n_tiles = self._wire_geometry(buf.size)
        r = self._redund_tiles(n_tiles)
        if not r:
            return
        succ = self._ring_successor(group, self.peer_id)
        if succ is None:
            return
        t0 = n_tiles - r
        tail = await asyncio.to_thread(
            self._encode_range, buf, t0 * tile_elems, buf.size
        )
        _, succ_addr = succ
        await self.transport.call(
            succ_addr, "sync.redund_share",
            {
                "epoch": group.epoch, "peer": self.peer_id,
                "weight": float(weight), "t0": t0, "fence": group.gen,
            },
            tail, timeout=5.0, record_latency=False,
        )

    async def _rpc_redund_share(self, args: dict, payload: bytes):
        """A ring predecessor's tail tiles (summand redundancy, member to
        member). Stashed — it becomes our XOR sidecar to the leader the
        moment our own round state for the epoch exists, and the
        replica-holder source for the leader's second hedge."""
        epoch, pred = args.get("epoch"), args.get("peer")
        if not isinstance(epoch, str) or not isinstance(pred, str) or not payload:
            raise RPCError("malformed redundancy share")
        try:
            w = float(args.get("weight"))
            t0 = int(args.get("t0"))
        except (TypeError, ValueError):
            raise RPCError("malformed redundancy share meta")
        self._sweep_redund_shares()
        self._redund_shares[(epoch, pred)] = (
            time.monotonic(), w, t0, bytes(payload), self._fence_of(args),
        )
        if epoch in self._push_retained and self.tail_redundancy_frac:
            self._spawn_task(self._send_sidecar(epoch, pred))
        return {"ok": True}, b""

    async def _send_sidecar(self, epoch: str, pred: str) -> None:
        """XOR our own tail tiles with the stashed predecessor share and
        ship the sidecar to the round leader (decoded there only if the
        original misses commit)."""
        rec = self._push_retained.get(epoch)
        share = self._redund_shares.get((epoch, pred))
        if rec is None or share is None:
            return
        _, pred_w, t0, pred_tail, _fence = share
        group: Group = rec["group"]
        buf: np.ndarray = rec["buf"]
        esz, cb, tile_elems, n_tiles = self._wire_geometry(buf.size)
        if t0 != n_tiles - self._redund_tiles(n_tiles):
            return  # config skew: the share's layout is not ours
        own_tail = await asyncio.to_thread(
            self._encode_range, buf, t0 * tile_elems, buf.size
        )
        if len(own_tail) != len(pred_tail):
            return  # schema mismatch — not our swarm's layout
        xored = (
            np.bitwise_xor(
                np.frombuffer(own_tail, np.uint8),
                np.frombuffer(pred_tail, np.uint8),
            ).tobytes()
        )
        leader_id, leader_addr = group.members[0]
        await self.transport.call(
            leader_addr, "sync.redund",
            {
                "epoch": epoch, "peer": self.peer_id, "pred": pred,
                "fence": group.gen, "token": group.token,
                "pred_weight": pred_w, "t0": t0,
            },
            xored, timeout=5.0, record_latency=False,
        )

    async def _rpc_redund(self, args: dict, payload: bytes):
        """Leader side: accept one XOR redundancy sidecar for an armed
        round (authenticated by the SUCCESSOR's issued token)."""
        epoch = args.get("epoch")
        st = self._rounds.get(epoch) if isinstance(epoch, str) else None
        if st is None or st.tokens is None or st.stream is None:
            raise RPCError("no armed round for this epoch")
        if self._fence_of(args) != st.gen:
            self._note_fence_rejected("sync.redund", args, have_gen=st.gen)
            raise RPCError("fencing mismatch on redundancy sidecar")
        succ, pred = args.get("peer"), args.get("pred")
        if not succ or st.tokens.get(succ) != args.get("token"):
            raise RPCError("invalid redundancy token")
        if not isinstance(pred, str) or pred not in st.stream.slot_index:
            raise RPCError("redundancy sidecar names an unknown peer")
        try:
            pred_w = float(args.get("pred_weight"))
            t0 = int(args.get("t0"))
        except (TypeError, ValueError):
            raise RPCError("malformed redundancy sidecar meta")
        if t0 != st.stream.n_tiles - st.stream.tail_keep_tiles:
            raise RPCError("redundancy sidecar layout mismatch")
        if len(st.redund) < 64:  # bounded per round
            st.redund[pred] = (succ, pred_w, bytes(payload), t0)
        return {"ok": True}, b""

    def _decode_redundancy(self, st: _Round) -> int:
        """Decode XOR sidecars for peers still missing tail tiles — called
        right before the freeze, so recovered tiles fold into the commit.
        pred_tile = sidecar XOR succ's own delivered tile (retained by the
        aggregator's tail-byte window). Idempotent through add_hedged."""
        stream = st.stream
        if stream is None or not st.redund:
            return 0
        folded = 0
        board = stream.scoreboard()
        # Snapshot: this runs on a worker thread while late sync.redund
        # handlers may still insert on the loop thread — iterating the
        # live dict would crash the round with RuntimeError.
        for pred, (succ, pred_w, xbytes, t0) in list(st.redund.items()):
            rec = board.get(pred)
            if rec is None or rec["sealed"] or rec["aborted"]:
                continue
            cb = stream.chunk_bytes
            total = stream.n_elems * stream.esz
            for tile in range(t0, stream.n_tiles):
                seg0 = (tile - t0) * cb
                seg_len = min(cb, total - tile * cb)
                if seg0 + seg_len > len(xbytes):
                    break  # malformed sidecar: stop, never mis-slice
                succ_bytes = stream.tail_bytes(succ, tile)
                if succ_bytes is None or len(succ_bytes) != seg_len:
                    continue  # successor's own copy of this tile missing
                data = np.bitwise_xor(
                    np.frombuffer(xbytes, np.uint8, count=seg_len, offset=seg0),
                    np.frombuffer(succ_bytes, np.uint8),
                ).tobytes()
                n = stream.add_hedged(
                    pred, pred_w, tile * cb, data, source="redund"
                )
                folded += n
        if folded:
            self.redund_decodes += folded
            if self.telemetry.enabled:
                self.telemetry.registry.counter(
                    "swarm.hedge.redund_tiles_total",
                    "tail tiles decoded from XOR redundancy sidecars",
                ).inc(folded)
        return folded

    async def _hedge_loop(self, st: _Round, group: Group) -> None:
        """The leader's soft-deadline watcher: sleep to the learned soft
        deadline, then rank stragglers off the aggregator's scoreboard and
        keep at most the learned budget of hedged range re-requests in
        flight until the round fills or the deadline lands. Cancelled with
        the gather; in-flight folds after the freeze are no-ops by the
        aggregator's frozen check."""
        stream = st.stream
        if stream is None:
            return
        asg = self._last_group
        level = asg.level if asg is not None else "flat"
        budget = self._deadline_wait(group)
        t_end = time.monotonic() + budget
        if self.resilience is not None:
            soft_frac, max_inflight = self.resilience.hedge_params(level)
        else:
            soft_frac, max_inflight = 0.6, 2
        await asyncio.sleep(budget * soft_frac)
        addr_by = {pid: addr for pid, addr in group.members}
        attempts: Dict[str, int] = {}
        # Keyed BY PEER: one hedge in flight per straggler — a poll must
        # not re-issue for a peer whose previous attempt is still
        # running, or the per-peer attempt budget burns in three polls
        # (and the duplicate replies would read to the AIMD as hedging a
        # healthy tail). A peer re-enters targeting only after its
        # attempt resolves (reply, error, or per-attempt timeout).
        inflight: Dict[str, asyncio.Task] = {}
        try:
            while not st.full.is_set():
                left = t_end - time.monotonic()
                if left <= 0.1:
                    break
                for p in [p for p, t in inflight.items() if t.done()]:
                    inflight.pop(p)
                if len(inflight) < max_inflight:
                    for peer, rng in self._hedge_targets(
                        stream.scoreboard(), left, addr_by, attempts
                    ):
                        if len(inflight) >= max_inflight:
                            break
                        if peer in inflight:
                            continue
                        attempts[peer] = attempts.get(peer, 0) + 1
                        att_timeout = min(
                            max(left, 0.2),
                            max(0.5, self.HEDGE_ATTEMPT_FRAC * budget),
                        )
                        inflight[peer] = asyncio.create_task(
                            self._hedge_fetch(
                                st, group, peer, addr_by[peer],
                                rng[0], rng[1], att_timeout,
                            )
                        )
                await asyncio.sleep(min(self.HEDGE_POLL_S, max(left, 0.05)))
        finally:
            for t in inflight.values():
                if not t.done():
                    t.cancel()

    def _hedge_targets(
        self,
        board: Dict[str, dict],
        left: float,
        addr_by: Dict[str, Any],
        attempts: Dict[str, int],
    ) -> List[Tuple[str, Tuple[int, int]]]:
        """Rank hedge candidates: unsealed peers with missing tiles whose
        ORIGINAL stream is predicted to miss the deadline — phi-accrual
        suspicion, a stalled stream (no arrival for several RTTs), or a
        transfer estimate (missing bytes / measured bandwidth + latency)
        exceeding the time left. Past the soft deadline a silent peer is
        hedged outright (its p95 completion history already failed it).
        Worst missing-volume first."""
        out: List[Tuple[int, str, Tuple[int, int]]] = []
        for peer, rec in board.items():
            if (
                peer == self.peer_id
                or rec["sealed"]
                or rec["aborted"]
                or not rec["missing"]
                or attempts.get(peer, 0) >= self.HEDGE_MAX_PER_PEER
                or peer not in addr_by
            ):
                continue
            addr = addr_by[peer]
            missing_tiles = sum(t1 - t0 for t0, t1 in rec["missing"])
            lat = self.transport.peer_latency(addr) or 0.05
            bw = self.transport.peer_bw_down(addr)
            suspect = (
                self.failure_detector is not None
                and self.failure_detector.suspect(peer)
            )
            age = rec["last_arrival_age_s"]
            stalled = (
                rec["started"] and age is not None and age > max(0.5, 4.0 * lat)
            )
            eta = (
                lat + missing_tiles * self.transport.chunk_bytes / bw
                if bw else None
            )
            if suspect or stalled or not rec["started"] or (
                eta is not None and eta > left
            ):
                # One contiguous range per request: the original stream is
                # in-order, so the missing set is (almost always) a suffix;
                # residual holes get the next pass.
                rng = rec["missing"][0]
                out.append((missing_tiles, peer, (int(rng[0]), int(rng[1]))))
        out.sort(key=lambda x: -x[0])
        return [(p, r) for _, p, r in out]

    async def _hedge_fetch(
        self,
        st: _Round,
        group: Group,
        peer: str,
        addr,
        t0: int,
        t1: int,
        timeout: float,
    ) -> None:
        """One hedged range re-request: pull tiles [t0, t1) of ``peer``'s
        retained contribution over a second stream and fold them into the
        round's aggregator as they verify. Falls back to the peer's ring
        successor (replica holder of its XOR-shared tail) when the
        straggler itself is unreachable and redundancy is on."""
        stream = st.stream
        if stream is None:
            return
        tele = self.telemetry
        st.hedges_issued += 1
        self.hedges_issued += 1
        if tele.enabled:
            tele.registry.counter(
                "swarm.hedge.issued_total", "hedged tile re-requests issued"
            ).inc()
        tele.event(
            "hedge_issued", epoch=group.epoch, peer=peer,
            t0=int(t0), t1=int(t1),
        )
        span = tele.tracer.start(
            "hedge", trace=group.epoch, role="leader", peer=peer,
            tiles=int(t1 - t0), gen=st.gen,
        )
        token = (st.tokens or {}).get(peer, "")
        args = {
            "epoch": group.epoch, "fence": st.gen, "peer": peer,
            "t0": int(t0), "t1": int(t1), "token": token,
        }
        base = int(t0) * stream.chunk_bytes
        folded = 0
        source = "refetch"
        try:
            try:
                folded = await self._refetch_into(
                    stream, peer, addr, args, base, timeout
                )
            except (RPCError, OSError, asyncio.TimeoutError, TimeoutError) as e:
                # Replica-holder fallback: the straggler itself is gone or
                # saturated; its ring successor retains the XOR-shared
                # tail. Only the tail sub-range is recoverable there.
                succ = self._ring_successor(group, peer)
                r_tiles = stream.tail_keep_tiles
                tail_t0 = stream.n_tiles - r_tiles
                if succ is None or not r_tiles or t1 <= tail_t0:
                    raise
                source = "replica"
                succ_id, succ_addr = succ
                rargs = dict(
                    args,
                    t0=int(max(t0, tail_t0)),
                    token=(st.tokens or {}).get(succ_id, ""),
                )
                log.debug(
                    "hedge: refetch from %s failed (%s); trying replica "
                    "holder %s", peer, errstr(e), succ_id,
                )
                folded = await self._refetch_into(
                    stream, peer, succ_addr, rargs,
                    rargs["t0"] * stream.chunk_bytes,
                    max(timeout / 2, 0.2),
                )
            if span is not None:
                span.end(ok=True, folded=folded, source=source)
        except asyncio.CancelledError:
            # Deadline landed (or the round filled) with this hedge still
            # in flight: end the span so the trace shows the attempt.
            if span is not None:
                span.end(ok=False, cancelled=True, folded=folded)
            raise
        except (RPCError, OSError, asyncio.TimeoutError, TimeoutError) as e:
            self.hedges_failed += 1
            if tele.enabled:
                tele.registry.counter(
                    "swarm.hedge.failed_total", "hedged re-requests that failed"
                ).inc()
            if span is not None:
                span.end(ok=False, error=errstr(e), source=source)

    async def _refetch_into(
        self,
        stream: StreamingAggregator,
        peer: str,
        addr,
        args: dict,
        base: int,
        timeout: float,
    ) -> int:
        """Issue one sync.refetch and fold the reply into ``stream`` under
        ``peer``'s slot. Streams chunk-by-chunk when the peer's weight is
        already known and the transport is unauthenticated (the request-
        sink integrity rule applied client-side: hedged folds are
        irreversible, so under auth the reply buffers whole and folds only
        after the payload MAC verified)."""
        folded = 0
        w_known = stream.weight_of(peer)
        if w_known > 0 and getattr(self.transport, "_secret", None) is None:
            def hsink(off: int, total: int, data: bytes) -> None:
                nonlocal folded
                folded += stream.add_hedged(peer, w_known, base + off, data)

            await self.transport.call(
                addr, "sync.refetch", args, timeout=timeout,
                chunk_sink=hsink, record_latency=False,
            )
            return folded
        ret, payload = await self.transport.call(
            addr, "sync.refetch", args, timeout=timeout, record_latency=False,
        )
        try:
            w = float(ret.get("weight") or 1.0)
        except (TypeError, ValueError):
            w = 1.0

        def fold() -> int:
            n = 0
            cb = stream.chunk_bytes
            for off in range(0, len(payload), cb):
                n += stream.add_hedged(
                    peer, w, base + off, bytes(payload[off : off + cb])
                )
            return n

        return await asyncio.to_thread(fold)

    def _ring_successor(self, group: Group, peer: str) -> Optional[Tuple[str, Any]]:
        """The ring successor of ``peer`` among the round's NON-LEADER
        members (the redundancy ring excludes the leader — it already
        holds its own contribution), or None below 3 members."""
        ring = [m for m in group.members if m[0] != group.leader_id]
        ids = [pid for pid, _ in ring]
        if peer not in ids or len(ring) < 2:
            return None
        return ring[(ids.index(peer) + 1) % len(ring)]

    async def average(self, tree: Any, round_no: int, weight: float = 1.0) -> Optional[Any]:
        self._sweep_rounds(self._rounds)
        # Fenced controller decisions apply HERE — before this round's
        # rendezvous — so a mid-round regime shift can never mix two
        # configurations into one round (the epoch-fence contract).
        self._apply_controller()
        await self._maybe_backoff()
        tele = self.telemetry
        # Round-trace bookkeeping: the JOIN phase (rendezvous + formation)
        # runs before the trace id — the matchmaking epoch — exists, so its
        # wall/duration are captured here and the span recorded
        # retroactively once the group (and therefore the epoch) is known.
        t_round_wall, t_round_pc = tele.clock(), time.perf_counter()
        # Group-scoped rendezvous when a rotating schedule is attached:
        # many groups form this round, each running THIS protocol under
        # its own epoch; we only ever see our own — and the schedule's
        # determinism lets formation skip the DHT entirely (_form_group).
        round_key = await self._rendezvous()
        group = await self._form_group(round_key)
        join_dur = time.perf_counter() - t_round_pc
        if group is None:
            # No group formed (too few peers / no begin): a matchmaking
            # skip, not a round — the policy only learns from rounds that
            # actually ran, so a solo volunteer never ratchets its deadline
            # or backs itself off.
            self.rounds_skipped += 1
            self._last_outcomes = None
            self._note_group_round(None)
            return None
        if group.my_index != 0 and self._recently_deposed(group.leader_id):
            # Leadership strike (tentpole part 3): this peer crashed out of
            # the lead within the TTL — don't hand it our contribution (or
            # gate our round on its fetch) again yet. Our own _pick_leader
            # already prefers someone else; this covers the race where the
            # flaky peer's begin still won.
            log.info(
                "sync round: refusing round led by recently-deposed %s",
                group.leader_id,
            )
            self.rounds_skipped += 1
            self._last_outcomes = None
            self._note_group_round(None)
            return None
        # The trace id IS the round's existing key: the matchmaking epoch,
        # which already hashes the group-scoped rendezvous key (rotation,
        # group index, hierarchy level). Recovery generations ride as span
        # attributes so a recovered round stays ONE trace.
        trace = group.epoch
        asg = self._last_group
        level = asg.level if asg is not None else "flat"
        group_id = group.group_id or (asg.group_id if asg is not None else "")
        role = "leader" if group.my_index == 0 else "member"
        ok = False
        # Reset BEFORE any awaitable can raise: the round span's finally
        # reads this, and a round dying in arm/encode must not inherit the
        # previous round's degraded verdict.
        self._round_degraded = False
        with tele.tracer.trace_scope(trace), log_context(
            peer=self.peer_id, round_key=round_key, trace=trace,
            round_level=level, group=group_id or None,
            zone=self.zone or None,
        ):
            tele.tracer.record(
                "join", trace, t_round_wall, join_dur,
                role=role, key=round_key, size=group.size,
            )
            try:
                if group.my_index == 0 and self._specs is not None:
                    # Arm the streaming round BEFORE packing our own
                    # contribution: members push the instant formation
                    # completes, and the pack at param scale is exactly the
                    # window their first chunks land in.
                    await self._prepare_lead_round(group)
                # One compression per round, leader or member: the leader's
                # own contribution enters the aggregate exactly as a peer
                # would see it.
                with tele.span("encode", role=role):
                    buf, wire_bytes, sent = await self._pack_and_compress(tree)
                t0 = time.monotonic()
                # The leader's own contribution always enters the aggregate;
                # a member's may be dropped in a degraded round (late push),
                # in which case its shipped top-k mass never landed and
                # committing the residual would lose both. _member_round
                # flips this from the leader-reported included set.
                self._contribution_included = True
                try:
                    if group.my_index == 0:
                        result = await self._lead_round(
                            group, await asyncio.to_thread(sent), weight, wire_bytes
                        )
                    else:
                        # Tail-optimal recovery, member side: register the
                        # dense form behind sync.refetch for the round's
                        # lifetime (the leader's hedges re-pull ranges of
                        # it, bit-identical to the push), and — redundancy
                        # on — ship the tail tiles to the ring successor.
                        retained = self.wire in ("f32", "bf16") and buf is not None
                        if retained:
                            self._retain_push(group, buf, weight)
                            if self.tail_redundancy_frac and len(group.members) >= 3:
                                self._spawn_task(
                                    self._send_redund_share(group, buf, weight)
                                )
                        try:
                            result = await self._member_round(
                                group, weight, wire_bytes, sent
                            )
                        finally:
                            if retained:
                                self._drop_retained(group.epoch)
                except (RPCError, OSError, ValueError, asyncio.TimeoutError) as e:
                    log.info(
                        "sync round %d failed (%s); continuing local",
                        round_no, errstr(e),
                    )
                    tele.event("round_failed", key=round_key, error=errstr(e))
                    self.rounds_skipped += 1
                    self._observe_round_failure()
                    self._commit_ef(False)
                    self._flush_round_outcome(time.monotonic() - t0, ok=False)
                    self._note_group_round(False, size=group.size)
                    return None
                self._commit_ef(result is not None and self._contribution_included)
                if result is None:
                    self._observe_round_failure()
                elif self._round_degraded:
                    self.rounds_degraded += 1
                    tele.event("round_degraded", key=round_key)
                else:
                    self._observe_round_time(time.monotonic() - t0)
                self._flush_round_outcome(time.monotonic() - t0, ok=result is not None)
                self._note_group_round(
                    result is not None,
                    degraded=self._round_degraded,
                    led=group.my_index == 0,
                    size=group.size,
                )
                ok = result is not None
                return result
            finally:
                tele.tracer.record(
                    "round", trace, t_round_wall,
                    time.perf_counter() - t_round_pc,
                    role=role, key=round_key, level=level, ok=ok,
                    degraded=self._round_degraded, gen=group.gen,
                    **({"group": group_id} if group_id else {}),
                )

    async def _prepare_lead_round(self, group: Group) -> _Round:
        """The leader-side round prologue, idempotent per epoch: fix the
        token table, pick the estimator, ARM the streaming aggregator, and
        fold any pre-arming parked buffers into it.

        Split from _lead_round so ``average()`` can run it BEFORE packing
        the leader's own contribution: members push the instant formation
        completes, and a param-scale pack is exactly the window their
        headers used to land in — every push that arrived pre-arming had
        to buffer dense (observed on a localhost resnet18 swarm: all
        contributions went dense). Pre-armed, the factory catches them
        from the first chunk. Needs ``self._specs`` (any round after the
        first); round one arms from _lead_round, after the pack."""
        st = self._rounds.get(group.epoch)
        if st is None:
            st = self._rounds[group.epoch] = _Round([])
        if st.armed:
            return st
        arm_span = self.telemetry.tracer.start(
            "arm", trace=group.epoch, role="leader", gen=group.gen
        )
        try:
            await self._phase("pre_arm")
            st.armed = True
            st.gen = group.gen
            member_ids = [pid for pid, _ in group.members]
            st.expected = set(member_ids)
            tokens = group.member_tokens or {}
            st.tokens = tokens
            # Keep only parked entries under the exact (peer, token) pairs
            # we issued at begin — everything else is noise or forgery.
            st.contribs = {
                (p, t): c for (p, t), c in st.contribs.items() if tokens.get(p) == t
            }
            st.payloads = {
                k: pl for k, pl in st.payloads.items() if k in st.contribs
            }
            # The estimator is fixed at ARMING (not commit): streamed tiles
            # aggregate while contributions are still arriving, so the
            # method must be known before the first chunk lands. Safe to
            # fix early because the METHOD choice is count-insensitive —
            # _effective_method picks it from
            # resilience.recommend_method(self.method), which never sees
            # the peer count — so members dropping between arming and
            # commit cannot change it. Only the kwargs depend on row
            # count, and those ARE recomputed per arrived count via kw_fn
            # below. What did move is the escalation-state read: a
            # resilience state change mid-round is seen one round later
            # than the commit-time call saw it.
            method, _ = self._effective_method(len(member_ids))
            kw_cache: Dict[int, dict] = {}

            def kw_fn(n: int, _m=method) -> dict:
                # Memoized per row count: a per-tile recompute would
                # re-log the infeasible-trim clamp warning once per tile.
                if n not in kw_cache:
                    kw_cache[n] = self._robust_kw(n, method=_m)
                return kw_cache[n]

            st.method, st.kw_fn = method, kw_fn
            n_elems = sum(s.size for s in self._specs)
            esz = 4 if self.wire == "f32" else 2
            if self.wire in ("f32", "bf16") and self.transport.chunk_bytes % esz == 0:
                # Arm the streaming pipeline: from here on, chunked pushes
                # fold tile-by-tile as they arrive (transport request
                # sink), inline pushes fold at decode, and the deadline
                # commit reduces to closing whatever is still open.
                _, _, _, n_tiles = self._wire_geometry(n_elems)
                st.stream = StreamingAggregator(
                    n_elems, member_ids, method, self.wire,
                    self.transport.chunk_bytes, kw_fn=kw_fn,
                    codec=self.mesh_codec,
                    telemetry=self.telemetry,
                    # Summand redundancy: retain members' tail-tile wire
                    # bytes as XOR-decode keys for ring sidecars.
                    tail_keep_tiles=self._redund_tiles(n_tiles),
                )
                # Fold every pre-arming parked buffer; fed entries drop
                # their dense copy — the aggregator owns that mass now.
                for k, (w_k, b_k) in [
                    (k, c) for k, c in st.contribs.items()
                    if c[1] is not None and c[1] is not STREAMED
                    and c[1].size == n_elems
                ]:
                    fed = await asyncio.to_thread(st.stream.add_dense, k[0], w_k, b_k)
                    if fed:
                        st.contribs[k] = (w_k, STREAMED)
        except BaseException:
            if arm_span is not None:
                arm_span.end(ok=False)
            raise
        if arm_span is not None:
            arm_span.end(streaming=st.stream is not None)
        return st

    async def _lead_round(
        self,
        group: Group,
        buf: np.ndarray,
        weight: float,
        wire_bytes: bytes = b"",
    ):
        st = await self._prepare_lead_round(group)
        tokens = st.tokens or {}
        method, kw_fn = st.method, st.kw_fn
        st.contribs[(self.peer_id, group.token)] = (weight, buf)
        if self.wire == "powersgd" and wire_bytes:
            st.payloads[(self.peer_id, group.token)] = wire_bytes
        if st.stream is not None:
            # Our own contribution enters through the same pipeline the
            # members' do (mean: one O(D) axpy; window: a borrowed-reference
            # resident).
            fed = await asyncio.to_thread(
                st.stream.add_dense, self.peer_id, weight, buf
            )
            if fed:
                st.contribs[(self.peer_id, group.token)] = (weight, STREAMED)
        if {p for p, t in st.contribs if (p, t) not in st.feeding} >= st.expected:
            st.full.set()
        if self._phase_armed("mid_stream"):
            # Chaos instrumentation: "mid_stream" means member data has
            # started arriving — wait (bounded) for the first remote
            # contribution bytes before firing, so the kill really lands
            # mid-gather and not in the pre-arm window.
            await self._await_remote_contribution(
                st, timeout=min(5.0, self._deadline_wait(group))
            )
            await self._phase("mid_stream")
        # FOLD phase: the gather wait plus the streaming pipeline's commit
        # tail (close open windows, await in-flight tile jobs, re-normalize).
        fold_sp = self.telemetry.tracer.start(
            "fold", trace=group.epoch, role="leader", gen=group.gen
        )
        commit_sp = None
        try:
            # Tail-optimal recovery: the soft-deadline hedger watches the
            # aggregator's tile scoreboard beside the gather wait and
            # re-requests predicted-late ranges. The ROUND deadline is
            # untouched — hedging spends idle wait, not wall time.
            hedger: Optional[asyncio.Task] = None
            if (
                self.hedge
                and st.stream is not None
                and self.wire in ("f32", "bf16")
                and len(group.members) > 1
            ):
                hedger = asyncio.create_task(self._hedge_loop(st, group))
            try:
                # The group DEADLINE bounds the gather: begin fan-out time
                # already spent the budget, so a slow formation shrinks the
                # wait instead of extending the round past its commit time.
                await asyncio.wait_for(
                    st.full.wait(), timeout=self._deadline_wait(group)
                )
            except asyncio.TimeoutError:
                self._round_degraded = True  # deadline commit: not an observation
            finally:
                if hedger is not None:
                    hedger.cancel()
                    try:
                        await hedger
                    except (asyncio.CancelledError, Exception):  # noqa: BLE001
                        pass
            if st.stream is not None and st.redund:
                # Summand redundancy decodes BEFORE the freeze: a tail the
                # original missed folds into the commit iff its XOR
                # sidecar + the successor's own delivered tail are both in.
                await asyncio.to_thread(self._decode_redundancy, st)
            await self._phase("post_partial_commit")
            # Resolve pre-schema-parked powersgd payloads now that our own
            # pack fixed the specs (exact-size-capped decode).
            await self._decode_deferred(st)
            if st.stream is not None:
                # Freeze the pipeline BEFORE deciding membership: a feed
                # that loses this race is late by definition (its dense
                # entry survives but is not adopted), and stream-complete
                # pushes whose handler task hasn't run yet are adopted here.
                st.stream.freeze()
                for k, w_k in list(st.stream_done.items()):
                    if tokens.get(k[0]) == k[1]:
                        st.contribs.setdefault(k, (w_k, STREAMED))
                # The aggregator's own view beats the handler bookkeeping:
                # a contribution that finished folding pre-freeze IS in the
                # aggregate even when its handler (dense-feed STREAMED mark)
                # or sink close() hasn't caught up — report it included, or
                # the resilience policy penalizes an honest peer whose mass
                # the round actually used.
                for p in st.stream.included_peers():
                    t = tokens.get(p)
                    if t is not None:
                        st.contribs[(p, t)] = (st.stream.weight_of(p), STREAMED)
            # Drop contributions whose buffer doesn't match ours (model
            # mismatch that slipped past the early-accept schema check) or
            # whose token isn't the secret WE issued to that member at begin
            # — a member cannot submit under another member's identity. On a
            # streaming round only FOLDED (streamed) entries count: a dense
            # buffer that never made it into the aggregator is late.
            good = {
                p: c
                for (p, t), c in st.contribs.items()
                # c[1] None: a pre-schema deferred entry whose payload a
                # straggler handler parked DURING _decode_deferred's awaits
                # — unresolved, so it sits this round out.
                if tokens.get(p) == t
                and (
                    c[1] is STREAMED
                    if st.stream is not None
                    else c[1] is not None and c[1].size == buf.size
                )
            }
            # Per-peer outcomes for the resilience policy: an expected
            # member missing from ``good`` either never arrived (absent) or
            # arrived malformed under a valid token (rejected).
            rejected = sorted(
                p
                for (p, t), c in st.contribs.items()
                if tokens.get(p) == t
                and p != self.peer_id
                and c[1] is not STREAMED
                and (c[1] is None or c[1].size != buf.size)
            )
            st.excluded = sorted(
                p for p in st.expected if p not in good and p != self.peer_id
            )
            self._last_outcomes = {
                "on_time": [p for p in sorted(good) if p != self.peer_id],
                "absent": [p for p in st.excluded if p not in rejected],
                "rejected": rejected,
            }
            self._last_outcomes_epoch = group.epoch
            if len(good) < self.min_group:
                if fold_sp is not None:
                    fold_sp.end(ok=False, arrived=len(good))
                self.telemetry.event(
                    "round_failed", epoch=group.epoch,
                    reason=f"leader skipped: {len(good)}/{self.min_group} contributions",
                )
                self.rounds_skipped += 1
                # Fail members' pending fetches fast, then free the buffers.
                st.result_ready.set()  # with st.result None -> fetch raises
                # Eager release: the parked contributions are param-sized
                # and nothing after this point reads them — holding them
                # until the 5 s sweep fires kept O(N·D) pinned per skipped
                # round. The _Round shell stays for fetch-error serving.
                self._note_agg_round(st.stream)
                self._release_round(st)
                asyncio.get_running_loop().call_later(
                    5.0, self._rounds.pop, group.epoch, None
                )
                return None
            if st.excluded:
                log.info(
                    "sync round committed at deadline without %s "
                    "(%d/%d contributions)",
                    st.excluded, len(good), len(st.expected),
                )
            peers = sorted(good)
            st.included = peers
            method_kw = kw_fn(len(peers))
            health_on = self.health is not None and self.health.enabled
            dense_q: Dict[str, float] = {}

            def _aggregate() -> np.ndarray:
                if method == "mean":
                    # Streaming weighted accumulation (native axpy when
                    # built): no [n_peers, D] stack copy for the common path.
                    # A deadline-committed subset re-normalizes here by
                    # construction: total_w is the weight that ARRIVED.
                    total_w = float(sum(good[p][0] for p in peers))
                    acc = np.zeros(buf.size, np.float32)
                    for p in peers:
                        w_p, buf_p = good[p]
                        native.weighted_sum_inplace(acc, buf_p, w_p / total_w)
                    return acc
                stack = np.stack([good[p][1] for p in peers])
                out = self.mesh_codec.aggregate(stack, method, **method_kw)
                if health_on and len(peers) >= 3:
                    # Quality attribution for the non-streaming wires
                    # (q8/topk/powersgd/sign take this branch): the byz
                    # flagging contract must not depend on the wire codec.
                    for p, d2 in zip(peers, health_mod.row_d2(stack, out)):
                        dense_q[p] = float(d2)
                return out

            if st.stream is not None:
                # The pipeline already decoded and (for mean/window methods)
                # aggregated most tiles while chunks were arriving: the
                # commit closes the open windows over the arrived subsets,
                # awaits in-flight tile jobs, and re-normalizes — bounded by
                # the tail, not by N full decode+aggregate passes.
                st.result = await st.stream.finalize(peers)
                self._note_agg_round(st.stream)
            else:
                # Seconds of array math at param scale — off the loop
                # (members' fetches park on result_ready; heartbeats must
                # keep flowing).
                st.result = await asyncio.to_thread(_aggregate)
            # Training-health: the balanced mass classification for this
            # commit (streaming rounds classify per slot; dense rounds
            # from the arrived-weight map) plus the per-peer quality
            # distances the tile folds (or the dense branch above)
            # accumulated. Gated on the health probe alone — under
            # --no-health-probe NO health tally runs and the fold span
            # carries no mass column, honoring the "disabled end-to-end"
            # contract even while the rest of telemetry stays on.
            mass = quality = None
            if health_on:
                # Shard-scoped rounds tag every slot with the group's shard
                # domain so health.mass_by_shard can roll the buckets up
                # per shard — a shard-holder death then reads as one
                # shard's committed fraction dipping, not a fleet-wide dip.
                asg_m = self._last_group
                shard_of = (
                    {p: asg_m.shard for p in st.expected}
                    if asg_m is not None and asg_m.shard is not None
                    else None
                )
                mass = (
                    st.stream.mass_report(shard_of)
                    if st.stream is not None
                    else health_mod.mass_from_outcomes(
                        st.expected, {p: float(good[p][0]) for p in good}
                    )
                )
                quality = (
                    st.stream.quality_d2() if st.stream is not None
                    else dense_q or None
                )
            if st.stream is not None:
                # Tail-optimal bookkeeping: cumulative recovered-slot
                # counter, per-peer contribution-latency samples (the
                # policy's tail quantiles), and the AIMD hedge-budget
                # feedback for this round's hierarchy level.
                hs = st.stream.hedge_stats()
                self.slots_recovered += hs["slots_recovered"]
                if hs["slots_recovered"] and self.telemetry.enabled:
                    self.telemetry.registry.counter(
                        "swarm.hedge.slots_recovered_total",
                        "straggler contributions completed by hedged recovery",
                    ).inc(hs["slots_recovered"])
                if self.resilience is not None:
                    for p, dt in st.stream.seal_latencies().items():
                        if p != self.peer_id:
                            self.resilience.record_contribution_latency(p, dt)
                    if self.hedge:
                        if mass is not None:
                            lost_w = float(mass["excluded_weight"]) + float(
                                mass["aborted_weight"]
                            )
                            if lost_w == 0.0 and (
                                mass["excluded_slots"] or mass["aborted_slots"]
                            ):
                                # Silent peers declare no weight; the lost
                                # SLOTS are still the AIMD's open-up signal.
                                lost_w = float(
                                    mass["excluded_slots"] + mass["aborted_slots"]
                                )
                        else:
                            lost_w = float(len(st.excluded))
                        asg_now = self._last_group
                        self.resilience.record_hedge_outcome(
                            asg_now.level if asg_now is not None else "flat",
                            issued=st.hedges_issued,
                            tiles_recovered=hs["tiles_recovered"],
                            duplicate_tiles=hs["hedge_duplicates"],
                            slots_recovered=hs["slots_recovered"],
                            lost_weight=lost_w,
                        )
            if fold_sp is not None:
                fold_sp.end(
                    ok=True, arrived=len(peers),
                    expected=len(st.expected),
                    degraded=self._round_degraded,
                    **(
                        {"mass_frac": mass["mass_committed_frac"]}
                        if mass is not None else {}
                    ),
                )
            commit_sp = self.telemetry.tracer.start(
                "commit", trace=group.epoch, role="leader", gen=group.gen
            )
            # Encode the wire form ONCE before releasing the fetch waiters.
            if self.wire == "powersgd" and method == "mean":
                # Serve the EXACT factored mean (concatenated weighted
                # factor pairs): same value members would get densely, at a
                # fraction of the result-fetch bytes. Falls back to the
                # dense container if any contribution's payload is missing
                # (e.g. a parked entry from before this leader's round).
                good_keys = {(p, t) for (p, t) in st.contribs if p in good}

                def _merge_or_dense() -> bytes:
                    from distributedvolunteercomputing_tpu_torch.swarm import powersgd

                    try:
                        pairs = [
                            (st.contribs[k][0], st.payloads[k]) for k in good_keys
                        ]
                        # Cap each payload's dense-reconstruction work at
                        # the schema size: merge may densify low-rank
                        # entries, and a crafted container must not buy a
                        # bigger allocation than a legitimate dense one.
                        return powersgd.merge(pairs, max_floats=st.result.size)
                    except (KeyError, ValueError):
                        # Missing payload (parked before this round) or a
                        # crafted container whose entry split disagrees with
                        # the others — the round must not die over the
                        # result ENCODING; serve the dense container.
                        return self._to_wire(st.result)

                st.result_wire = await asyncio.to_thread(_merge_or_dense)
            elif self.wire in ("f32", "bf16"):
                # Lazy wire form: each fetch response encodes chunk-by-chunk
                # on a worker thread while earlier chunks are already on the
                # socket (encode/send overlap), so the commit point never
                # pays — or holds — a full-size encoded copy of the result.
                # At most max_group cheap elementwise passes replace the one
                # eager encode, each overlapped with its own send.
                st.result_wire = self._wire_stream(st.result)
            else:
                st.result_wire = await self._encode_wire(st.result)
            await self._phase("pre_fetch")
            st.result_ready.set()
            if commit_sp is not None:
                commit_sp.end(wire=self.wire)
            self.rounds_ok += 1
            # Keep state around long enough for members to fetch.
            asyncio.get_running_loop().call_later(
                self.gather_timeout * 2, self._rounds.pop, group.epoch, None
            )
            if self.health is not None and self.health.enabled:
                # Post-commit health bookkeeping off the loop (members are
                # already fetching — result_ready is set): quality votes,
                # mass gauges + flight event, post-round sketch. Its own
                # span so the leader's critical-path coverage contract
                # (trace_report) still accounts for the round's wall.
                with self.telemetry.span("health", trace=group.epoch, role="leader"):
                    await asyncio.to_thread(
                        self._health_note_commit, st.result, group.epoch,
                        mass, quality,
                    )
            return self._unpack(st.result)
        except Exception:
            # Idempotent ends: whichever phase the failure interrupted is
            # the one still open — record it ok=False instead of dropping
            # exactly the span a post-mortem needs.
            if fold_sp is not None:
                fold_sp.end(ok=False)
            if commit_sp is not None:
                commit_sp.end(ok=False)
            failed = self._rounds.pop(group.epoch, None)
            if failed is not None:
                self._release_round(failed)
            raise

    def _release_round(self, st: _Round) -> None:
        """Free a round's held contribution buffers NOW (skipped/failed
        rounds): parked payloads and dense contributions are param-sized,
        and the streaming aggregator's tiles go back to the pool."""
        st.contribs.clear()
        st.payloads.clear()
        st.stream_done.clear()
        if st.stream is not None:
            st.stream.release()

    async def _member_round(
        self,
        group: Group,
        weight: float,
        wire_bytes,
        dense_fn: Optional[Callable[[], np.ndarray]] = None,
    ):
        """Push to the leader, fetch the result — and if the leader dies
        under us, recover instead of skipping: the wire form is RETAINED
        (``wire_bytes`` stays referenced until a commit is acknowledged, and
        a StreamPayload's factory re-iterates) so the recovery round
        re-pushes exactly the bytes this round compressed, with no second
        error-feedback staging."""
        leader_id, leader_addr = group.members[0]
        tele = self.telemetry
        try:
            # WIRE phase: the push leg (encode overlapped with send on
            # StreamPayload wires); FETCH parks on the leader's commit
            # point by design, so its span brackets the leader's fold.
            with tele.span("wire", role="member", leader=leader_id, gen=group.gen):
                await self._push_contribution(leader_addr, group, weight, wire_bytes)
            with tele.span("fetch", role="member", leader=leader_id, gen=group.gen):
                return await self._fetch_round_result(leader_addr, leader_id, group)
        except _LeaderDown as e:
            log.warning(
                "sync round: leader %s down (%s); attempting failover recovery",
                leader_id, e,
            )
            with tele.span("recover", role="member", deposed=leader_id, gen=group.gen):
                return await self._recover_round(
                    group, weight, wire_bytes, dense_fn, reason=str(e)
                )

    async def _push_contribution(
        self, leader_addr, group: Group, weight: float, wire_bytes
    ) -> None:
        args = {
            "epoch": group.epoch,
            "peer": self.peer_id,
            "weight": weight,
            "schema": self._schema,
            "token": group.token,
            "fence": group.gen,
        }
        # The push must land BEFORE the group deadline or the leader commits
        # without it — spending more than the remaining budget on it would
        # only produce a late arrival the policy then counts against us.
        # record_latency=False on the payload legs: bulk-transfer (and, for
        # the fetch, deliberately-parked) durations must not poison the
        # control-plane latency EWMA the failure detector suspects on.
        try:
            await self.transport.call(
                leader_addr, "sync.contribute", args, wire_bytes,
                timeout=self._deadline_wait(group, floor=1.0),
                record_latency=False,
            )
        except (asyncio.TimeoutError, TimeoutError):
            # A timed-out push is a SLOW gather, not a dead leader — and on
            # Python >= 3.11 asyncio.TimeoutError IS builtins.TimeoutError,
            # an OSError subclass: without this clause the handler below
            # would depose a merely-slow leader (same trap the transport's
            # retry path documents).
            raise
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            # Hard connection-level failure (refused dial, reset socket):
            # the leader process is GONE — distinct from a timeout (which
            # may just be a slow gather) and grounds for immediate
            # deposition rather than outwaiting the round budget.
            raise _LeaderDown(
                f"contribution push failed at connection level: {errstr(e)}"
            ) from e

    async def _fetch_round_result(self, leader_addr, leader_id: str, group: Group):
        # Decode-on-arrival (f32/bf16): verified result chunks land straight
        # in the final f32 buffer while later chunks are still in flight.
        sink, sink_state = self._result_sink()
        call = asyncio.ensure_future(
            self.transport.call(
                leader_addr, "sync.fetch",
                {"epoch": group.epoch, "fence": group.gen},
                # Outwait the leader's own commit point (the deadline) plus
                # its off-loop aggregation headroom plus transfer margin.
                timeout=self._deadline_wait(group, floor=1.0)
                + self.AGGREGATION_HEADROOM + 6.0,
                chunk_sink=sink,
                record_latency=False,
            )
        )
        try:
            if self.failure_detector is not None:
                # Mid-fetch leader suspicion: the fetch deliberately parks
                # on the leader until its commit point, which is exactly
                # the window a silently-dead leader wastes. Poll the
                # phi-accrual verdict while parked and depose instead of
                # outwaiting the full budget.
                while True:
                    done, _ = await asyncio.wait({call}, timeout=0.5)
                    if done:
                        break
                    if self.failure_detector.suspect(leader_id):
                        call.cancel()
                        try:
                            await call
                        except (asyncio.CancelledError, Exception):  # noqa: BLE001
                            pass
                        raise _LeaderDown(
                            "failure detector suspects the leader mid-fetch"
                        )
            ret, payload = await call
        except (asyncio.TimeoutError, TimeoutError):
            # Timeout != death (see _push_contribution): deposing here
            # would punish every slow commit; the deadline machinery
            # already bounds what a slow leader can cost.
            raise
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            raise _LeaderDown(
                f"result fetch failed at connection level: {errstr(e)}"
            ) from e
        except RPCError as e:
            if "unknown or finished round epoch" in str(e) and (
                time.monotonic() - group.formed_mono < self.gather_timeout
            ):
                # EARLY unknown-epoch — well inside the round's lifetime,
                # long before the leader's post-commit retention window
                # (2x gather_timeout) could have swept it — means the
                # leader restarted and lost its round state mid-round:
                # death for this round's purposes. A LATE unknown-epoch is
                # this member stalling past the retention window of a
                # round the leader already served everyone else; deposing
                # a healthy leader for our own slowness would hand out
                # suspicion holds swarm-wide, so that stays a plain
                # failed fetch.
                raise _LeaderDown(f"leader lost round state ({e})") from e
            raise
        finally:
            if not call.done():
                call.cancel()
        # Older leaders don't report the included set; treat absence as
        # included (the pre-existing behavior) rather than stalling EF.
        included = ret.get("included")
        if included is not None:
            self._contribution_included = self.peer_id in included
        if self.peer_id in (ret.get("excluded") or ()):
            # Say WHY our update didn't land from this side too — one line a
            # volunteer operator can read without the leader's logs. (On EF
            # wires the un-landed mass re-stages via _commit_ef above.)
            log.info(
                "sync round committed at its deadline without our "
                "contribution (push arrived late or was dropped)"
            )
        self.rounds_ok += 1
        def _finish(b: Optional[np.ndarray]):
            # Member-side health: sketch the committed aggregate we are
            # about to adopt (the post-round parameters), so the member's
            # heartbeat report carries the same-round sketch the mixing-
            # error rollup compares across peers.
            self._health_note_commit(b, group.epoch)
            return self._unpack(b)

        if (
            sink_state is not None
            and sink_state["out"] is not None
            and sink_state["filled"] == sink_state["expect"]
        ):
            # The streamed sink already decoded the result: unpack only.
            buf = sink_state["out"]
            return await asyncio.to_thread(_finish, buf)
        # Inline (small) response, or a wire the sink doesn't cover.
        return await asyncio.to_thread(
            lambda: _finish(self._buf_from_payload(payload))
        )

    # -- leader failover recovery ------------------------------------------

    def _note_deposed(self, leader_id: str, leader_addr, reason: str) -> None:
        """Record the deposition evidence that is sound from a SINGLE
        observer's vantage: the gauge, the detector's connection-failure
        hold (cleared by the peer's next observed heartbeat), and retiring
        the pooled connection so nothing retries against the corpse. The
        leadership STRIKE — refusing the peer the lead, and its rounds,
        for DEPOSED_LEADER_TTL_S — is recorded separately by
        _recover_round once recovery is actually viable: one member's own
        flaky outbound link (a dropped call in a 2-peer swarm) must not
        blacklist a healthy leader for the whole strike window."""
        log.warning("sync round: deposing leader %s (%s)", leader_id, reason)
        self.telemetry.event("leader_deposed", leader=leader_id, reason=reason)
        self.leaders_deposed += 1
        if self.failure_detector is not None:
            self.failure_detector.report_failure(leader_id)
        self.transport.drop_peer(leader_addr)

    def _strike_deposed(self, leader_id: str) -> None:
        self._deposed_leaders[leader_id] = time.monotonic()
        if self.resilience is not None:
            self.resilience.note_leader_deposed(leader_id)

    def _successor(self, survivors: List[Tuple[str, Any]]) -> Optional[str]:
        """Deterministic successor: the first survivor in epoch (sorted-id)
        order the local policy does not currently suspect — never skipping
        ourselves, and falling back to the plain first survivor when every
        candidate is suspected. Views can diverge across members (suspicion
        is local); the recovery begin is what re-synchronizes them — a
        member follows whichever valid begin arrives, and a second
        self-promoted successor's round simply underfills and skips."""
        for pid, _ in survivors:
            if pid == self.peer_id:
                return pid
            if self.resilience is not None and self.resilience.should_preexclude(pid):
                continue
            if self.failure_detector is not None and self.failure_detector.suspect(pid):
                continue
            return pid
        return survivors[0][0] if survivors else None

    async def _recover_round(
        self,
        group: Group,
        weight: float,
        wire_bytes,
        dense_fn: Optional[Callable[[], np.ndarray]],
        reason: str,
    ):
        """Re-lead (or follow) a recovery round over the SAME epoch at
        generation+1 after deposing the leader. One generation bump per
        round from this node's vantage: if the successor dies too, the
        round fails — cascading multi-death inside a single round is rarer
        than the stall a recovery chain would risk."""
        t_rec = time.monotonic()
        deposed_id, deposed_addr = group.members[0]
        self._note_deposed(deposed_id, deposed_addr, reason)
        if group.gen >= self.MAX_RECOVERY_GEN:
            self.recoveries_failed += 1
            raise RPCError(
                f"recovery generation cap ({self.MAX_RECOVERY_GEN}) reached "
                f"for epoch {group.epoch}"
            )
        survivors = [(p, a) for p, a in group.members if p != deposed_id]
        if len(survivors) < self.min_group:
            self.recoveries_failed += 1
            raise RPCError(
                f"leader down and only {len(survivors)} survivors "
                f"(min_group {self.min_group}): round unrecoverable"
            )
        gen = group.gen + 1
        # Recovery is viable: the group genuinely moves on without this
        # leader — NOW the leadership strike is warranted.
        self._strike_deposed(deposed_id)
        successor = self._successor(survivors)
        try:
            if successor == self.peer_id:
                result = await self._lead_recovery(
                    group, survivors, gen, weight, wire_bytes, dense_fn
                )
            else:
                result = await self._follow_recovery(
                    group, survivors, gen, weight, wire_bytes, successor
                )
        except _LeaderDown as e:
            self.recoveries_failed += 1
            raise RPCError(f"recovery round failed: {e}") from e
        except (RPCError, OSError, ValueError, asyncio.TimeoutError):
            self.recoveries_failed += 1
            raise
        if result is None:
            self.recoveries_failed += 1
            self.telemetry.event(
                "recovery_failed", epoch=group.epoch, gen=gen,
                deposed=deposed_id, reason="recovery round skipped",
            )
            return None
        dt = time.monotonic() - t_rec
        self.rounds_recovered += 1
        self.telemetry.event(
            "round_recovered", epoch=group.epoch, gen=gen,
            deposed=deposed_id, successor=successor, dt_s=round(dt, 3),
        )
        self._recovery_lat_last = dt
        self._recovery_lat_ewma = (
            dt if self._recovery_lat_ewma is None
            else self._recovery_lat_ewma + 0.25 * (dt - self._recovery_lat_ewma)
        )
        log.info(
            "sync round recovered at generation %d in %.2fs (deposed %s, "
            "successor %s)", gen, dt, deposed_id, successor,
        )
        return result

    async def _lead_recovery(
        self,
        group: Group,
        survivors: List[Tuple[str, Any]],
        gen: int,
        weight: float,
        wire_bytes,
        dense_fn: Optional[Callable[[], np.ndarray]],
    ):
        """This node is the successor: mint fresh per-member tokens (the
        deposed leader's table died with it), fan out the recovery begin,
        and re-lead the gather over the retained contributions through the
        ordinary _lead_round machinery — fenced at ``gen``."""
        if dense_fn is None:
            raise RPCError("recovery round: no dense contribution available")
        me = self.peer_id
        my_addr = next(a for p, a in survivors if p == me)
        others = [(p, a) for p, a in survivors if p != me]
        tokens = {pid: uuid.uuid4().hex for pid, _ in survivors}
        budget = self._round_budget()
        deadline = self.clock() + budget
        rgroup = Group(
            epoch=group.epoch,
            members=[(me, my_addr)] + others,
            my_index=0,
            token=tokens[me],
            member_tokens=tokens,
            deadline=deadline,
            budget=budget,
            gen=gen,
            group_id=group.group_id,
        )
        self._record_epoch_gen(group.epoch, gen)
        # Abort/re-arm: whatever round state the deposed generation left
        # under this epoch (parked pushes keyed by dead tokens, half-filled
        # streaming tiles) is fenced off and released — the recovery round
        # re-collects from scratch, so no half-folded mass from the old
        # generation can leak into the recovered result.
        old = self._rounds.pop(group.epoch, None)
        if old is not None:
            if old.stream is not None:
                old.stream.fence()
            self._release_round(old)
        begin = {
            "epoch": group.epoch,
            "gen": gen,
            "members": [[p, list(a)] for p, a in rgroup.members],
            "deadline": deadline,
            "budget": budget,
            "schema": self._schema,
        }
        reached = 0
        for pid, addr in others:
            try:
                await self.transport.call(
                    addr, "sync.recover", {**begin, "token": tokens[pid]},
                    timeout=5.0, connect_timeout=3.0,
                )
                reached += 1
            except Exception as e:  # noqa: BLE001 — per-member fan-out containment
                log.warning("recovery begin to %s failed: %s", pid, errstr(e))
        if reached + 1 < self.min_group:
            raise RPCError(
                f"recovery round: only {reached + 1} reachable survivors "
                f"(min_group {self.min_group})"
            )
        buf = await asyncio.to_thread(dense_fn)
        return await self._lead_round(rgroup, buf, weight, wire_bytes)

    async def _follow_recovery(
        self,
        group: Group,
        survivors: List[Tuple[str, Any]],
        gen: int,
        weight: float,
        wire_bytes,
        successor: Optional[str],
    ):
        """This node expects another survivor to take over: wait (bounded)
        for its recovery begin, validate it against the ORIGINAL membership
        (the begin may only shrink the group, never smuggle outsiders in or
        resurrect the deposed leader), then re-push the retained wire form
        and fetch under the new generation."""
        begin = await self._await_recover_begin(group.epoch)
        if begin is None:
            raise RPCError(
                f"no recovery begin arrived for epoch {group.epoch} "
                f"(expected successor {successor})"
            )
        try:
            rgen = int(begin.get("gen", 0))
            members = [
                (str(pid), (str(a[0]), int(a[1])))
                for pid, a in begin.get("members", [])
            ]
        except (TypeError, ValueError, IndexError):
            raise RPCError("malformed recovery begin") from None
        ids = [p for p, _ in members]
        orig = {p for p, _ in group.members}
        if (
            rgen <= group.gen
            or rgen > self.MAX_RECOVERY_GEN
            or not members
            or not set(ids) <= orig
            or group.leader_id in ids
            or self.peer_id not in ids
            or ids[0] == self.peer_id
        ):
            raise RPCError("invalid recovery begin (membership/generation)")
        self._record_epoch_gen(group.epoch, rgen)
        deadline = begin.get("deadline")
        budget = begin.get("budget")
        rgroup = Group(
            epoch=group.epoch,
            members=members,
            my_index=ids.index(self.peer_id),
            token=str(begin.get("token", "")),
            deadline=float(deadline) if isinstance(deadline, (int, float)) else None,
            budget=float(budget) if isinstance(budget, (int, float)) else None,
            gen=rgen,
            group_id=group.group_id,
        )
        new_leader_id, new_leader_addr = members[0]
        await self._push_contribution(new_leader_addr, rgroup, weight, wire_bytes)
        return await self._fetch_round_result(new_leader_addr, new_leader_id, rgroup)

    async def _await_recover_begin(self, epoch: str) -> Optional[dict]:
        parked = self._recover_parked.pop(epoch, None)
        if (
            parked is not None
            and time.monotonic() - parked[0] <= self.RECOVER_PARKED_TTL_S
        ):
            return parked[1]
        fut = self._recover_futs.get(epoch)
        if fut is None or fut.done():
            fut = self._recover_futs[epoch] = (
                asyncio.get_running_loop().create_future()
            )
        try:
            return await asyncio.wait_for(
                asyncio.shield(fut), timeout=self.RECOVERY_BEGIN_WAIT_S
            )
        except asyncio.TimeoutError:
            return None
        finally:
            if self._recover_futs.get(epoch) is fut:
                self._recover_futs.pop(epoch, None)

    def _sweep_epoch_gens(self) -> None:
        cutoff = time.monotonic() - (self.gather_timeout * 3 + 60.0)
        for k in [k for k, (ts, _) in self._epoch_gen.items() if ts < cutoff]:
            del self._epoch_gen[k]

    def _record_epoch_gen(self, epoch: str, gen: int) -> None:
        """Record an ACCEPTED recovery generation for an epoch (validated
        follow, or our own lead) — the state the sync.recover handler's
        only-advance fence checks against."""
        self._sweep_epoch_gens()
        if epoch in self._epoch_gen or len(self._epoch_gen) < self.MAX_EPOCH_GENS:
            self._epoch_gen[epoch] = (time.monotonic(), gen)

    async def _rpc_recover(self, args: dict, payload: bytes):
        """A successor's recovery begin. Membership proof is knowledge of
        the epoch — a 16-hex digest delivered only inside the original
        round's private begin messages (plus the transport HMAC when the
        swarm runs authenticated); the follower re-validates the proposed
        member list against its own original group before acting on it.
        Generations only ever advance per epoch, so a replayed or
        second-guessing begin for an already-recovered round is refused."""
        epoch = args.get("epoch")
        gen = args.get("gen")
        if (
            not isinstance(epoch, str)
            or not epoch
            or not isinstance(gen, int)
            or isinstance(gen, bool)
            or gen < 1
            or gen > self.MAX_RECOVERY_GEN
        ):
            raise RPCError("malformed recovery begin")
        self._sweep_epoch_gens()
        known = self._epoch_gen.get(epoch, (0.0, 0))[1]
        if gen <= known:
            raise RPCError(
                f"stale recovery begin (generation {gen} <= accepted {known})"
            )
        # NOT recorded here: _epoch_gen advances only when a begin is
        # ACCEPTED — validated against the original membership in
        # _follow_recovery (or minted by our own _lead_recovery). Recording
        # an unvalidated begin would let one shape-valid forgery at the
        # generation cap permanently consume the epoch's budget and block
        # the genuine successor.
        fut = self._recover_futs.get(epoch)
        if fut is not None and not fut.done():
            fut.set_result(args)
        else:
            now = time.monotonic()
            for k in [
                k for k, (ts, _) in self._recover_parked.items()
                if now - ts > self.RECOVER_PARKED_TTL_S
            ]:
                del self._recover_parked[k]
            if (
                epoch not in self._recover_parked
                and len(self._recover_parked) >= 64
            ):
                raise RPCError("parked recovery begin cap reached")
            self._recover_parked[epoch] = (now, args)
        return {"ok": True}, b""

    async def _await_remote_contribution(self, st: _Round, timeout: float) -> None:
        """Block (bounded) until at least one REMOTE contribution has
        started arriving — chunks folding into the stream, a parked dense
        buffer, or a completed sink. Chaos instrumentation only (the
        'mid_stream' phase point must fire mid-gather, not pre-arm)."""
        deadline = time.monotonic() + max(timeout, 0.0)
        while time.monotonic() < deadline:
            if st.stream_done or any(p != self.peer_id for p, _ in st.contribs):
                return
            if st.stream is not None and any(
                n for p, n in st.stream.progress().items() if p != self.peer_id
            ):
                return
            await asyncio.sleep(0.05)


class GossipAverager(AveragerBase):
    """Asynchronous pairwise gossip (config 3): no rounds, no barriers.

    Caller mixes with one random live peer per averaging point; the
    counterparty banks the caller's contribution in an inbox and folds it in
    at ITS next averaging point. Every volunteer's params drift toward the
    swarm mean without any global synchronization (Moshpit/PushSum genre).
    """

    mode = "gossip"

    # Inbox entries are un-keyed (unlike sync's (peer, token) contributions),
    # so without a dedup id a REPLAYED exchange frame — even an HMAC-valid
    # one captured within the transport auth window — would inject the same
    # stale vector repeatedly. Every exchange carries a fresh xid; seen xids
    # are remembered (bounded by count and age) and duplicates rejected.
    _XID_TTL_S = 600.0
    _XID_CAP = 4096

    def __init__(self, *a, seed: int = 0, **kw):
        super().__init__(*a, **kw)
        self._inbox: List[Tuple[float, np.ndarray]] = []
        self._current: Optional[Tuple[float, np.ndarray]] = None
        self._rng = random.Random(seed ^ hash(self.peer_id))
        self._seen_xids: Dict[str, float] = {}
        self.transport.register("gossip.exchange", self._rpc_exchange)

    def publish(self, tree: Any, weight: float = 1.0) -> None:
        """Make this peer's params available to exchanges BEFORE its own
        first averaging point. Without this a peer busy compiling serves
        every incoming exchange 'no params published yet' — under startup
        skew two peers can each burn ALL their rounds against the other's
        unpublished window and finish having never mixed (observed as an
        e2e flake before this existed). The volunteer publishes its post-
        state-sync snapshot right after joining (params mode only)."""
        buf = self._pack(tree)
        self._current = (weight, self._wire_roundtrip(buf))

    def _xid_seen(self, xid: str) -> bool:
        return xid in self._seen_xids

    def _xid_record(self, xid: str) -> None:
        now = time.monotonic()
        if len(self._seen_xids) >= self._XID_CAP:
            cutoff = now - self._XID_TTL_S
            self._seen_xids = {k: t for k, t in self._seen_xids.items() if t >= cutoff}
            while len(self._seen_xids) >= self._XID_CAP:  # still full: drop oldest
                self._seen_xids.pop(min(self._seen_xids, key=self._seen_xids.get))
        self._seen_xids[xid] = now

    async def _rpc_exchange(self, args: dict, payload: bytes):
        if not self._check_schema(args):
            raise RPCError("schema mismatch")
        xid = args.get("xid")
        if not isinstance(xid, str) or not xid:
            raise RPCError("missing exchange id")
        if self._current is None:
            raise RPCError("peer has no params published yet")
        my_w, my_buf = self._current
        if self._xid_seen(xid):
            # A seen xid is either the transport's transparent retry of an
            # exchange whose response was lost (the caller's vector IS
            # banked — failing here would skew the mix it already entered),
            # or a replayed frame. Both get the idempotent answer: serve
            # our half WITHOUT banking, so the same vector can never enter
            # the inbox twice no matter how often the frame is repeated.
            return {"weight": my_w}, await self._encode_wire_stream(my_buf)
        inbuf = await self._decode_payload(payload)
        if inbuf.size != my_buf.size:
            # Invalid exchanges never record their xid: a corrected retry
            # under the same xid gets a fresh verdict, not a silent serve.
            raise RPCError(f"buffer size {inbuf.size} != local {my_buf.size}")
        if not self._xid_seen(xid):  # re-check: a twin ran during the decode
            self._xid_record(xid)
            if len(self._inbox) < self.MAX_PARKED_CONTRIBS:
                self._inbox.append((float(args["weight"]), inbuf))
            else:
                # Inbox full (peer long between averaging points — e.g.
                # still compiling after publish()): serve OUR half of the
                # exchange but drop theirs, bounding banked param-sized
                # buffers. Push-pull degrades to pull-only instead of
                # growing without bound.
                log.debug("gossip inbox full (%d); dropping incoming contribution",
                          len(self._inbox))
        # Lazy stream on the dense wires: the reply's chunks are encoded
        # while the transport writes earlier ones, instead of a full encode
        # before the first response byte moves.
        return {"weight": my_w}, await self._encode_wire_stream(my_buf)

    def _mix(self, w1, b1, w2, b2) -> Tuple[float, np.ndarray]:
        total = w1 + w2
        return total, (b1 * (w1 / total) + b2 * (w2 / total))

    async def average(self, tree: Any, round_no: int, weight: float = 1.0) -> Optional[Any]:
        inbox, self._inbox = self._inbox, []

        def _fold():
            buf = self._pack(tree)
            w = weight
            # 1. fold in whatever neighbours pushed since last time
            for iw, ibuf in inbox:
                if ibuf.size != buf.size:  # banked before our schema changed
                    continue
                w, buf = self._mix(w, buf, iw, ibuf)
            return w, buf

        # Payload-scale flatten + up to inbox-cap mixes: off the loop.
        w, buf = await asyncio.to_thread(_fold)
        self._current = (w, buf)
        # 2. push-pull with one random live peer — same-namespace peers only.
        # Gossip has no rendezvous key, so the namespace filter happens here:
        # a namespaced averager requires the record's avg_ns (membership
        # extra_info, volunteer.py) to match EXACTLY — "model/average_what",
        # so a params-mode peer never mixes with a grads-mode one. A record's
        # model field alone is NOT enough (it can't distinguish params from
        # grads trees, which flatten to identical schemas).
        # Gossip has no leader to pre-exclude stragglers for us, so partner
        # SELECTION is where the suspicion signal lands: suspected peers
        # (phi over threshold / policy miss streak) are filtered out of the
        # candidate set — they keep receiving our published params via their
        # own pulls, we just never block a round on them.
        peers = await self.membership.alive_peers(
            include_self=False,
            exclude_suspected=self.failure_detector is not None,
        )
        targets = [
            (pid, tuple(rec["addr"]))
            for pid, rec in peers.items()
            if "addr" in rec
            and (not self.namespace or rec.get("avg_ns") == self.namespace)
            and not (
                self.resilience is not None
                and self.resilience.should_preexclude(pid)
            )
        ]
        mixed = bool(inbox)
        await self._maybe_backoff()
        if targets:
            pid, addr = self._rng.choice(targets)
            try:
                t0 = time.monotonic()
                ret, payload = await self.transport.call(
                    addr,
                    "gossip.exchange",
                    {"peer": self.peer_id, "weight": w, "schema": self._schema,
                     "xid": uuid.uuid4().hex},
                    await self._encode_wire_stream(buf),
                    # The round budget (policy-learned when attached) bounds
                    # the exchange: a stalled partner costs seconds, and the
                    # inbox fold above already banked everyone else's pushes.
                    timeout=min(self._round_budget(), self.effective_gather_timeout),
                    record_latency=False,  # bulk payload both ways
                )
                self._observe_round_time(time.monotonic() - t0)
                rbuf = await self._decode_payload(payload)
                if rbuf.size != buf.size:
                    raise RPCError(f"peer buffer size {rbuf.size} != local {buf.size}")
                w, buf = await asyncio.to_thread(
                    self._mix, w, buf, float(ret["weight"]), rbuf
                )
                self._current = (w, buf)
                mixed = True
                self._last_outcomes = {"on_time": [pid]}
                self._flush_round_outcome(time.monotonic() - t0, ok=True)
            except (RPCError, OSError, ValueError, asyncio.TimeoutError) as e:
                log.info("gossip with %s failed (%s)", pid, errstr(e))
                self._observe_round_failure()
                self._last_outcomes = {"absent": [pid]}
                self._flush_round_outcome(time.monotonic() - t0, ok=False)
        if not mixed:
            self.rounds_skipped += 1
            return None
        self.rounds_ok += 1
        return await asyncio.to_thread(self._unpack, buf)


class ButterflyAverager(AveragerBase):
    """Butterfly (hypercube) allreduce (config 4).

    log2(n) pairwise stages; at stage s, peer i exchanges its running
    weighted average with peer i XOR 2^s. Bandwidth is balanced (every peer
    moves ~log n buffers — no leader hotspot), and heterogeneous/absent
    partners cost ONE skipped stage, not the round: with a partial butterfly
    each peer still holds the average of a 2^k subset, which contracts
    variance every round (Moshpit SGD's argument, PAPERS.md:9).
    """

    mode = "butterfly"

    def __init__(self, *a, stage_timeout: float = 8.0, **kw):
        super().__init__(*a, **kw)
        self.stage_timeout = stage_timeout
        # (epoch, stage) -> {"ready": Event, "buf":, "w":, "done": Event, "in": (w, buf)}
        self._stages: Dict[Tuple[str, int], dict] = {}
        self.transport.register("bfly.exchange", self._rpc_exchange)

    def _stage_state(self, epoch: str, stage: int, *, remote: bool = False) -> dict:
        key = (epoch, stage)
        if key not in self._stages:
            if remote:
                # Same asymmetry the byz path had in round 1: every (epoch,
                # stage) a remote names allocates state AND pins the handler
                # task for stage_timeout — and the local sweep only runs
                # inside average(), which a peer that stops averaging never
                # calls. Sweep on the RPC path and cap remotely-created
                # entries (buf is None until the LOCAL peer reaches the
                # stage, so "parked" is exactly that predicate), mirroring
                # MAX_PARKED_ROUNDS on the gather paths.
                self._sweep_stages()
                parked = sum(1 for s in self._stages.values() if s["buf"] is None)
                if parked >= self.MAX_PARKED_ROUNDS:
                    raise RPCError("parked stage cap reached")
            self._stages[key] = {
                "ready": asyncio.Event(),
                "done": asyncio.Event(),
                "buf": None,
                "w": None,
                "in": None,
                "t0": time.monotonic(),
            }
        return self._stages[key]

    def _sweep_stages(self) -> None:
        # A partner's exchange for a round we never joined leaves a stage
        # entry behind after its handler times out — evict by age.
        cutoff = time.monotonic() - (self.stage_timeout * 4 + 30.0)
        for key in [k for k, st in self._stages.items() if st["t0"] < cutoff]:
            del self._stages[key]

    async def _rpc_exchange(self, args: dict, payload: bytes):
        if not self._check_schema(args):
            raise RPCError("schema mismatch")
        st = self._stage_state(args["epoch"], int(args["stage"]), remote=True)
        # Wait until the local peer reaches this stage (it may be behind).
        await asyncio.wait_for(st["ready"].wait(), timeout=self.stage_timeout)
        inbuf = await self._decode_payload(payload)
        if inbuf.size != st["buf"].size:
            raise RPCError(f"buffer size {inbuf.size} != local {st['buf'].size}")
        st["in"] = (float(args["weight"]), inbuf)
        st["done"].set()
        return {"weight": st["w"]}, await self._encode_wire_stream(st["buf"])

    @staticmethod
    def _mix(w1: float, b1: np.ndarray, w2: float, b2: np.ndarray) -> Tuple[float, np.ndarray]:
        total = w1 + w2
        # Same expression on both sides of the pair -> bitwise-identical
        # results (float + and * are commutative), so the pair stays in sync.
        # With wire=bf16 this holds because average() round-trips the LOCAL
        # buffer through the codec before mixing — each side mixes the same
        # (quantized-mine, quantized-theirs) pair.
        return total, (b1 * (w1 / total) + b2 * (w2 / total))

    def _stage_wait(self, group: Group, stage: int, n_stages: int) -> float:
        """Per-stage wait under the round deadline: the remaining budget is
        split evenly over the stages still to run (a straggler at stage 0
        must not eat the whole round's budget and starve stages 1..k), and
        ``stage_timeout`` stays the per-stage ceiling."""
        remaining = self._deadline_remaining(group)  # skew-guarded
        if remaining is None:
            return self.stage_timeout
        stages_left = max(n_stages - stage, 1)
        return float(min(self.stage_timeout, max(remaining / stages_left, 0.5)))

    async def average(self, tree: Any, round_no: int, weight: float = 1.0) -> Optional[Any]:
        self._sweep_stages()
        await self._maybe_backoff()
        round_key = await self._rendezvous()
        group = await self._form_group(round_key)
        if group is None:
            self.rounds_skipped += 1
            self._last_outcomes = None
            self._note_group_round(None)
            return None
        # Round proper starts AFTER formation (same vantage as sync/byz):
        # the policy's deadline estimate must learn exchange time, not
        # matchmaking settle/join time.
        t0 = time.monotonic()
        buf = self._pack(tree)
        w = float(weight)
        n = group.size
        n_stages = max((n - 1).bit_length(), 1)
        mixed_any = False
        missed_partners: List[str] = []
        on_time_partners: List[str] = []
        for s in range(n_stages):
            partner_idx = group.my_index ^ (1 << s)
            if partner_idx >= n:
                continue
            partner_id, partner_addr = group.members[partner_idx]
            buf = await asyncio.to_thread(self._wire_roundtrip, buf)
            st = self._stage_state(group.epoch, s)
            st["buf"], st["w"] = buf, w
            st["ready"].set()
            stage_wait = self._stage_wait(group, s, n_stages)
            try:
                if group.my_index < partner_idx:
                    ret, payload = await self.transport.call(
                        partner_addr,
                        "bfly.exchange",
                        {
                            "epoch": group.epoch,
                            "stage": s,
                            "peer": self.peer_id,
                            "weight": w,
                            "schema": self._schema,
                        },
                        await self._encode_wire_stream(buf),
                        timeout=stage_wait,
                        # Bulk payload, and the partner may legitimately
                        # park until it reaches this stage.
                        record_latency=False,
                    )
                    pw, pbuf = float(ret["weight"]), await self._decode_payload(payload)
                else:
                    await asyncio.wait_for(st["done"].wait(), timeout=stage_wait)
                    pw, pbuf = st["in"]
                if pbuf.size != buf.size:
                    raise RPCError(f"partner buffer size {pbuf.size} != local {buf.size}")
                w, buf = await asyncio.to_thread(self._mix, w, buf, pw, pbuf)
                mixed_any = True
                on_time_partners.append(partner_id)
            except (RPCError, OSError, ValueError, asyncio.TimeoutError) as e:
                log.info(
                    "butterfly round %d stage %d with %s failed (%s); skipping stage",
                    round_no, s, partner_id, errstr(e),
                )
                missed_partners.append(partner_id)
            finally:
                self._stages.pop((group.epoch, s), None)
        self._round_degraded = bool(missed_partners) and mixed_any
        self._last_outcomes = {
            "on_time": on_time_partners,
            "absent": missed_partners,
        }
        if not mixed_any:
            self.rounds_skipped += 1
            self._flush_round_outcome(time.monotonic() - t0, ok=False)
            self._note_group_round(False, size=group.size)
            return None
        self.rounds_ok += 1
        if self._round_degraded:
            self.rounds_degraded += 1
        self._flush_round_outcome(time.monotonic() - t0, ok=True)
        self._note_group_round(
            True, degraded=self._round_degraded, size=group.size
        )
        return await asyncio.to_thread(self._unpack, buf)


class ByzantineAverager(AveragerBase):
    """Full-mesh robust aggregation (config 5): no trusted leader.

    Every member pushes its contribution to every other member; each member
    independently applies the robust estimator (trimmed mean by default;
    median/krum/geometric_median via ``method=``) to whatever arrived by the
    deadline. A Byzantine peer can send garbage — the estimator bounds its
    influence — and, unlike leader-gather, no single peer computes the
    aggregate for others. Identity limits without a PKI: a contribution can
    never claim the receiver's own id and can never overwrite an
    already-received entry (first write wins), so impersonating an honest
    peer requires beating its first push in a race, per round, per receiver.
    """

    mode = "byzantine"

    def __init__(self, *a, **kw):
        kw.setdefault("method", "trimmed_mean")
        super().__init__(*a, **kw)
        self._rounds: Dict[str, _Round] = {}
        self.transport.register("byz.contribute", self._rpc_contribute)

    async def _rpc_contribute(self, args: dict, payload: bytes):
        if not self._check_schema(args):
            raise RPCError("schema mismatch")
        peer = args["peer"]
        # A remote push may never claim OUR identity, and may never REPLACE a
        # contribution that already arrived (first write wins): with no PKI on
        # the WAN an attacker can still race an honest peer's first push, but
        # it cannot overwrite the honest value afterwards — and the robust
        # estimator bounds whatever single rows it does land.
        if peer == self.peer_id:
            raise RPCError("contribution claims receiver's own identity")
        # Contribution can arrive before we enter the round: park it
        # (swept + capped against fabricated-epoch flooding).
        st = self._get_or_park_round(self._rounds, args["epoch"])
        if st.expected and peer not in st.expected:
            # Round membership is known: reject outsiders outright instead of
            # parking them (they'd be dropped at aggregation anyway).
            raise RPCError("peer is not a member of this round")
        if peer in st.contribs:
            raise RPCError("duplicate contribution for peer (first write wins)")
        if not st.expected and len(st.contribs) >= self.MAX_PARKED_CONTRIBS:
            raise RPCError("round contribution cap reached")
        buf = await self._decode_payload(payload)
        # Re-check after the await: first write wins, so a contribution that
        # landed while we decoded keeps its slot and THIS one is the forgery
        # (or a pointless retry) — refuse rather than overwrite.
        if peer in st.contribs:
            raise RPCError("duplicate contribution for peer (first write wins)")
        if not st.expected and len(st.contribs) >= self.MAX_PARKED_CONTRIBS:
            raise RPCError("round contribution cap reached")
        st.contribs[peer] = (float(args["weight"]), buf)
        if buf is None:
            # Pre-schema powersgd push: park the raw payload for
            # _decode_deferred (decode amplification is the attack here;
            # raw bytes cost the sender its own bandwidth).
            st.payloads[peer] = payload
        if st.expected and set(st.contribs) >= st.expected:
            st.full.set()
        return {"ok": True}, b""

    async def average(self, tree: Any, round_no: int, weight: float = 1.0) -> Optional[Any]:
        self._sweep_rounds(self._rounds)
        # Same fencing contract as the sync path: staged controller
        # decisions (regime -> hedge floor, wire, cadence when a schedule
        # is attached) promote HERE, before this round's rendezvous.
        self._apply_controller()
        await self._maybe_backoff()
        round_key = await self._rendezvous()
        group = await self._form_group(round_key)
        if group is None:
            self.rounds_skipped += 1
            self._last_outcomes = None
            self._note_group_round(None)
            return None
        buf, wire_bytes, sent = await self._pack_and_compress(tree)
        st = self._rounds.get(group.epoch)
        if st is None:
            st = self._rounds[group.epoch] = _Round([])
        st.expected = set(pid for pid, _ in group.members)
        st.contribs[self.peer_id] = (weight, await asyncio.to_thread(sent))
        if set(st.contribs) >= st.expected:
            st.full.set()

        args = {
            "epoch": group.epoch,
            "peer": self.peer_id,
            "weight": weight,
            "schema": self._schema,
        }

        async def push(addr):
            try:
                await self.transport.call(
                    addr, "byz.contribute", args, wire_bytes,
                    timeout=self._deadline_wait(group, floor=1.0),
                    record_latency=False,  # bulk payload leg
                )
            except (RPCError, OSError, ValueError, asyncio.TimeoutError) as e:
                log.info("byz push to %s failed: %s", addr, errstr(e))

        t0 = time.monotonic()
        degraded = False
        await asyncio.gather(
            *(push(addr) for pid, addr in group.members if pid != self.peer_id)
        )
        try:
            # Every member closes its gather at the SAME consensus-clock
            # deadline (the full-mesh twin of the sync leader's commit).
            await asyncio.wait_for(
                st.full.wait(), timeout=self._deadline_wait(group)
            )
        except asyncio.TimeoutError:
            degraded = True  # deadline commit: aggregate the arrived subset
        # Resolve pre-schema-parked powersgd payloads (exact-size-capped now
        # that our own pack fixed the specs).
        await self._decode_deferred(st)
        received = {
            p: c
            for p, c in st.contribs.items()
            # c[1] None: unresolved deferred entry (see _leader_round note).
            if p in st.expected and c[1] is not None and c[1].size == buf.size
        }
        self._rounds.pop(group.epoch, None)
        excluded = sorted(
            p for p in st.expected if p not in received and p != self.peer_id
        )
        self._round_degraded = degraded
        self._last_outcomes = {
            "on_time": [p for p in sorted(received) if p != self.peer_id],
            "absent": excluded,
        }
        if len(received) < self.min_group:
            self.rounds_skipped += 1
            self._observe_round_failure()
            self._commit_ef(False)
            self._flush_round_outcome(time.monotonic() - t0, ok=False)
            self._note_group_round(False, size=group.size)
            return None
        self._commit_ef(True)
        if excluded:
            log.info(
                "byzantine round committed at deadline without %s (%d/%d)",
                excluded, len(received), len(st.expected),
            )
        peers = sorted(received)
        method, kw = self._effective_method(len(peers))
        if method == "mean":
            kw["weights"] = np.array([received[p][0] for p in peers])
        self.rounds_ok += 1
        if degraded:
            self.rounds_degraded += 1
        else:
            self._observe_round_time(time.monotonic() - t0)
        stack = np.stack([received[p][1] for p in peers])

        def _aggregate_and_flag():
            out = self.mesh_codec.aggregate(stack, method, **kw)
            qmap: Dict[str, float] = {}
            if method != "mean" and len(peers) >= 3:
                # Estimator-rejection feedback for the policy: rows far from
                # the robust aggregate (>3x the median row DISTANCE) were
                # effectively voted out — Chameleon's observed-failure
                # signal for escalating/keeping the estimator. The median
                # is taken in distance space (even group sizes average two
                # middle values, so median(d²) would be a strictly looser
                # bar than median(d)²); the squared distances double as
                # the contribution-quality votes.
                d2 = health_mod.row_d2(stack, out)
                qmap = {peers[i]: float(d2[i]) for i in range(len(peers))}
                med2 = float(np.median(np.sqrt(d2))) ** 2
                if med2 > 0:
                    return out, [
                        peers[i] for i in np.nonzero(d2 > 9.0 * med2)[0]
                        if peers[i] != self.peer_id
                    ], qmap
            return out, [], qmap

        agg, outliers, qmap = await asyncio.to_thread(_aggregate_and_flag)
        if outliers and self.resilience is not None:
            for p in outliers:
                self.resilience.record_rejection(p)
        if self.health is not None and self.health.enabled:
            # Full-mesh vantage: every member attributes quality and mass
            # independently (no trusted leader — that is the point).
            await asyncio.to_thread(
                self._health_note_commit, agg, group.epoch,
                health_mod.mass_from_outcomes(
                    st.expected, {p: float(received[p][0]) for p in received}
                ),
                qmap or None,
            )
        self._flush_round_outcome(time.monotonic() - t0, ok=True)
        self._note_group_round(True, degraded=degraded, size=group.size)
        return await asyncio.to_thread(lambda: self._unpack(agg))


AVERAGERS = {
    "sync": SyncAverager,
    "gossip": GossipAverager,
    "butterfly": ButterflyAverager,
    "byzantine": ByzantineAverager,
}


def make_averager(mode: str, transport, dht, membership, **kw) -> AveragerBase:
    if mode not in AVERAGERS:
        raise KeyError(f"unknown averaging mode {mode!r}; known: {sorted(AVERAGERS)}")
    return AVERAGERS[mode](transport, dht, membership, **kw)
