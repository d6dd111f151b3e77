"""Volunteer lifecycle: join the swarm -> train with periodic averaging -> leave
(ported from ``distributedvolunteercomputing_tpu/swarm/volunteer.py``).

Threading model, as in the reference: the asyncio loop (transport, DHT,
membership heartbeats, averaging RPC handlers, the report loop) owns the
calling thread; the blocking train loop runs in a worker thread and bridges
into the loop once per averaging round through ``run_coroutine_threadsafe``.
Readers on the loop thread (the state-sync provider, the report) touch only
the trainer's host snapshot and plain ints, never its tensors: the step
updates them in place. On SIGTERM (a preemption notice) the volunteer stops
after its current step, saves a final checkpoint, leaves and exits.

``start`` follows the reference's order: transport, the local metrics
endpoint (``metrics_port``), the DHT joined through the coordinator(s), the
control-plane client (and a replica when ``host_replica``), the resilience
layer (``resilience``: the phi-accrual detector, the policy and, with
``adapt``, the controller), membership with the report beat, the clock
sync under the wall-clock cadence, the averager, then the codec on this
volunteer's device or its mesh's ranks (``mesh_codec.configure``: the bf16
encode and the leader's fold run as CUDA kernels on the card; with two or
more ranks and ``mesh_collective`` "ring" or "auto" the fold is the ring,
K6/K7), the trainer with the checkpoint cadence, the restore of the newest
checkpoint, the state-sync pull from the freshest peer ahead and the
announce (and, in gossip, the first publish), the watchdog's probes, and
the report loop.

Ported so far: every averaging mode (sync, gossip, butterfly, byzantine)
on every wire of the reference (f32, bf16 and q8; the gradient compressors
topk, powersgd and sign with error feedback, PowerSGD's power iteration on
the codec's device), of params or (``average_what="grads"``) of every
step's gradients, the step and wall-clock cadences, blocking or overlapped
rounds, the outer Nesterov optimizer over params rounds, multi-step calls,
``.npz`` data with a held-out eval stream, the robust estimators, the
resilience layer and controller, rotating group schedules
(``group_size``, ``group_rotation_s``) and their zone hierarchy (``zone``,
``cross_zone_every_k``), zone-sharded training (``zone_shards``: a
``ShardManager`` holds this volunteer's shards and scopes its groups), a
local mesh over dp, tp and ep with ``fsdp``, the coordinator and
control plane, checkpoints, state sync and the reference's fault-injection
hooks (read from the environment, test-only):
``DVC_CHAOS_CONTRIB_SCALE=<x>`` contributes the real tree scaled by x;
``DVC_STEP_DELAY_MS=<ms>`` sleeps that long after each step;
``DVC_CHAOS_STATE_POISON=<lie>,<scale>`` serves state sync at step + lie
with the tree scaled; ``DVC_CLOCK_SKEW_S=<s>`` skews the local clock under
the wall-clock cadence; the averager's ``DVC_CHAOS_LEADER_DIE_PHASE=<phase>``
SIGKILLs a sync leader at that round phase. FSDP and sequence parallelism
come with a later slice; ``VolunteerConfig`` raises ``NotImplementedError``
when one of them is set away from its default.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import os
import signal
import threading
import time
import uuid
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.ops import flash_attention
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mesh_codec_mod
from distributedvolunteercomputing_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape, parse_mesh_spec
from distributedvolunteercomputing_tpu_torch.swarm.averager import make_averager
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.matchmaking import GroupSchedule
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm.state_sync import StateSyncService
from distributedvolunteercomputing_tpu_torch.swarm.telemetry import Telemetry
from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport, read_secret
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_map
from distributedvolunteercomputing_tpu_torch.utils.torchenv import DeviceLike

log = get_logger(__name__)

PORTED = (
    "averaging none|sync|gossip|butterfly|byzantine, wire f32|bf16|q8|topk|powersgd|sign, "
    "average_what params|grads, the step and wall-clock cadences, overlap, steps_per_call, "
    "the outer optimizer, .npz data, eval, robust methods, the resilience layer and "
    "controller, group schedules and zones, zone sharding, a dp/tp/ep mesh and fsdp, the coordinator "
    "and control plane, checkpoints, state sync, telemetry, health probe and watchdog"
)

# The wall-clock cadence AUTO resolves to for butterfly params-mode swarms.
DEFAULT_BUTTERFLY_INTERVAL_S = 20.0

# The reference's options that later slices carry: field -> (default, what).
# Set away from its default, each raises NotImplementedError.
LATER_SLICES: Dict[str, tuple] = {
    "seq_sharded": (False, "sequence parallelism"),
    "sp_impl": ("ring", "sequence parallelism"),
}

# The reference's codec backends -> the port's (the card's kernels are its mesh).
_CODEC_BACKENDS = {"auto": "auto", "mesh": "device", "host": "host"}


@dataclasses.dataclass
class VolunteerConfig:
    model: str = "gpt2_small"
    model_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # "host:port[,host:port...]" — several = several DHT bootstrap nodes
    # (join works while ANY is alive); None = run standalone.
    coordinator: Optional[str] = None
    host: str = "127.0.0.1"
    port: int = 0
    advertise_host: Optional[str] = None  # dialable address when binding 0.0.0.0
    peer_id: str = ""
    averaging: str = "none"  # none | sync | gossip | butterfly | byzantine
    average_every: int = 10
    # Wall-clock cadence in seconds (0 = the step cadence above): rounds
    # fire when the consensus clock crosses a multiple of it. None = AUTO:
    # DEFAULT_BUTTERFLY_INTERVAL_S for butterfly params mode, else 0.
    average_interval_s: Optional[float] = None
    average_what: str = "params"  # params (local SGD) | grads (GradientAverager)
    # Overlap rounds with local steps (the reference's default, on).
    overlap: bool = True
    max_staleness: int = 0  # steps; 0 = unbounded
    wire: str = "f32"  # f32 | bf16 | q8 | topk | powersgd | sign
    topk_frac: float = 0.01
    topk_warmup_rounds: int = 0
    powersgd_rank: int = 4
    min_group: int = 2
    max_group: int = 16
    group_size: int = 0
    group_rotation_s: float = 0.0
    zone: str = ""
    cross_zone_every_k: int = 0
    zone_shards: int = 0
    batch_size: int = 32
    steps_per_call: int = 1
    accum_steps: int = 1  # gradient-accumulation microbatches inside the step
    data_path: Optional[str] = None  # .npz of aligned arrays; None = synthetic
    optimizer: str = "adam"
    lr: float = 1e-3
    seed: int = 0  # per-volunteer: data order + step rng
    init_seed: int = 0  # task-constant: shared initial params
    param_dtype: Optional[str] = None  # e.g. "bfloat16" for bf16 training
    steps: int = 1000
    target_loss: Optional[float] = None
    target_mode: str = "stop"  # stop | record
    eval_every: int = 0  # 0 = no held-out evaluation
    eval_batches: int = 4
    metrics_path: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 200
    heartbeat_ttl: float = 15.0
    join_timeout: float = 10.0
    gather_timeout: float = 20.0
    method: str = "mean"  # robust estimator of byzantine rounds
    # Estimator keyword overrides passed through to ops/robust.aggregate.
    method_kw: Optional[Dict[str, Any]] = None
    # Adaptive round deadlines (EWMA of successful rounds; see AveragerBase).
    adaptive_timeout: bool = False
    # The phi-accrual detector (straggler pre-exclusion) and the adaptive
    # policy (learned deadlines, backoff, estimator escalation).
    resilience: bool = False
    phi_threshold: float = 8.0  # phi at which a peer counts as suspected
    # The closed-loop controller over the policy (sync and byzantine, with
    # ``resilience``).
    adapt: bool = True
    # Static wall-clock budget per averaging round, seconds (0 = the gather
    # timeout): the leader stamps clock()+budget into the round begin.
    round_deadline_s: float = 0.0
    # DiLoCo-style outer optimizer over params-mode rounds (see Trainer).
    outer_optimizer: str = "none"  # none | nesterov
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    # Local mesh: the reference's "dp=2,tp=2"-style spec over the first
    # visible cards, or over the CPU named once per rank when ``device`` is
    # the CPU (dp, tp and ep; sp and pp are not ported), or a port ``Mesh``
    # (whose ranks may share a card); "" = one device. The swarm
    # still sees one volunteer either way. ``fsdp`` shards params and
    # optimizer over the mesh's dp axis (ZeRO-3).
    mesh: Union[str, Mesh] = ""
    # The swarm data path's backend: "auto" (the card's kernels on a card,
    # host numpy on the CPU), "mesh" (the card's kernels), "host".
    mesh_codec: str = "auto"
    # The leader's bf16 mean fold over the mesh: "ring" (K6/K7), "off" (the
    # staged per-rank fold), "auto" = ring with two or more CUDA ranks.
    mesh_collective: str = "auto"
    fsdp: bool = False
    seq_sharded: bool = False
    sp_impl: str = "ring"
    # Host a control-plane replica on this volunteer: it serves coord.status
    # and batched heartbeat traffic and stands for election, so the
    # coordinator's death is a non-event.
    host_replica: bool = False
    # Path to a file holding the shared swarm secret (transport-level HMAC).
    secret_file: Optional[str] = None
    allow_unrobust_topk: bool = False
    # Telemetry plane: round tracing, metrics registry, flight recorder.
    telemetry: bool = True
    # Training-health layer (post-round sketches, mass accounting).
    health_probe: bool = True
    # Swarm watchdog: anomaly detectors ticked on the report beat.
    watchdog: bool = True
    # Hedged recovery of predicted-late tile ranges when leading.
    hedge: bool = True
    tail_redundancy_frac: float = 0.0
    # Local Prometheus text endpoint (GET /metrics) on loopback; 0 = off.
    metrics_port: int = 0
    # The card unless "cpu" is asked for; raises when there is no card.
    device: DeviceLike = None

    def __post_init__(self):
        if not self.peer_id:
            self.peer_id = f"vol-{uuid.uuid4().hex[:8]}"
        if self.averaging not in ("none", "sync", "gossip", "butterfly", "byzantine"):
            raise ValueError(f"unknown averaging {self.averaging!r}")
        if self.average_interval_s is None:
            # AUTO: butterfly is the heterogeneous-swarm config, where the
            # step cadence parks fast peers; every other mode keeps it.
            self.average_interval_s = (
                DEFAULT_BUTTERFLY_INTERVAL_S
                if self.averaging == "butterfly" and self.average_what == "params"
                else 0.0
            )
        if self.average_interval_s < 0:
            raise ValueError(f"average_interval_s must be >= 0, got {self.average_interval_s}")
        if self.average_interval_s > 0:
            if self.average_what != "params":
                raise ValueError(
                    "--average-interval-s requires --average-what params "
                    "(gradient rounds are per-step by definition)"
                )
            if self.averaging == "none":
                raise ValueError("--average-interval-s requires an averaging mode")
        if self.phi_threshold <= 0:
            raise ValueError(f"phi_threshold must be > 0, got {self.phi_threshold}")
        if self.group_rotation_s < 0:
            raise ValueError(f"group_rotation_s must be >= 0, got {self.group_rotation_s}")
        if self.cross_zone_every_k < 0:
            raise ValueError(f"cross_zone_every_k must be >= 0 (0 = flat), got {self.cross_zone_every_k}")
        if self.cross_zone_every_k and not self.group_size:
            # The hierarchy layers the group schedule's grid: without one
            # the flag would do nothing for the whole run.
            raise ValueError(
                "--cross-zone-every-k requires --group-size (the hierarchy "
                "schedules the multi-group grid; single-group swarms have "
                "no grid to layer)"
            )
        if self.zone_shards < 0:
            raise ValueError(
                f"zone_shards must be >= 0 (0 = unsharded), got "
                f"{self.zone_shards}"
            )
        if self.zone_shards:
            # The shard domain is the zone, and the shard-scoped rendezvous
            # lives in the group schedule: without either the flag would
            # train a full replica.
            if not self.zone:
                raise ValueError(
                    "--zone-shards requires --zone (the zone is the shard "
                    "domain: shards are held within a zone and replicated "
                    "across zones)"
                )
            if self.averaging != "none" and not self.group_size:
                raise ValueError(
                    "--zone-shards with averaging requires --group-size "
                    "(same-shard holders rendezvous through the shard-"
                    "scoped group schedule)"
                )
        if self.group_size:
            # Round-structured gather modes only: gossip is pairwise and
            # "none" does not average.
            if self.group_size < 2:
                raise ValueError(f"group_size must be >= 2 (or 0 = off), got {self.group_size}")
            if self.averaging not in ("sync", "byzantine", "butterfly"):
                raise ValueError(
                    "--group-size requires --averaging sync, byzantine, or "
                    "butterfly (gossip is pairwise — there is no round-"
                    "structured group to schedule)"
                )
            if self.group_size < self.min_group:
                raise ValueError(
                    f"group_size {self.group_size} < min_group {self.min_group}: "
                    "every scheduled group would be refused at formation"
                )
            if self.group_size > self.max_group:
                raise ValueError(
                    f"group_size {self.group_size} > max_group {self.max_group}: the "
                    "leader freezes at max_group, so the surplus members of every "
                    "scheduled group would join-retry until the deadline and skip "
                    "the round"
                )
        for name, (default, what) in LATER_SLICES.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} ({what}) is not ported yet; ported: {PORTED}"
                )
        if self.round_deadline_s < 0:
            raise ValueError(f"round_deadline_s must be >= 0, got {self.round_deadline_s}")
        if not (0 <= self.metrics_port <= 65535):
            raise ValueError(f"metrics_port must be in [0, 65535] (0 = off), got {self.metrics_port}")
        if self.target_mode not in ("stop", "record"):
            raise ValueError(f"unknown target_mode {self.target_mode!r}")
        if isinstance(self.mesh, Mesh) or self.mesh:
            axes = mesh_shape(self.mesh) if isinstance(self.mesh, Mesh) else parse_mesh_spec(self.mesh)
            if any(v > 1 for k, v in axes.items() if k not in ("dp", "tp", "ep")):
                raise NotImplementedError(
                    f"mesh {self.mesh!r}: the sp and pp axes (sequence parallelism, the pipeline) "
                    "are not ported yet; ported: dp, tp, ep"
                )
        if self.mesh_codec not in _CODEC_BACKENDS:
            raise ValueError(f"unknown mesh codec {self.mesh_codec!r}")
        if self.mesh_collective not in ("auto", "ring", "off"):
            raise ValueError(f"unknown mesh collective {self.mesh_collective!r}")
        # An unknown method or keyword would raise inside every round and be
        # swallowed there, leaving the volunteer training alone: fail here.
        from distributedvolunteercomputing_tpu_torch.ops import robust

        if self.method not in robust.AGGREGATORS:
            raise ValueError(f"unknown --method {self.method!r}; known: {sorted(robust.AGGREGATORS)}")
        if self.method_kw:
            import inspect

            allowed = set(inspect.signature(robust.AGGREGATORS[self.method]).parameters) - {"stack", "weights"}
            unknown = set(self.method_kw) - allowed
            if unknown:
                raise ValueError(
                    f"--method-kw keys {sorted(unknown)} are not accepted by method {self.method!r} "
                    f"(accepts: {sorted(allowed)})"
                )
        if self.outer_optimizer != "none":
            if self.average_what != "params":
                raise ValueError("--outer-optimizer requires --average-what params")
            if self.averaging not in ("sync", "byzantine"):
                # The outer step assumes every member adopts one common
                # aggregate per round; gossip and butterfly results are
                # pairwise or subset averages, and momentum over them
                # amplifies the disagreement.
                raise ValueError(
                    "--outer-optimizer requires --averaging sync or byzantine "
                    "(gossip/butterfly rounds are pairwise/subset averages, "
                    "not a common aggregate — momentum over them amplifies "
                    "disagreement)"
                )
        if self.wire == "powersgd":
            # Low-rank of a parameter tree would truncate the model itself,
            # and pairwise protocols compound truncation per hop; robust
            # estimators are fine (reconstructions are dense).
            if self.average_what != "grads":
                raise ValueError("wire='powersgd' requires --average-what grads")
            if self.averaging not in ("sync", "byzantine"):
                raise ValueError(
                    "wire='powersgd' requires --averaging sync or byzantine"
                )
            if self.powersgd_rank < 1:
                raise ValueError(
                    f"powersgd_rank must be >= 1, got {self.powersgd_rank}"
                )
        if self.wire == "sign":
            # 1-bit EF-signSGD is a gradient compressor for gather-style
            # protocols; robust estimators are allowed (dense ±scale rows).
            if self.average_what != "grads":
                raise ValueError("wire='sign' requires --average-what grads")
            if self.averaging not in ("sync", "byzantine"):
                raise ValueError(
                    "wire='sign' requires --averaging sync or byzantine"
                )
        if self.wire == "topk":
            # Top-k of a parameter tree would zero most of the model;
            # pairwise protocols compound truncation per hop; robust
            # estimators over sparse supports aggregate to zero.
            if self.average_what != "grads":
                raise ValueError("wire='topk' requires --average-what grads")
            if self.averaging not in ("sync", "byzantine"):
                raise ValueError(
                    "wire='topk' requires --averaging sync or byzantine"
                )
            if self.topk_warmup_rounds < 0:
                raise ValueError(
                    f"topk_warmup_rounds must be >= 0, got {self.topk_warmup_rounds}"
                )
            if self.averaging == "byzantine":
                if self.method != "mean":
                    raise ValueError("wire='topk' requires --method mean")
                if not self.allow_unrobust_topk:
                    raise ValueError(
                        "--averaging byzantine --wire topk runs a plain "
                        "weighted mean (topk forces method='mean'), i.e. NO "
                        "Byzantine tolerance; use --averaging sync with "
                        "topk, or pass --allow-unrobust-topk if you want "
                        "byzantine's full-mesh/first-write-wins transport "
                        "properties without a robust estimator"
                    )


def _parse_addrs(spec: Optional[str]) -> list:
    """``host:port[,host:port...]`` -> [(host, port), ...]. Several
    coordinators = several DHT bootstrap nodes: a volunteer can join (and a
    rejoiner can re-bootstrap) as long as ANY of them is alive."""
    if not spec:
        return []
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad coordinator address {part!r} in {spec!r}: expected host:port")
        out.append((host, int(port)))
    return out


def _spec_mesh(spec: str, device: DeviceLike) -> Mesh:
    """A ``--mesh`` spec over the first visible cards, or over the CPU named
    once per rank when ``device`` asks for the CPU."""
    axes = parse_mesh_spec(spec)
    cpu = device is not None and torch.device(device).type == "cpu"
    return make_mesh(**axes, devices=[torch.device("cpu")] * math.prod(axes.values()) if cpu else None)


class Volunteer:
    def __init__(self, cfg: VolunteerConfig):
        self.cfg = cfg
        # One telemetry bundle per volunteer: round spans, the metrics
        # registry, the flight recorder, the training-health probe and the
        # watchdog (ticked on the report beat).
        self.telemetry = Telemetry(
            peer_id=cfg.peer_id, enabled=cfg.telemetry,
            health_enabled=cfg.telemetry and cfg.health_probe,
            watchdog_enabled=cfg.telemetry and cfg.watchdog,
        )
        self._metrics_server = None
        self._loop_monitor = None
        # Structured-log identity; first volunteer of a process wins.
        from distributedvolunteercomputing_tpu_torch.utils.logging import current_log_context, set_log_fields

        if "peer" not in current_log_context():
            set_log_fields(peer=cfg.peer_id, zone=cfg.zone or None)
        self.transport = Transport(
            cfg.host, cfg.port, advertise_host=cfg.advertise_host, secret=read_secret(cfg.secret_file),
        )
        self.dht = DHTNode(self.transport)
        self.membership: Optional[SwarmMembership] = None
        self.control_plane = None  # ControlPlaneClient (failover routing)
        self.replica = None  # ControlPlaneReplica when host_replica
        self.clocksync = None  # ClockSync under the wall-clock cadence
        self.failure_detector = None
        self.resilience_policy = None
        self.controller = None
        self.averager = None
        self.shard_manager = None  # ShardManager when zone_shards
        self.state_sync: Optional[StateSyncService] = None
        self.trainer: Optional[Trainer] = None
        self._report_task: Optional[asyncio.Task] = None
        self._stop = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.summary: Dict[str, Any] = {}

    # -- averager bridge (called from the trainer thread) ------------------

    def _averager_callback(self, params, step: int):
        if self.averager is None or self._stop.is_set():
            return None
        # Fault injection (test-only): DVC_CHAOS_CONTRIB_SCALE=<x> makes this
        # volunteer Byzantine, contributing its real tree scaled by x
        # (well-formed frames, wrong values).
        chaos_scale = float(os.environ.get("DVC_CHAOS_CONTRIB_SCALE", "0") or 0.0)
        if chaos_scale:
            params = tree_map(lambda x: np.asarray(x, np.float32) * chaos_scale, params)
        # Weight = samples behind this contribution: one batch for a
        # gradient round; for a params round the trainer's actual steps since
        # the last merge (average_every on the happy step-cadence path, more
        # after failed rounds, the window's progress under the wall-clock
        # cadence).
        if self.cfg.average_what == "grads":
            per_round = 1
        else:
            per_round = max(1, getattr(self.trainer, "steps_since_merge", self.cfg.average_every))
        samples_since = self.cfg.batch_size * per_round
        fut = asyncio.run_coroutine_threadsafe(
            self.averager.average(params, round_no=step, weight=float(samples_since)),
            self._loop,
        )
        try:
            return fut.result(timeout=self.cfg.join_timeout + self.cfg.gather_timeout + 15.0)
        except Exception as e:
            log.warning("averaging at step %d failed: %s", step, errstr(e))
            return None

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """The swarm services, the codec on this volunteer's device (a
        failed kernel build raises here), the trainer, the checkpoint
        restore, the state-sync pull and the report loop."""
        self._loop = asyncio.get_running_loop()
        cfg = self.cfg
        from distributedvolunteercomputing_tpu_torch.utils.asyncio_debug import maybe_enable_from_env

        # DVC_ASYNC_DEBUG=1: loop stall/race detectors (stopped at teardown)
        self._loop_monitor = maybe_enable_from_env()
        await self.transport.start()
        self.telemetry.register_rpcs(self.transport)
        if cfg.metrics_port:
            from distributedvolunteercomputing_tpu_torch.swarm.telemetry import MetricsHTTPServer

            # Loopback ONLY: plain unauthenticated HTTP serving the whole
            # registry must not ride the volunteer's public bind address.
            self._metrics_server = MetricsHTTPServer(self.telemetry, "127.0.0.1", cfg.metrics_port)
            await self._metrics_server.start()
        await self.dht.start(bootstrap=_parse_addrs(cfg.coordinator) or None)
        from distributedvolunteercomputing_tpu_torch.swarm.control_plane import (
            ControlPlaneClient,
            ControlPlaneReplica,
        )

        # Always built: it costs nothing until a replica answers, and the
        # direct DHT path stays the fallback every beat.
        self.control_plane = ControlPlaneClient(self.transport, self.dht, cfg.peer_id)
        if cfg.host_replica:
            self.replica = ControlPlaneReplica(self.transport, self.dht, telemetry=self.telemetry)
            await self.replica.start()
        # Before membership, so the first peer records seen start the
        # heartbeat distributions.
        self._build_resilience_layer()
        namespace = f"{cfg.model}/{cfg.average_what}"
        extra_info = {"model": cfg.model, "avg_ns": namespace}
        if cfg.zone:
            # The hierarchical schedule's locality advertisement; absent on
            # unzoned volunteers, so "" never counts as a zone.
            extra_info["zone"] = cfg.zone
        self.membership = SwarmMembership(
            self.dht, cfg.peer_id, ttl=cfg.heartbeat_ttl,
            failure_detector=self.failure_detector,
            extra_info=extra_info,
            bandwidth_source=self.transport.bandwidth_advertisement,
            # Announce + report + peers snapshot coalesce into one
            # cp.exchange per heartbeat while a replica is reachable.
            control_plane=self.control_plane,
            report_source=self._build_report,
            telemetry=self.telemetry,
        )
        await self.membership.join()
        if cfg.average_interval_s > 0:
            # The wall-clock cadence's boundaries are on swarm-consensus time
            # (swarm/clocksync.py). DVC_CLOCK_SKEW_S (test-only) skews the
            # local clock.
            from distributedvolunteercomputing_tpu_torch.swarm.clocksync import ClockSync

            skew = float(os.environ.get("DVC_CLOCK_SKEW_S", "0") or "0")
            clock = (lambda: time.time() + skew) if skew else time.time
            self.clocksync = ClockSync(self.transport, self.membership, clock=clock)
            # The first boundary this volunteer arms is already on swarm time.
            await self.clocksync.estimate()
            self.clocksync.start(interval_s=max(cfg.heartbeat_ttl, 15.0))
            self.telemetry.set_clock(self.clocksync.now)
        if cfg.averaging != "none":
            kw = dict(
                min_group=cfg.min_group, max_group=cfg.max_group,
                join_timeout=cfg.join_timeout, gather_timeout=cfg.gather_timeout,
                wire=cfg.wire, topk_frac=cfg.topk_frac, topk_warmup_rounds=cfg.topk_warmup_rounds,
                powersgd_rank=cfg.powersgd_rank, adaptive_timeout=cfg.adaptive_timeout,
                # Round deadlines on the consensus clock when there is one.
                clock=self.clocksync.now if self.clocksync is not None else None,
                round_deadline_s=cfg.round_deadline_s or None,
                resilience=self.resilience_policy, failure_detector=self.failure_detector,
                controller=self.controller,
                control_plane=self.control_plane, telemetry=self.telemetry,
                hedge=cfg.hedge, tail_redundancy_frac=cfg.tail_redundancy_frac,
                namespace=namespace,
            )
            if cfg.group_size:
                # Rotations on the consensus clock when there is one: every
                # member of a prospective group must land in the same window.
                kw["group_schedule"] = GroupSchedule(
                    target_size=cfg.group_size,
                    rotation_s=cfg.group_rotation_s or (cfg.average_interval_s or 15.0),
                    clock=self.clocksync.now if self.clocksync is not None else time.time,
                    min_size=cfg.min_group,
                    cross_zone_every_k=cfg.cross_zone_every_k,
                )
            if cfg.averaging == "byzantine" and (cfg.method != "mean" or cfg.wire == "topk"):
                # Passed explicitly for topk: the Byzantine averager's default
                # is trimmed_mean, which the topk wire must not run under.
                kw["method"] = cfg.method
            if cfg.method_kw:
                kw["method_kw"] = dict(cfg.method_kw)
            self.averager = make_averager(cfg.averaging, self.transport, self.dht, self.membership, **kw)
        bundle = get_model(cfg.model, **cfg.model_overrides)
        on_step = None
        if cfg.checkpoint_dir and cfg.checkpoint_every > 0:
            from distributedvolunteercomputing_tpu_torch.training.checkpoint import save_async

            ckpt_dir, every = cfg.checkpoint_dir, cfg.checkpoint_every

            def on_step(trainer, step_no):
                # Periodic snapshot: the host copy here, the file write on
                # a background thread.
                if step_no % every == 0:
                    save_async(trainer, ckpt_dir)

        # Heterogeneity injection (test-only): DVC_STEP_DELAY_MS=<x> slows
        # this volunteer by x ms per step.
        delay_ms = float(os.environ.get("DVC_STEP_DELAY_MS", "0") or 0.0)
        if delay_ms > 0:
            prev_on_step = on_step

            def on_step(trainer, step_no, _prev=prev_on_step):  # noqa: F811
                time.sleep(delay_ms / 1e3)
                if _prev is not None:
                    _prev(trainer, step_no)

        data = eval_data = None
        if cfg.data_path:
            import zlib

            from distributedvolunteercomputing_tpu_torch.training.data import npz_batch_iter

            # Seeded per peer, so volunteers see the whole file in different
            # orders; crc32, not hash(), so the order survives a restart.
            data_seed = zlib.crc32(cfg.peer_id.encode()) & 0x7FFFFFFF
            data = npz_batch_iter(cfg.data_path, cfg.batch_size, seed=data_seed)
            if cfg.eval_every:
                # An independent shuffle of the same file: eval never
                # perturbs the training order.
                eval_data = npz_batch_iter(cfg.data_path, cfg.batch_size, seed=data_seed ^ 0x5EED)
        mesh = cfg.mesh if isinstance(cfg.mesh, Mesh) else _spec_mesh(cfg.mesh, cfg.device) if cfg.mesh else None
        # The averager resolves the process default lazily, so configuring
        # here covers the averager built above.
        codec = mesh_codec_mod.configure(
            device=None if mesh is not None else cfg.device,
            backend=_CODEC_BACKENDS[cfg.mesh_codec],
            mesh=mesh,
            collective=cfg.mesh_collective,
        )
        log.info(
            "swarm data path: %s backend on %d rank(s) from %s, collective %s",
            codec.backend, codec.nd, codec.device, codec.collective,
        )
        self.trainer = Trainer(
            bundle,
            batch_size=cfg.batch_size,
            optimizer=cfg.optimizer,
            lr=cfg.lr,
            seed=cfg.seed,
            init_seed=cfg.init_seed,
            param_dtype=cfg.param_dtype,
            accum_steps=cfg.accum_steps,
            total_steps=cfg.steps,
            metrics_path=cfg.metrics_path,
            volunteer_id=cfg.peer_id,
            device=cfg.device,
            mesh=mesh,
            fsdp=cfg.fsdp,
            data=data,
            averager=self._averager_callback if self.averager is not None else None,
            average_what=cfg.average_what,
            average_every=cfg.average_every,
            average_interval_s=cfg.average_interval_s,
            wall_clock=self.clocksync.now if self.clocksync is not None else None,
            steps_per_call=cfg.steps_per_call,
            # The checkpoint cadence lives inside on_step, where chunk sizing
            # cannot see it: declare it so chunks end there. The step-delay
            # hook sleeps inside on_step too: a cadence of 1 keeps it per
            # step (and visible to the wall-clock cadence's step-time EMA).
            chunk_cadences=(
                ((cfg.checkpoint_every,) if cfg.checkpoint_dir and cfg.checkpoint_every > 0 else ())
                + ((1,) if delay_ms > 0 else ())
            ),
            overlap=cfg.overlap,
            max_staleness=cfg.max_staleness,
            on_step=on_step,
            eval_every=cfg.eval_every,
            eval_batches=cfg.eval_batches,
            eval_data=eval_data,
            outer_optimizer=cfg.outer_optimizer,
            outer_lr=cfg.outer_lr,
            outer_momentum=cfg.outer_momentum,
        )
        if self.averager is not None:
            # The checkpoint sidecars reach the averager's wire state here.
            self.trainer._wire_averager = self.averager
        if cfg.checkpoint_dir:
            from distributedvolunteercomputing_tpu_torch.training.checkpoint import maybe_restore

            maybe_restore(self.trainer, cfg.checkpoint_dir)
        if cfg.averaging != "none":
            await self._sync_state(bundle)
        if cfg.zone_shards:
            await self._start_sharding()
        if self.telemetry.watchdog.enabled:
            # Probes over the surfaces built above, ticked once per report
            # beat (_build_report).
            transport = self.transport

            def _peer_bandwidths(max_age_s: float = 120.0) -> Dict[str, float]:
                cutoff = time.monotonic() - max_age_s
                return {
                    f"{host}:{port}": float(st.bw_down_ewma)
                    for (host, port), st in transport._peer_stats.items()
                    if st.bw_down_ewma is not None and st.bw_down_t >= cutoff
                }

            self.telemetry.watchdog.wire_volunteer(
                averager=self.averager,
                control_plane=self.control_plane,
                health=self.telemetry.health,
                bandwidths=_peer_bandwidths,
            )
        self._report_task = asyncio.create_task(self._report_loop())
        log.info(
            "volunteer %s up on %s:%d (model=%s averaging=%s)",
            cfg.peer_id, *self.transport.addr, cfg.model, cfg.averaging,
        )

    async def _sync_state(self, bundle) -> None:
        """Peer-pull state sync: catch up to the swarm BEFORE the first step
        (after a restore), then announce this volunteer as a provider. The
        provider serves the trainer's host snapshot, never its tensors."""
        cfg = self.cfg
        # Serve state over the averaging wire's codec (bf16 halves a rejoin).
        self.state_sync = StateSyncService(
            self.transport, self.dht, cfg.peer_id, namespace=cfg.model,
            wire=cfg.wire if cfg.wire in ("bf16", "q8") else "f32",
        )

        def provider():
            # The snapshot holds the avg_select subtree already.
            step, tree = self.trainer.host_snapshot()
            # Fault injection (test-only): DVC_CHAOS_STATE_POISON="lie,scale"
            # makes this volunteer a Byzantine state provider: it serves step
            # + lie (pulls go to the freshest provider) and its tree scaled.
            poison = os.environ.get("DVC_CHAOS_STATE_POISON")
            if poison:
                lie, scale = (float(x) for x in poison.split(","))
                tree = tree_map(lambda a: np.asarray(a, np.float32) * scale, tree)
                step = int(step + lie)
            return step, tree

        self.state_sync.set_provider(provider)
        step0 = int(self.trainer.state.step)
        received0 = self.transport.bytes_received
        t0 = time.perf_counter()
        pulled = await self.state_sync.pull(bundle.avg_select(self.trainer.state.params), step0)
        pull_s = time.perf_counter() - t0
        if pulled is not None:
            step, subtree = pulled
            self.trainer.adopt_params(subtree, step=step)
        self.trainer.metrics.record_event(
            int(self.trainer.state.step), "state_pull",
            {"pulled": pulled is not None, "from_step": step0, "s": pull_s,
             "bytes": self.transport.bytes_received - received0},
        )
        await self.state_sync.announce()
        if cfg.averaging == "gossip" and cfg.average_what == "params":
            # Publish before the first averaging point, so exchanges from
            # faster peers succeed while this one is still starting.
            _, snap = self.trainer.host_snapshot()
            self.averager.publish(snap)

    async def _start_sharding(self) -> None:
        """Zone-sharded training, the reference's autopilot: the manager
        over this volunteer's transport, DHT and membership takes its HRW
        shard(s) of the averaged subtree, seeds them from the post-state-sync
        snapshot (flattened in sorted-key order, the reference's leaf order,
        so the ranges cut the same tensors), advertises its primary shard
        (the shard-scoped rendezvous reads it), and runs the maintenance
        beat that re-shards and recovers on churn."""
        from distributedvolunteercomputing_tpu_torch.swarm.sharding import ShardManager, shard_slice
        from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves

        cfg = self.cfg
        _, snap = self.trainer.host_snapshot()
        leaves = tree_leaves(snap)
        flat = (
            np.concatenate([np.asarray(a, np.float32).ravel() for a in leaves])
            if leaves else np.zeros(0, np.float32)
        )
        self.shard_manager = sm = ShardManager(
            self.transport, self.dht, self.membership, cfg.peer_id,
            n_elems=flat.size, k=cfg.zone_shards,
            namespace=f"{cfg.model}/{cfg.average_what}",
            zone=cfg.zone,
            telemetry=self.telemetry,
            resilience=self.resilience_policy,
            controller=self.controller,
        )
        await sm.reshard(recover=False)
        for s in sm.owned():
            sm.store.put(s, shard_slice(flat, sm.ranges, s).copy())
        await sm.announce()
        if self.averager is not None:
            self.averager.shard_manager = sm
            self.telemetry.registry.source("sharding", sm.summary)
        sm.start_maintenance(interval_s=max(cfg.heartbeat_ttl / 3.0, 2.0))
        log.info(
            "zone-sharded: k=%d zone=%s own=%s (%d/%d elems, gen %d)",
            sm.k, sm.zone, sm.owned(),
            sum(hi - lo for lo, hi in (sm.ranges[s] for s in sm.owned())),
            sm.n_elems, sm.map.gen,
        )

    def _build_resilience_layer(self) -> None:
        """The phi-accrual detector and the adaptive policy and, with
        ``adapt`` in sync or byzantine mode, the closed-loop controller
        over them. No-op without ``resilience``."""
        cfg = self.cfg
        if not cfg.resilience:
            return
        from distributedvolunteercomputing_tpu_torch.swarm.failure_detector import PhiAccrualDetector
        from distributedvolunteercomputing_tpu_torch.swarm.resilience import ResiliencePolicy

        self.failure_detector = PhiAccrualDetector(
            threshold=cfg.phi_threshold,
            # Heartbeats arrive at the announce cadence (ttl/3).
            bootstrap_s=max(cfg.heartbeat_ttl / 3.0, 1.0),
        )
        self.resilience_policy = ResiliencePolicy(
            max_deadline_s=cfg.gather_timeout,
            # A gather timeout under the stock 2 s floor must not trip the
            # policy's range check.
            min_deadline_s=min(2.0, float(cfg.gather_timeout)),
            initial_deadline_s=cfg.round_deadline_s or None,
            failure_detector=self.failure_detector,
            recorder=self.telemetry.recorder,
        )
        if cfg.adapt and cfg.averaging in ("sync", "byzantine"):
            # Gossip has no rounds to fence a decision against.
            from distributedvolunteercomputing_tpu_torch.swarm.controller import SwarmController

            self.controller = SwarmController(policy=self.resilience_policy, telemetry=self.telemetry)

    def _build_report(self) -> dict:
        """This volunteer's metrics report (the coord.report payload),
        piggybacked on every batched control-plane exchange by the
        membership heartbeat, and sent on its own by the report loop while
        no replica is reachable. Reads plain ints and gauges only."""
        report = {
            "peer": self.cfg.peer_id,
            "step": int(self.trainer.state.step) if self.trainer else 0,
            "samples_per_sec": self.trainer.metrics.samples_per_sec() if self.trainer else 0.0,
            **{k: v for k, v in self.summary.items()},
        }
        if self.averager is not None and self.averager._agg_gauges:
            # Live leader-aggregation gauges, reported mid-run.
            report["aggregation"] = dict(self.averager._agg_gauges)
        if self.averager is not None:
            # The data path's backend, its op counts and kernel launches.
            report["mesh_codec"] = self.averager.mesh_codec.stats()
        if self.telemetry.enabled:
            report["telemetry"] = self.telemetry.summary()
        wd = self.telemetry.watchdog
        if wd.enabled:
            # One watchdog evaluation per report beat; its compact firing
            # set rides the same exchange.
            wd.tick()
            summary = wd.summary()
            if summary is not None:
                report["watchdog"] = summary
        if self.controller is not None:
            # The controller's rollup; absent without it.
            report["controller"] = self.controller.summary()
        health = self.telemetry.health.summary()
        if health is not None:
            report["health"] = health
        sm = self.shard_manager or getattr(self.averager, "shard_manager", None)
        if sm is not None:
            # Zone-sharded training gauges (map generation, owned and missing
            # shards, recovery latencies); absent on unsharded swarms.
            report["sharding"] = sm.summary()
        failover_stats = getattr(self.averager, "failover_stats", None)
        if failover_stats is not None:
            fo = failover_stats()
            if fo["leaders_deposed"] or fo["rounds_recovered"] or fo["recoveries_failed"]:
                report["failover"] = fo
        return report

    async def _report_loop(self) -> None:
        caddrs = _parse_addrs(self.cfg.coordinator)
        caddr = caddrs[0] if caddrs else None
        while not self._stop.is_set():
            await asyncio.sleep(5.0)
            if self.state_sync is not None:
                try:
                    # Re-announce our step so rejoining peers can find the
                    # freshest provider (TTL'd, like heartbeats).
                    await self.state_sync.announce()
                except Exception:
                    pass
            if caddr is None:
                continue
            if self.membership is not None and self.membership.last_beat_batched:
                # The last heartbeat went through a replica carrying our
                # report; a standalone coord.report would double the cost.
                continue
            try:
                report = self._build_report()
                await self.transport.call(
                    caddr, "coord.report", report, timeout=5.0, connect_timeout=1.5,
                )
            except Exception:
                # Coordinator reachability is not correctness-critical; with
                # several coordinators, rotate to the next one.
                if len(caddrs) > 1:
                    caddrs = caddrs[1:] + caddrs[:1]
                    caddr = caddrs[0]

    def _train_blocking(self) -> Dict[str, Any]:
        assert self.trainer is not None
        result = self.trainer.run(
            steps=self.cfg.steps,
            target_loss=self.cfg.target_loss,
            target_mode=self.cfg.target_mode,
            stop_flag=self._stop.is_set,
        )
        if self.cfg.checkpoint_dir:
            from distributedvolunteercomputing_tpu_torch.training.checkpoint import (
                latest_step,
                save,
                wait_pending_saves,
            )

            # Final save is SYNCHRONOUS (preemption-safe), after draining any
            # in-flight periodic write. Skip it only when the drained save
            # covers the current state EXACTLY: same step AND same mutation
            # count (the end-of-run overlap drain can merge at an unchanged
            # step number).
            drained = wait_pending_saves(self.trainer)
            current_id = (int(self.trainer.state.step), self.trainer.mutation_counter)
            already_saved = (
                getattr(self.trainer, "_ckpt_snapshot_id", None) == current_id
                and latest_step(self.cfg.checkpoint_dir) == current_id[0]
            )
            if drained and not already_saved:
                save(self.trainer, self.cfg.checkpoint_dir)
        return result

    async def train(self) -> Dict[str, Any]:
        """Train ``cfg.steps`` steps on a worker thread (the swarm services
        keep running on this loop), then the final checkpoint; returns the
        summary."""
        self.summary = await asyncio.to_thread(self._train_blocking)
        if self.averager is not None:
            self.summary.update(self.averager.stats())
        if self.shard_manager is not None:
            # Zone-sharding outcome gauges on the done line.
            sm = self.shard_manager
            self.summary["shard_gen"] = float(sm.map.gen if sm.map is not None else -1)
            self.summary["shard_reshardings"] = float(sm.resharding_count)
            self.summary["shard_recoveries"] = float(sm.recoveries)
            self.summary["shard_recoveries_failed"] = float(sm.recoveries_failed)
            self.summary["shard_missing"] = float(len(sm.missing()))
        # The process's K1-K3 launches (the codec's K4/K5 are in mesh_codec).
        self.summary["flash_launches"] = dict(flash_attention.LAUNCHES)
        self.summary["wan_bytes_sent"] = self.transport.bytes_sent
        self.summary["wan_bytes_received"] = self.transport.bytes_received
        self.summary["wan_rpcs"] = self.transport.rpcs_sent
        self.summary["wan_connects"] = self.transport.connects
        return self.summary

    async def run(self) -> Dict[str, Any]:
        """start -> train -> stop; returns the summary."""
        try:
            await self.start()
            return await self.train()
        finally:
            await self.stop()

    async def stop(self) -> None:
        """The reference's teardown order: report task, membership leave,
        replica retire, DHT, metrics endpoint, loop monitor, transport."""
        self._stop.set()
        if self._report_task is not None:
            self._report_task.cancel()
        if self.clocksync is not None:
            self.clocksync.stop()
        if self.shard_manager is not None:
            try:
                await self.shard_manager.stop()
            except Exception:
                pass
        if self.membership is not None:
            try:
                await self.membership.leave()
            except Exception as e:  # noqa: BLE001 — leaving is best-effort
                log.debug("membership leave failed: %s", errstr(e))
        if self.replica is not None:
            try:
                # The retiring tombstone makes the swarm re-resolve the
                # active replica set at once.
                await self.replica.retire(grace=0.0)
            except Exception:
                pass
        await self.dht.stop()
        if self._metrics_server is not None:
            try:
                await self._metrics_server.close()
            except Exception:
                pass
        if self._loop_monitor is not None:
            await self._loop_monitor.stop()
        await self.transport.close()

    def install_signal_handlers(self) -> None:
        """SIGTERM == preemption notice; SIGINT == operator stop."""

        def _on_signal(signum, frame):
            log.info("signal %d: stopping after current step (preemption-safe)", signum)
            self._stop.set()

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)


def run_volunteer(cfg: VolunteerConfig) -> Dict[str, Any]:
    from distributedvolunteercomputing_tpu_torch import native

    # The host codec's C++ core builds on a background thread at first use;
    # wait for it before the loop starts so no round runs its numpy stand-in.
    native.ensure_built()
    vol = Volunteer(cfg)
    vol.install_signal_handlers()
    return asyncio.run(vol.run())
