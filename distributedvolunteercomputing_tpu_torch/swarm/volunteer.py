"""Volunteer lifecycle: join the swarm -> train with periodic averaging -> leave
(ported from ``distributedvolunteercomputing_tpu/swarm/volunteer.py``).

Threading model, as in the reference: the asyncio loop (transport, DHT,
membership heartbeats, averaging RPC handlers) owns the calling thread; the
blocking train loop runs in a worker thread and bridges into the loop once
per averaging round through ``run_coroutine_threadsafe``.

Ported so far: ``averaging`` "none" or "sync" on the f32 or bf16 wire, the
step cadence, blocking or overlapped rounds, and a local data-parallel mesh.
The volunteer builds its swarm services, then its mesh (``mesh``: the
reference's "dp=N" spec over the visible cards, or a prebuilt port ``Mesh``,
which may put several ranks on one card), then selects the codec on its
device or its mesh's ranks (``mesh_codec.configure``: the bf16 encode and the
leader's fold run as CUDA kernels on the card; with two or more ranks and
``mesh_collective`` "ring" or "auto" the fold is the ring, K6/K7), then the
trainer, data-parallel over the mesh. The coordinator, state sync,
checkpoints, the resilience layer and controller, chaos hooks, group
schedules and sharding come with later slices; ``VolunteerConfig`` does not
accept them yet.
"""

from __future__ import annotations

import asyncio
import dataclasses
import signal
import threading
import uuid
from typing import Any, Dict, Optional, Union

from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mesh_codec_mod
from distributedvolunteercomputing_tpu_torch.parallel.mesh import Mesh, make_mesh, parse_mesh_spec
from distributedvolunteercomputing_tpu_torch.swarm.averager import make_averager
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm.telemetry import Telemetry
from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger
from distributedvolunteercomputing_tpu_torch.utils.torchenv import DeviceLike

log = get_logger(__name__)

HEARTBEAT_TTL_S = 15.0  # the reference's default membership record TTL


@dataclasses.dataclass
class VolunteerConfig:
    model: str = "gpt2_small"
    model_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    batch_size: int = 32
    optimizer: str = "adam"
    lr: float = 1e-3
    seed: int = 0  # per-volunteer: data order + step rng
    init_seed: int = 0  # task-constant: shared initial params
    steps: int = 1000
    averaging: str = "none"  # none | sync
    wire: str = "f32"  # f32 | bf16
    average_every: int = 10
    # Overlap rounds with local steps (the reference's default, on).
    overlap: bool = True
    max_staleness: int = 0  # steps; 0 = unbounded
    join_timeout: float = 10.0
    gather_timeout: float = 20.0
    host: str = "127.0.0.1"
    port: int = 0
    # "host:port[,host:port...]" DHT bootstrap nodes (the reference's
    # --coordinator addresses); None = the first node of a swarm.
    bootstrap: Optional[str] = None
    peer_id: str = ""
    # The card unless "cpu" is asked for; raises when there is no card.
    device: DeviceLike = None
    metrics_path: Optional[str] = None
    # Local mesh: the reference's "dp=N" spec over the first N visible cards
    # (dp only), or a port ``Mesh`` (whose ranks may share a card); "" = one
    # device. The swarm still sees one volunteer either way.
    mesh: Union[str, Mesh] = ""
    # The leader's bf16 mean fold over the mesh: "ring" (K6/K7), "off" (the
    # staged per-rank fold), "auto" = ring with two or more CUDA ranks.
    mesh_collective: str = "auto"

    def __post_init__(self):
        if not self.peer_id:
            self.peer_id = f"vol-{uuid.uuid4().hex[:8]}"
        if self.averaging in ("gossip", "butterfly", "byzantine"):
            raise NotImplementedError(f"averaging {self.averaging!r} is not ported yet; ported: none, sync")
        if self.averaging not in ("none", "sync"):
            raise ValueError(f"unknown averaging {self.averaging!r}")
        if self.wire not in ("f32", "bf16"):
            raise NotImplementedError(f"wire {self.wire!r} is not ported yet; ported: f32, bf16")
        if isinstance(self.mesh, str) and self.mesh:
            axes = parse_mesh_spec(self.mesh)
            if any(v > 1 for k, v in axes.items() if k != "dp"):
                raise NotImplementedError(f"mesh {self.mesh!r}: only dp is ported yet")
        if self.mesh_collective not in ("auto", "ring", "off"):
            raise ValueError(f"unknown mesh collective {self.mesh_collective!r}")


def _parse_addrs(spec: Optional[str]) -> list:
    """``host:port[,host:port...]`` -> [(host, port), ...]."""
    if not spec:
        return []
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad bootstrap address {part!r} in {spec!r}: expected host:port")
        out.append((host, int(port)))
    return out


class Volunteer:
    def __init__(self, cfg: VolunteerConfig):
        self.cfg = cfg
        # One telemetry bundle per volunteer: round spans, the metrics
        # registry, the flight recorder and the training-health probe (on,
        # as in the reference). The watchdog ticks on the coordinator report
        # beat, which is not ported, so it stays off rather than idle.
        self.telemetry = Telemetry(
            peer_id=cfg.peer_id, enabled=True, health_enabled=True, watchdog_enabled=False
        )
        self.transport = Transport(cfg.host, cfg.port)
        self.dht = DHTNode(self.transport)
        self.membership: Optional[SwarmMembership] = None
        self.averager = None
        self.trainer: Optional[Trainer] = None
        self._stop = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.summary: Dict[str, Any] = {}

    # -- averager bridge (called from the trainer thread) ------------------

    def _averager_callback(self, params, step: int):
        if self.averager is None or self._stop.is_set():
            return None
        # Weight = samples behind this contribution: the trainer's actual
        # steps since the last merge (average_every on the happy path, more
        # after failed rounds).
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
        """Transport, DHT, membership and averager; then the codec on this
        volunteer's device (a failed kernel build raises here); then the
        trainer."""
        self._loop = asyncio.get_running_loop()
        cfg = self.cfg
        await self.transport.start()
        self.telemetry.register_rpcs(self.transport)
        await self.dht.start(bootstrap=_parse_addrs(cfg.bootstrap) or None)
        namespace = f"{cfg.model}/params"
        self.membership = SwarmMembership(
            self.dht, cfg.peer_id, ttl=HEARTBEAT_TTL_S,
            extra_info={"model": cfg.model, "avg_ns": namespace},
            bandwidth_source=self.transport.bandwidth_advertisement,
            telemetry=self.telemetry,
        )
        await self.membership.join()
        if cfg.averaging != "none":
            self.averager = make_averager(
                cfg.averaging, self.transport, self.dht, self.membership,
                join_timeout=cfg.join_timeout, gather_timeout=cfg.gather_timeout,
                wire=cfg.wire, telemetry=self.telemetry, namespace=namespace,
            )
        bundle = get_model(cfg.model, **cfg.model_overrides)
        mesh = cfg.mesh if isinstance(cfg.mesh, Mesh) else make_mesh(**parse_mesh_spec(cfg.mesh)) if cfg.mesh else None
        # The averager resolves the process default lazily, so configuring
        # here covers the averager built above.
        codec = mesh_codec_mod.configure(
            device=None if mesh is not None else cfg.device,
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
            total_steps=cfg.steps,
            metrics_path=cfg.metrics_path,
            volunteer_id=cfg.peer_id,
            device=cfg.device,
            mesh=mesh,
            averager=self._averager_callback if self.averager is not None else None,
            average_every=cfg.average_every,
            overlap=cfg.overlap,
            max_staleness=cfg.max_staleness,
        )
        log.info(
            "volunteer %s up on %s:%d (model=%s averaging=%s)",
            cfg.peer_id, *self.transport.addr, cfg.model, cfg.averaging,
        )

    async def train(self) -> Dict[str, Any]:
        """Train ``cfg.steps`` steps on a worker thread (the swarm services
        keep running on this loop); returns the summary."""
        self.summary = await asyncio.to_thread(
            self.trainer.run, steps=self.cfg.steps, stop_flag=self._stop.is_set
        )
        if self.averager is not None:
            self.summary.update(self.averager.stats())
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
        self._stop.set()
        if self.membership is not None:
            try:
                await self.membership.leave()
            except Exception as e:  # noqa: BLE001 — leaving is best-effort
                log.debug("membership leave failed: %s", errstr(e))
        await self.dht.stop()
        await self.transport.close()

    def install_signal_handlers(self) -> None:
        """SIGTERM == preemption notice; SIGINT == operator stop."""

        def _on_signal(signum, frame):
            log.info("signal %d: stopping after current step", signum)
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
