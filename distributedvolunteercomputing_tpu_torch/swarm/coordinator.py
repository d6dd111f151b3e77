"""Coordinator: a stateless front for the replicated control plane.

Reference parity: the ``coordinator.py`` entrypoint "bootstraps the swarm:
initial DHT node, rendezvous address, liveness registry" (SURVEY.md §2,
BASELINE.json:5). Since the control-plane PR it holds NO authoritative
state: it is one DHT node plus one ``ControlPlaneReplica``
(swarm/control_plane.py) — membership records, metrics rollups, and the
replica set itself are TTL'd DHT soft state, sharded by key range across
every elected replica (any volunteer run with ``--host-replica`` is a
candidate too). Kill this process mid-training and a surviving replica
serves ``coord.status`` within one heartbeat interval; volunteers' batched
heartbeat/report traffic fails over on conn failure, exactly like the PR-4
leader-deposal path.

SIGTERM (the TPU-VM preemption notice) retires gracefully: a "retiring"
tombstone under ``cp/replicas`` makes volunteers and peer replicas
re-resolve the active set immediately instead of waiting for the record's
TTL.
"""

from __future__ import annotations

import asyncio
import signal
import time
from typing import Optional, Tuple

from distributedvolunteercomputing_tpu_torch.swarm.control_plane import ControlPlaneReplica
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport
from distributedvolunteercomputing_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class Coordinator:
    """Swarm bootstrap node hosting one control-plane replica. The public
    surface (``coord.report``/``coord.status`` RPCs, ``_rpc_status`` for
    in-process callers) is unchanged from the single-host coordinator; the
    state behind it moved into the DHT."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics_path: Optional[str] = None,
        advertise_host: Optional[str] = None,
        secret: Optional[bytes] = None,
        rid: Optional[str] = None,
    ):
        self.transport = Transport(host, port, advertise_host=advertise_host, secret=secret)
        self.dht = DHTNode(self.transport)
        self.replica = ControlPlaneReplica(
            self.transport, self.dht, rid=rid, metrics_path=metrics_path,
        )

    async def start(self) -> Tuple[str, int]:
        from distributedvolunteercomputing_tpu_torch.utils.asyncio_debug import maybe_enable_from_env

        # DVC_ASYNC_DEBUG=1: loop stall/race detectors (stopped in close())
        self._loop_monitor = maybe_enable_from_env()
        addr = await self.transport.start()
        await self.dht.start(bootstrap=None)
        await self.replica.start()
        log.info("coordinator listening on %s:%d", *addr)
        return addr

    async def close(self) -> None:
        await self.replica.stop()
        await self.dht.stop()
        if getattr(self, "_loop_monitor", None) is not None:
            await self._loop_monitor.stop()
        await self.transport.close()

    async def retire(self, grace: float = 0.5) -> None:
        """Graceful SIGTERM path: publish the retiring tombstone, drain,
        then close."""
        await self.replica.retire(grace=grace)
        await self.close()

    # Back-compat passthroughs: in-process callers (tests, the forever
    # loop) talk to the coordinator, the replica does the work. The window
    # views flatten the replica's per-shard windows back into the flat
    # lists the single-host coordinator kept.

    @property
    def latest_metrics(self):
        return self.replica.latest_metrics

    @property
    def _commit_window(self):
        return sorted(
            (td for w in self.replica._commit_window.values() for td in w),
            key=lambda td: td[0],
        )

    @property
    def _xz_window(self):
        return sorted(
            (td for w in self.replica._xz_window.values() for td in w),
            key=lambda td: td[0],
        )

    def _multigroup_rollup(self, fresh: list):
        return self.replica._multigroup_rollup(
            fresh, self._commit_window, self._xz_window
        )

    async def _rpc_report(self, args: dict, payload: bytes):
        return await self.replica._rpc_report(args, payload)

    async def _rpc_status(self, args: dict, payload: bytes):
        return await self.replica._rpc_status(args, payload)


async def run_coordinator_forever(
    host: str,
    port: int,
    metrics_path: Optional[str] = None,
    advertise_host: Optional[str] = None,
    secret: Optional[bytes] = None,
) -> None:
    coord = Coordinator(host, port, metrics_path, advertise_host=advertise_host, secret=secret)
    # SIGTERM = preemption notice: retire gracefully (publish the retiring
    # tombstone so volunteers re-resolve replicas IMMEDIATELY) instead of
    # vanishing and leaving them to discover the corpse by conn failure.
    # Installed BEFORE the ready line: a supervisor that kills the moment
    # the coordinator reports ready must still get the graceful path.
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    try:
        loop.add_signal_handler(signal.SIGTERM, stop.set)
    except (NotImplementedError, RuntimeError):  # non-main thread / Windows
        pass
    addr = await coord.start()
    print(f"COORDINATOR_READY {addr[0]}:{addr[1]}", flush=True)
    try:
        last_log = time.monotonic()
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=1.0)
            except asyncio.TimeoutError:
                pass
            if time.monotonic() - last_log >= 10.0:
                last_log = time.monotonic()
                status, _ = await coord._rpc_status({}, b"")
                log.info("swarm status: %s", status)
        log.info("SIGTERM: retiring coordinator replica")
        await coord.retire()
    except asyncio.CancelledError:
        await coord.close()
