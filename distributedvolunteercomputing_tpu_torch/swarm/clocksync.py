"""NTP-style peer clock-offset estimation over the swarm transport.

The wall-clock averaging cadence (``--average-interval-s``;
``Trainer._avg_due``) rendezvouses volunteers at absolute multiples of T —
which until r5 ASSUMED NTP-synced clocks (the r4 MIGRATION known-limitation
and VERDICT directive #9). This module removes the assumption with the
classic two-timestamp exchange: probe a peer, read its clock ``ts``, and
estimate ``offset = ts - (t_send + t_recv) / 2`` (error bounded by RTT/2;
the minimum-RTT sample per peer carries the least queueing noise).

Combining rule: the volunteer adopts the MEDIAN of ``{0} ∪ {per-peer
offsets}`` as a correction to its own clock, accumulated across estimation
rounds. Including the self-sample 0 is what makes a two-node swarm meet in
the middle instead of swapping clocks (each would otherwise correct by the
full pairwise offset simultaneously); with n ≥ 3 honest peers the median
pins the skewed minority to the honest majority's clock while honest nodes
barely move — the same breakdown-point argument as the byzantine
estimators (ops/robust.py). Probes serve the CORRECTED clock, so a late
joiner adopts swarm consensus time in one round even when the whole swarm
has drifted from UTC: the cadence needs internal consistency, not truth.

Reference parity: a coordinator-centric stack gets rendezvous consistency
for free by rendezvousing ON the coordinator; this framework has no
privileged node (SURVEY.md §1 L3), so the correction is peer-to-peer and
byzantine-tolerant like everything else in the tier.

Test hook: ``DVC_CLOCK_SKEW_S`` (read by the volunteer, not here) injects
an artificial skew into a volunteer's local clock, so the e2e suite can
prove rendezvous under multi-second skew (tests/test_interval_cadence.py).
"""

from __future__ import annotations

import asyncio
import random
import statistics
import time
from typing import Callable, Optional

from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)

METHOD = "clock.probe"


class ClockSync:
    """Registers ``clock.probe`` and maintains ``offset`` (seconds to ADD
    to the local clock to land on swarm-consensus time).

    ``clock`` is the volunteer's notion of wall time (``time.time`` unless
    a test injects skew). ``now()`` is thread-safe — the trainer thread
    reads it every wall-cadence poll while the asyncio loop re-estimates
    (float attribute assignment is atomic)."""

    def __init__(
        self,
        transport,
        membership,
        *,
        clock: Callable[[], float] = time.time,
        sample_peers: int = 5,
        samples_per_peer: int = 3,
        probe_timeout: float = 3.0,
    ):
        self.transport = transport
        self.membership = membership
        self.clock = clock
        self.sample_peers = int(sample_peers)
        self.samples_per_peer = int(samples_per_peer)
        self.probe_timeout = float(probe_timeout)
        self.offset = 0.0
        self.last_estimate_t: Optional[float] = None
        self._task: Optional[asyncio.Task] = None
        transport.register(METHOD, self._rpc_probe)

    # -- rpc ---------------------------------------------------------------

    async def _rpc_probe(self, args: dict, payload: bytes):
        # Serve the CORRECTED clock (see module docstring): consensus time
        # propagates to probers, raw local time does not.
        return {"t": self.now()}, b""

    # -- estimation --------------------------------------------------------

    def now(self) -> float:
        return self.clock() + self.offset

    async def estimate(self) -> float:
        """One estimation round: probe up to ``sample_peers`` live peers,
        median-combine, accumulate into ``offset``. Returns the new offset.
        Failures (dead peers, timeouts) just shrink the sample — a solo
        volunteer keeps offset unchanged."""
        try:
            peers = await self.membership.alive_peers(include_self=False)
        except Exception as e:  # noqa: BLE001 — estimation must never kill the loop
            log.warning("clock-sync peer listing failed: %s", errstr(e))
            return self.offset
        # Uniform random sample over live peers: deterministic first-N
        # sampling would anchor every volunteer's consensus on the same few
        # (possibly adversarial) early registrants, collapsing the median's
        # breakdown point from "minority of the SWARM" to "minority of a
        # fixed 5-peer panel".
        cands = list(peers.items())
        if len(cands) > self.sample_peers:
            cands = random.sample(cands, self.sample_peers)

        async def probe_peer(pid: str, rec: dict) -> Optional[float]:
            addr = rec.get("addr")
            if not isinstance(addr, (list, tuple)) or len(addr) != 2:
                return None
            addr = (addr[0], int(addr[1]))
            best = None  # (rtt, delta)
            for _ in range(self.samples_per_peer):
                t0 = self.now()
                try:
                    # Pooled transport: only the FIRST probe to a peer pays
                    # the TCP dial; the min-RTT ladder then samples pure
                    # request/response time, so the offset estimate's
                    # RTT/2 error bound tightens to the real network RTT
                    # instead of handshake + slow-start noise.
                    ret, _ = await self.transport.call(
                        addr, METHOD, {}, b"", timeout=self.probe_timeout,
                        connect_timeout=min(2.0, self.probe_timeout),
                    )
                except Exception as e:  # noqa: BLE001
                    log.debug("clock probe to %s failed: %s", pid, errstr(e))
                    break
                t1 = self.now()
                try:
                    ts = float(ret["t"])
                except (KeyError, TypeError, ValueError):
                    break
                rtt = t1 - t0
                delta = ts - 0.5 * (t0 + t1)
                if best is None or rtt < best[0]:
                    best = (rtt, delta)
            return None if best is None else best[1]

        # Concurrent probes: a round costs one probe ladder regardless of
        # dead-peer count (a crashed peer's record lingers for a heartbeat
        # TTL; sequentially its timeouts would stall startup/warmup).
        results = await asyncio.gather(*(probe_peer(p, r) for p, r in cands))
        deltas = [0.0]  # the self-sample: our current corrected clock
        deltas.extend(d for d in results if d is not None)
        if len(deltas) > 1:
            step = float(statistics.median(deltas))
            self.offset += step
            self.last_estimate_t = self.clock()
            if abs(step) > 0.5:
                log.info(
                    "clock-sync: corrected by %+.3fs (total offset %+.3fs, "
                    "%d peers sampled)", step, self.offset, len(deltas) - 1,
                )
        return self.offset

    # -- lifecycle ---------------------------------------------------------

    def start(self, interval_s: float = 30.0, warmup_rounds: int = 5) -> None:
        """Periodic estimation on the running loop.

        The first ``warmup_rounds`` run on a fast (≤3s) cadence: the
        median-with-self rule moves each node at most HALFWAY to its peers
        per round, and nodes join at different times (the very first
        estimate may see an empty swarm), so convergence to a consistent
        swarm clock takes a handful of rounds — which must complete before
        the first averaging boundaries, not one leisurely interval each."""

        async def loop():
            try:
                for _ in range(max(warmup_rounds, 0)):
                    await self.estimate()
                    await asyncio.sleep(min(interval_s, 3.0))
                while True:
                    await self.estimate()
                    await asyncio.sleep(interval_s)
            except asyncio.CancelledError:
                pass

        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
