"""Phi-accrual failure detection (Hayashibara et al., "The φ Accrual
Failure Detector") over swarm heartbeat observations.

The membership layer's TTL is BINARY liveness: a peer is alive until its
DHT record expires, then it is dead — there is no notion of "probably
stalled", which is exactly the state a straggler occupies for the seconds
that matter to an averaging round. The phi-accrual detector replaces that
cliff with a continuous suspicion score:

    phi(peer) = -log10( P(next heartbeat arrives later than it already has) )

computed from the observed distribution of that peer's heartbeat
inter-arrival times. phi ~ 1 means "this gap would happen ~10% of the
time"; phi ~ 8 means one-in-10^8 — for all practical purposes the peer is
stalled or partitioned. Because phi accrues CONTINUOUSLY as the silence
grows, consumers pick their own thresholds: the matchmaker pre-excludes
likely stragglers from group formation (swarm/matchmaking.py) well before
the membership TTL would expire the record, and the resilience policy
(swarm/resilience.py) folds phi into its per-peer outcome tracking.

Feeding: SwarmMembership observes peer records (each carries the sender's
announce timestamp ``t``); every time a peer's ``t`` CHANGES, that is one
heartbeat arrival at the local monotonic clock (swarm/membership.py
``_observe``). Observation cadence quantizes the samples, which is fine —
the detector only needs the gap distribution to be stationary, not exact.

All state is process-local and cheap (a bounded deque of floats per peer);
no I/O, no tasks — safe to call from RPC handlers and the trainer thread
(reads are over immutable snapshots of per-peer tuples).
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from distributedvolunteercomputing_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# phi above this = suspected by default. 8 is the classic Cassandra/Akka
# default: P(false positive) ~ 1e-8 under the fitted model.
DEFAULT_PHI_THRESHOLD = 8.0


class PhiAccrualDetector:
    """Per-peer suspicion scores from heartbeat inter-arrival times.

    ``window``      — inter-arrival samples kept per peer (sliding).
    ``threshold``   — phi at/above which ``suspect()`` is True.
    ``min_std_s``   — floor on the fitted std-dev: localhost heartbeats can
                      be near-periodic, and a ~0 std would make the first
                      slightly-late beat spike phi to infinity.
    ``bootstrap_s`` — assumed mean gap before enough samples exist, so a
                      peer heard from ONCE still accrues suspicion if it
                      goes silent (rather than being unsuspectable until
                      its distribution is learned).
    ``clock``       — monotonic-time source (injectable for tests).

    Secondary signal: the transport's per-peer RPC latency EWMA
    (``observe_latency``, fed by SwarmMembership from the pooled
    transport's counters). Heartbeats ride the DHT with multi-second
    cadence, so a peer whose RPC latency explodes — congested link, paging
    host, half-partitioned pipe — can look heartbeat-healthy for several
    beats while already being a round-killing straggler. A peer whose
    current latency EWMA exceeds ``lat_factor`` x its own slow-moving
    baseline AND the absolute ``lat_floor_s`` is suspected even at phi 0.
    Both gates are deliberately conservative: localhost/CI jitter is
    routinely 5-10x on a ms-scale baseline, which the absolute floor
    ignores.
    """

    MIN_SAMPLES = 3  # below this, fall back to the bootstrap gap model
    # Latency-EWMA suspicion gates (see class docstring).
    LAT_FACTOR = 8.0
    LAT_FLOOR_S = 1.0
    # How long a directly-reported connection failure keeps a peer
    # suspected regardless of phi (see report_failure).
    FAILURE_HOLD_S = 30.0

    def __init__(
        self,
        *,
        window: int = 64,
        threshold: float = DEFAULT_PHI_THRESHOLD,
        min_std_s: float = 0.25,
        bootstrap_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.window = int(window)
        self.threshold = float(threshold)
        self.min_std_s = float(min_std_s)
        self.bootstrap_s = float(bootstrap_s)
        self.clock = clock
        self._last: Dict[str, float] = {}
        self._gaps: Dict[str, deque] = {}
        # peer -> (current latency EWMA, slow baseline) — see observe_latency.
        self._lat: Dict[str, Tuple[float, float]] = {}
        # peer -> suspicion-hold expiry from a reported connection failure.
        self._failed: Dict[str, float] = {}

    # -- feeding -----------------------------------------------------------

    def heartbeat(self, peer: str, t: Optional[float] = None) -> None:
        """Record one heartbeat ARRIVAL for ``peer`` (local monotonic time)."""
        now = self.clock() if t is None else float(t)
        # A fresh heartbeat is positive liveness evidence: it clears any
        # reported-failure hold (the peer restarted/healed) so a recovered
        # node isn't shut out of formation for the rest of the hold window.
        self._failed.pop(peer, None)
        last = self._last.get(peer)
        self._last[peer] = now
        if last is None:
            return
        gap = now - last
        if gap <= 0:  # duplicate observation in the same poll — not a beat
            return
        self._gaps.setdefault(peer, deque(maxlen=self.window)).append(gap)

    def observe_latency(self, peer: str, latency_s: float) -> None:
        """Record the transport's current RPC latency EWMA for ``peer``.

        The fast value is stored as-is (the transport already smooths it);
        this detector maintains the SLOW baseline (alpha 0.02, ~50-sample
        memory) the suspicion ratio compares against, so a gradual genuine
        latency regime change re-baselines instead of suspecting forever."""
        if not (isinstance(latency_s, (int, float)) and latency_s >= 0):
            return
        prev = self._lat.get(peer)
        if prev is None:
            self._lat[peer] = (float(latency_s), float(latency_s))
        else:
            _, slow = prev
            self._lat[peer] = (float(latency_s), slow + 0.02 * (latency_s - slow))

    def latency_suspect(self, peer: str) -> bool:
        """Is the peer's current RPC latency far outside its own baseline?
        (The secondary suspicion signal; see class docstring.)"""
        entry = self._lat.get(peer)
        if entry is None:
            return False
        fast, slow = entry
        return fast > max(self.LAT_FACTOR * slow, self.LAT_FLOOR_S)

    def report_failure(self, peer: str, hold_s: Optional[float] = None) -> None:
        """Direct connection-level failure evidence (refused dial, reset
        socket mid-RPC) — the tertiary suspicion signal. Heartbeats ride
        the DHT at multi-second cadence, so phi takes seconds to accrue on
        a peer that just dropped dead; a member that watched the peer's
        TCP connection die KNOWS, now. Holds the peer suspected for
        ``hold_s`` (default FAILURE_HOLD_S) regardless of phi, so successor
        election and formation pre-exclusion see the failure immediately.
        Cleared early by the next observed heartbeat (the peer healed)."""
        hold = self.FAILURE_HOLD_S if hold_s is None else float(hold_s)
        self._failed[peer] = self.clock() + hold

    def failure_reported(self, peer: str, now: Optional[float] = None) -> bool:
        """Is ``peer`` inside a reported-failure suspicion hold?"""
        expiry = self._failed.get(peer)
        if expiry is None:
            return False
        now = self.clock() if now is None else float(now)
        if now >= expiry:
            del self._failed[peer]
            return False
        return True

    def forget(self, peer: str) -> None:
        """Drop a peer's history (graceful leave / tombstone): a rejoiner
        starts with a clean distribution instead of inheriting the silence
        of its own absence as one giant inter-arrival sample."""
        self._last.pop(peer, None)
        self._gaps.pop(peer, None)
        self._lat.pop(peer, None)
        self._failed.pop(peer, None)

    # -- scoring -----------------------------------------------------------

    def phi(self, peer: str, now: Optional[float] = None) -> float:
        """Current suspicion for ``peer``; 0.0 for never-heard-from peers
        (no evidence either way — exclusion of unknowns is the caller's
        policy decision, not the detector's)."""
        last = self._last.get(peer)
        if last is None:
            return 0.0
        now = self.clock() if now is None else float(now)
        elapsed = now - last
        if elapsed <= 0:
            return 0.0
        gaps = self._gaps.get(peer)
        if gaps is None or len(gaps) < self.MIN_SAMPLES:
            mean, std = self.bootstrap_s, max(self.bootstrap_s / 2.0, self.min_std_s)
        else:
            n = len(gaps)
            mean = sum(gaps) / n
            var = sum((g - mean) ** 2 for g in gaps) / n
            std = max(math.sqrt(var), self.min_std_s)
        # Normal-model tail probability of a gap at least this long;
        # phi = -log10(P_later). erfc keeps precision in the far tail where
        # 1 - cdf would round to 0 (and phi to inf) around ~8 sigma.
        z = (elapsed - mean) / (std * math.sqrt(2.0))
        p_later = 0.5 * math.erfc(z)
        if p_later <= 0.0:
            return float("inf")
        return -math.log10(p_later)

    def suspect(self, peer: str, now: Optional[float] = None) -> bool:
        return (
            self.phi(peer, now) >= self.threshold
            or self.latency_suspect(peer)
            or self.failure_reported(peer, now)
        )

    def suspected(self, now: Optional[float] = None) -> Dict[str, float]:
        """{peer: phi} for every peer at/above the threshold right now."""
        now = self.clock() if now is None else float(now)
        out = {}
        for peer in list(self._last):
            p = self.phi(peer, now)
            if p >= self.threshold:
                out[peer] = p
        return out

    def snapshot(self) -> Dict[str, dict]:
        """Debug/metrics view: per-peer {phi, n_samples, mean_gap_s}."""
        now = self.clock()
        out = {}
        for peer in list(self._last):
            gaps = self._gaps.get(peer) or ()
            mean = sum(gaps) / len(gaps) if gaps else None
            lat = self._lat.get(peer)
            out[peer] = {
                "phi": round(self.phi(peer, now), 3),
                "n_samples": len(gaps),
                "mean_gap_s": round(mean, 4) if mean is not None else None,
                "lat_ewma_ms": round(lat[0] * 1e3, 3) if lat else None,
                "lat_suspect": self.latency_suspect(peer),
                "failure_reported": self.failure_reported(peer, now),
            }
        return out
