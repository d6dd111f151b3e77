"""Swarm membership: join/leave, heartbeat liveness, churn handling.

Reference parity (BASELINE.json:5): "a heartbeat and a join/leave handler"
adapted to TPU-VM volunteers — on TPU the dominant churn source is VM
PREEMPTION, so leave() is wired to SIGTERM (the preemption notice) as well as
normal shutdown (see swarm.volunteer).

Liveness is soft-state: each volunteer re-announces itself under the shared
``peers`` DHT key with a TTL; death == record expiry. Nobody has to observe a
crash — a kill -9'd volunteer vanishes from ``alive_peers()`` within one TTL
(SURVEY.md §3-E).

On top of the binary TTL, membership can feed a phi-accrual failure
detector (swarm/failure_detector.py): every time a peer's record timestamp
CHANGES between observations, that is one heartbeat arrival, and the
detector learns the peer's inter-arrival distribution. The TTL stays the
hard death line; phi is the earlier, continuous "probably stalled" signal
the matchmaker and resilience policy consult to pre-exclude stragglers
from rounds seconds before the record would expire.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional

from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)

PEERS_KEY = "peers"


class SwarmMembership:
    def __init__(
        self,
        dht: DHTNode,
        peer_id: str,
        ttl: float = 15.0,
        extra_info: Optional[dict] = None,
        failure_detector=None,
        bandwidth_source=None,
        control_plane=None,
        report_source=None,
        telemetry=None,
    ):
        self.dht = dht
        self.peer_id = peer_id
        self.ttl = ttl
        self.extra_info = extra_info or {}
        self.failure_detector = failure_detector
        # Replicated-control-plane client (swarm/control_plane.py): when
        # attached AND a live replica set is discovered, each heartbeat
        # interval coalesces announce + metrics report + peers-snapshot
        # refresh into ONE cp.exchange RPC to this peer's shard-owner
        # replica (vs a K-replica DHT store fan-out plus an iterative
        # lookup). Pure accelerator: any failure falls back to the direct
        # DHT path the same beat, so the record never gaps.
        self.control_plane = control_plane
        # Callable returning this volunteer's metrics report (the old
        # coord.report payload) to piggyback on batched beats; None = the
        # beat carries membership only.
        self.report_source = report_source
        # Message accounting per beat (transport RPC deltas — the honest
        # counter): proves the batching claim in stats().
        self.beats = 0
        self.batched_beats = 0
        self.direct_beats = 0
        # Whether the MOST RECENT beat went through a replica: consumers
        # deciding "is my report already riding the exchange" must read
        # this, not the cumulative counter — a volunteer that can see
        # replica records but cannot dial the replicas falls back to
        # direct beats (which carry no report) for the rest of its life,
        # and its metrics must flow through the legacy path again.
        self.last_beat_batched = False
        self.msgs_last_beat = 0
        self._msgs_ewma: Optional[float] = None
        # Telemetry plane (swarm/telemetry.py): per-beat control traffic
        # lands in the unified registry — beats and messages as labeled
        # counters (msgs_total/beats_total = the live mean the batching
        # claim rides on; the registry's histograms keep duration-scaled
        # buckets, so a message COUNT belongs in a counter, not there).
        # The volunteer report's telemetry SUMMARY rides the batched
        # exchange itself via report_source; this is the beat-side half.
        self._beat_ctr = self._beat_msgs_ctr = None
        if telemetry is not None and getattr(telemetry, "enabled", False):
            self._beat_ctr = telemetry.registry.counter(
                "swarm.beats_total", "heartbeat intervals by path"
            )
            self._beat_msgs_ctr = telemetry.registry.counter(
                "swarm.beat_msgs_total", "control messages spent across beats"
            )
        # Callable returning this node's measured-bandwidth advertisement
        # fields (Transport.bandwidth_advertisement: {"bw_up": bps,
        # "bw_down": bps}, {} when nothing fresh) — re-evaluated on EVERY
        # announce, so the advertisement refreshes with each heartbeat and
        # a stale estimate ages out of the record rather than lingering.
        # Consumers (the hierarchical group schedule's bandwidth-weighted
        # leader election) treat absent fields as "no advertisement".
        self.bandwidth_source = bandwidth_source
        # Last announce-timestamp seen per peer: a new heartbeat is a CHANGED
        # record ``t``, so observation cadence (who calls alive_peers, how
        # often) can't fabricate arrivals out of re-reads of the same record.
        self._seen_beats: dict = {}
        self._heartbeat_task: Optional[asyncio.Task] = None
        self._left = False
        # Sticky addr -> zone attribution (zone_by_addr): once a peer has
        # advertised a zone from an address, the mapping OUTLIVES its
        # membership record. Consumers sum cumulative transport byte
        # counters against this map (Averager.zone_traffic, rolled into
        # the coordinator's cross_zone_bytes_per_commit as windowed
        # deltas), so the attribution must be as monotone as the counters:
        # a peer missing one heartbeat must not subtract its lifetime
        # bytes from the sum and re-add them as a phantom burst when the
        # record reappears. Bounded (addresses are one-per-process).
        self._zone_cache: Dict[tuple, str] = {}
        # Last live read of the peers key, for alive_peers(max_age=...):
        # consumers on a round's critical path (the group schedule's
        # per-round split) accept a view one heartbeat old instead of
        # paying an iterative DHT lookup per round. Set keep_snapshot_fresh
        # to make the heartbeat loop refresh it even without a failure
        # detector attached.
        self._snapshot: Optional[Dict[str, dict]] = None
        self._snapshot_t = 0.0
        self.keep_snapshot_fresh = False

    def _record(self) -> dict:
        rec = {
            "addr": list(self.dht.transport.addr),
            "t": time.time(),
            **self.extra_info,
        }
        if self.bandwidth_source is not None:
            try:
                rec.update(self.bandwidth_source() or {})
            except Exception as e:  # noqa: BLE001 — advertisement is advisory
                log.debug("bandwidth advertisement failed: %s", errstr(e))
        return rec

    async def join(self) -> None:
        """Announce and start heartbeating. The direct DHT store runs
        unconditionally (a join must be durable even if every control-plane
        replica is mid-churn); with a control plane attached, a best-effort
        join exchange additionally registers us with our shard owner and
        seeds the first peers snapshot in the same round trip."""
        self._left = False
        await self.dht.store(PEERS_KEY, self._record(), subkey=self.peer_id, ttl=self.ttl)
        cp = self.control_plane
        if cp is not None:
            try:
                await cp.refresh()
                if cp.has_replicas:
                    ret = await cp.exchange(
                        self._record(), ttl=self.ttl, join=True,
                        report=self._build_report(),
                    )
                    if ret is not None:
                        self._adopt_records(self._reply_peers(cp, ret))
            except Exception as e:  # noqa: BLE001 — join exchange is best-effort
                log.debug("join exchange failed: %s", errstr(e))
        if self._heartbeat_task is None:
            self._heartbeat_task = asyncio.create_task(self._heartbeat_loop())
        log.info("peer %s joined swarm", self.peer_id)

    async def leave(self) -> None:
        """Graceful leave: tombstone the record (preemption path calls this).
        With a control plane, the tombstone also rides one exchange so the
        shard owner's served snapshots drop us immediately instead of after
        our last batched record expires."""
        self._left = True
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            self._heartbeat_task = None
        await self.dht.store(PEERS_KEY, None, subkey=self.peer_id, ttl=self.ttl)
        cp = self.control_plane
        if cp is not None and cp.has_replicas:
            try:
                await cp.exchange(None, ttl=self.ttl)
            except Exception:
                pass
        log.info("peer %s left swarm", self.peer_id)

    @staticmethod
    def _reply_peers(cp, ret: dict) -> dict:
        """The peers snapshot out of an exchange reply: resolved through
        the client's delta cache when it has one (replies may carry
        changes-since-version instead of the full map), with the legacy
        full-map shape as the fallback for older clients in tests."""
        merge = getattr(cp, "merge_peers_reply", None)
        if merge is not None:
            return merge(ret)
        return dict(ret.get("peers") or {})

    def _build_report(self) -> Optional[dict]:
        if self.report_source is None:
            return None
        try:
            return self.report_source()
        except Exception as e:  # noqa: BLE001 — a gauge bug must not kill beats
            log.debug("report source failed: %s", errstr(e))
            return None

    async def _beat_once(self) -> None:
        """One heartbeat interval's control traffic. Batched path first
        (one coalesced cp.exchange carrying announce + report, returning
        the peers snapshot + replica set); ANY failure — no replicas
        known, all reachable replicas dead, an RPC error — falls back to
        the direct DHT announce the same beat, so a control-plane outage
        can neither expire our record nor stall this loop (the client's
        calls are fast-fail with bounded AIMD backoff per replica)."""
        transport = self.dht.transport
        rpcs0 = transport.rpcs_sent
        batched = False
        cp = self.control_plane
        if cp is not None and not self._left:
            try:
                if not cp.has_replicas:
                    # Discovery (TTL'd): one DHT read, only while we know
                    # of no live replica — steady-state batched beats learn
                    # the set from exchange replies for free.
                    await cp.refresh()
                if cp.has_replicas:
                    ret = await cp.exchange(
                        self._record(), ttl=self.ttl,
                        report=self._build_report(),
                    )
                    if ret is None:
                        # Every replica this client knew refused/died. Its
                        # view can be corpse-heavy under replica churn
                        # (reply-confirmed sets lag fresh spawns by one
                        # serving-replica tick): re-discover from the DHT
                        # — the authoritative live set, fresh replicas
                        # announce there first — and retry ONCE within the
                        # same beat, so a kill-plus-replace costs zero
                        # batched beats instead of one.
                        await cp.refresh(force=True)
                        if cp.has_replicas:
                            ret = await cp.exchange(
                                self._record(), ttl=self.ttl,
                                report=self._build_report(),
                            )
                    if ret is not None:
                        self._adopt_records(self._reply_peers(cp, ret))
                        batched = True
            except Exception as e:  # noqa: BLE001 — exchange is an accelerator
                log.debug("batched beat failed: %s", errstr(e))
        if not batched:
            await self.dht.store(
                PEERS_KEY, self._record(), subkey=self.peer_id, ttl=self.ttl
            )
            if self.failure_detector is not None or self.keep_snapshot_fresh:
                # Piggyback one observation pass per own beat: the
                # detector keeps accruing even when nothing else on
                # this node happens to call alive_peers (an idle
                # trainer between wall-clock cadence boundaries),
                # and the snapshot stays one-beat fresh for
                # max_age readers.
                await self.alive_peers()
        self.beats += 1
        self.last_beat_batched = batched
        if batched:
            self.batched_beats += 1
            # Exact: the client's own attempt count for THIS exchange (1 +
            # failover tries). A transport-global counter delta would bill
            # whatever averaging-round RPCs happened to be in flight across
            # the exchange's await to the beat.
            self.msgs_last_beat = max(cp.last_call_attempts, 1)
        else:
            self.direct_beats += 1
            # Transport delta: the direct path's store fan-out + snapshot
            # lookup all issue from this coroutine, so the delta is the
            # beat's own traffic up to concurrent-round noise (an upper
            # bound; exactness matters for the batched number above, which
            # is the one the batching claim rides on).
            self.msgs_last_beat = transport.rpcs_sent - rpcs0
        a = 0.2
        self._msgs_ewma = (
            float(self.msgs_last_beat)
            if self._msgs_ewma is None
            else (1 - a) * self._msgs_ewma + a * self.msgs_last_beat
        )
        if self._beat_ctr is not None:
            path = "batched" if batched else "direct"
            self._beat_ctr.inc(path=path)
            self._beat_msgs_ctr.inc(float(self.msgs_last_beat), path=path)

    async def _heartbeat_loop(self) -> None:
        # Re-announce at TTL/3: two missed beats still leave the record live.
        try:
            while not self._left:
                await asyncio.sleep(self.ttl / 3.0)
                try:
                    await self._beat_once()
                except Exception as e:
                    log.warning("heartbeat store failed: %s", errstr(e))
        except asyncio.CancelledError:
            pass

    def stats(self) -> dict:
        """Control-traffic accounting: RPC messages this node spent per
        heartbeat interval (transport-counter deltas, so DHT store fan-out
        and lookups are all counted) — the number the batched control
        plane exists to shrink (one coalesced exchange vs ~K store RPCs +
        a lookup per beat)."""
        out = {
            "mode": "batched" if self.batched_beats > self.direct_beats else "direct",
            "beats": self.beats,
            "batched_beats": self.batched_beats,
            "direct_beats": self.direct_beats,
            "msgs_last_beat": self.msgs_last_beat,
            "msgs_per_interval_ewma": (
                round(self._msgs_ewma, 2) if self._msgs_ewma is not None else None
            ),
        }
        if self.control_plane is not None:
            out["client"] = self.control_plane.stats()
        return out

    def _observe_beats(self, records: Dict[str, dict]) -> None:
        """Feed the phi-accrual detector: a peer whose announce timestamp
        changed since the last observation produced one heartbeat arrival
        (stamped at the LOCAL monotonic clock — sender timestamps are only
        compared for change, never trusted as times)."""
        fd = self.failure_detector
        if fd is None:
            return
        transport = self.dht.transport
        for pid, rec in records.items():
            if pid == self.peer_id:
                continue
            t = rec.get("t")
            if isinstance(t, (int, float)) and self._seen_beats.get(pid) != t:
                self._seen_beats[pid] = t
                fd.heartbeat(pid)
            # Secondary signal: the pooled transport's per-peer RPC latency
            # EWMA, mapped from the record's advertised address to the peer
            # id here (the one place both are known). Heartbeats ride the
            # DHT at a multi-second cadence; the RPC latency notices a
            # congested/paging peer rounds earlier.
            addr = rec.get("addr")
            if isinstance(addr, (list, tuple)) and len(addr) == 2:
                lat = transport.peer_latency(addr)
                if lat is not None:
                    fd.observe_latency(pid, lat)

    async def alive_peers(
        self,
        include_self: bool = True,
        exclude_suspected: bool = False,
        max_age: float = 0.0,
    ) -> Dict[str, dict]:
        """Live peer_id -> record; tombstones (None) are filtered out.

        ``exclude_suspected`` additionally drops peers the phi-accrual
        detector currently suspects — the soft pre-exclusion consumers like
        gossip partner selection opt into (the hard TTL filter always
        applies).

        ``max_age`` > 0 accepts a cached view at most that old instead of
        walking the DHT — for per-round consumers (the group schedule's
        split) where one heartbeat interval of staleness only ever costs
        an underfilled formation, never correctness. Detector bookkeeping
        runs on live reads only (a cache re-read carries no new beats)."""
        if (
            max_age > 0
            and self._snapshot is not None
            and time.monotonic() - self._snapshot_t <= max_age
        ):
            out = dict(self._snapshot)
            if self.failure_detector is not None and exclude_suspected:
                out = {
                    pid: info
                    for pid, info in out.items()
                    if pid == self.peer_id
                    or not self.failure_detector.suspect(pid)
                }
            if not include_self:
                out.pop(self.peer_id, None)
            return out
        rec = await self.dht.get(PEERS_KEY)
        out = self._adopt_records(rec)
        if self.failure_detector is not None:
            if exclude_suspected:
                out = {
                    pid: info
                    for pid, info in out.items()
                    if pid == self.peer_id or not self.failure_detector.suspect(pid)
                }
        if not include_self:
            out.pop(self.peer_id, None)
        return out

    def _adopt_records(self, rec: Dict[str, Optional[dict]]) -> Dict[str, dict]:
        """Adopt one live view of the peers key (a DHT read, or a batched
        exchange reply's snapshot): filter tombstones, refresh the cached
        snapshot, feed the failure detector, and forget departed peers so
        they stop accruing suspicion. Returns the live records."""
        out = {pid: info for pid, info in rec.items() if info is not None}
        self._snapshot = dict(out)
        self._snapshot_t = time.monotonic()
        self._observe_beats(out)
        if self.failure_detector is not None:
            # A tombstoned/expired peer must not keep accruing silence as
            # suspicion — its next join starts with a clean history.
            for pid in [p for p in self._seen_beats if p not in out]:
                self._seen_beats.pop(pid, None)
                self.failure_detector.forget(pid)
        return out

    def peer_record(self, peer_id: str) -> Optional[dict]:
        """The cached membership record for ``peer_id`` (our own record
        included), from the last live read — NO DHT walk, so it is safe on
        a round's critical path. None before the first read or for an
        unknown peer. The hierarchical schedule and the bandwidth-weighted
        leader election read zones/bandwidth advertisements through this:
        every member consults the same soft state, so their choices agree
        up to one heartbeat of staleness (divergence costs an underfilled
        round via begin-wins, never mixed tensors)."""
        if peer_id == self.peer_id and (
            self._snapshot is None or peer_id not in self._snapshot
        ):
            return self._record()
        if self._snapshot is None:
            return None
        return self._snapshot.get(peer_id)

    MAX_ZONE_CACHE = 4096

    def zone_by_addr(self) -> Dict[tuple, str]:
        """Advertised zone per peer ADDRESS — the join key for charging
        the transport's per-peer byte counters to zones (the transport
        knows addresses, membership knows zones; this is where both are
        known). STICKY: entries learned from any snapshot persist after
        the record expires, so byte sums over cumulative counters stay
        monotone through heartbeat churn (a one-beat record gap must not
        read as the peer's lifetime traffic vanishing and reappearing)."""
        cache = self._zone_cache
        for rec in (self._snapshot or {}).values():
            addr = rec.get("addr")
            if isinstance(addr, (list, tuple)) and len(addr) == 2:
                key = (str(addr[0]), int(addr[1]))
                zone = str(rec.get("zone") or "")
                if not zone and cache.get(key):
                    # Never downgrade a zoned attribution to "": a
                    # restarted (or zone-stripped) peer on a known address
                    # would flip that address's historical bytes from
                    # cross to intra (or back) and dip the cumulative sum.
                    # A real zone CHANGE (zone -> other zone) still lands.
                    continue
                if key not in cache and len(cache) >= self.MAX_ZONE_CACHE:
                    cache.clear()  # churn far beyond any real swarm; reset
                cache[key] = zone
        return dict(cache)

    def invalidate_snapshot(self) -> None:
        """Force the next ``alive_peers(max_age=...)`` to walk the DHT.
        Called by consumers whose operation FAILED in a way stale
        membership explains (a scheduled group that never formed): the
        cheap view was wrong, buy a fresh one."""
        self._snapshot = None

    def update_info(self, **kv: object) -> None:
        """Update fields (e.g. current step) carried in the next heartbeat."""
        self.extra_info.update(kv)
