"""Sharded, replicated control plane: membership/matchmaking state in the
swarm itself, served by elected coordinator replicas.

PRs 1-8 made the data plane survive leader death, stragglers, partitions,
and zone-level churn — but the coordinator stayed one stateful host holding
membership rollups and ``coord.status``; kill it and the swarm went blind.
At scale the CONTROL plane, not the data plane, is what breaks first (the
100k-GPU HSDP observation in PAPERS.md), and Moshpit-style matchmaking shows
the state belongs in the DHT. This module makes coordinator death a
non-event:

- **State lives in the DHT.** Membership records were already DHT soft
  state (``peers``); the per-peer metrics rollups that used to live only in
  the coordinator's process memory now ride TTL'd DHT records
  (``cp/rollup``), so ANY replica can serve ``coord.status`` by merging
  them.
- **Elected replicas, key-range sharded.** Every candidate (a standalone
  coordinator process, or any volunteer run with ``--host-replica``)
  announces under ``cp/replicas``; the ACTIVE set is the first
  ``MAX_REPLICAS`` live candidates in replica-id order — the same
  deterministic smallest-id election every other leader slot in this repo
  uses, computed by everyone from the same soft state. The 160-bit peer-id
  keyspace is cut into ``N_SHARDS`` fixed arcs; active replica *i* of *R*
  owns the contiguous shard range ``[i*S/R, (i+1)*S/R)`` and ingests
  reports / flushes heartbeats / writes rollups for the peers whose ids
  hash into it.
- **Epoch-fenced handoff.** Shard ownership moves on replica churn exactly
  the way round leadership moved in PR 4: the acquiring replica bumps the
  shard's GENERATION and every control-plane write carries it
  (``DHTNode.store(fence=gen)``); storage nodes refuse writes below their
  watermark, so a deposed/partitioned ex-replica's late rollup can never
  shadow the new owner's on any node that saw the claim. Status merges
  additionally prefer the highest generation among the rollup records they
  read, and the owner re-writes every tick — so a laggard storage node
  that accepted stale bytes is corrected within one interval (the
  record-level merge inside one ``dht.get`` is freshness-based, not
  generation-based; the exposure is tick-bounded, not eliminated).
- **Batched heartbeats.** A volunteer's per-interval control traffic —
  membership announce + metrics report + peers-snapshot refresh — coalesces
  into ONE ``cp.exchange`` RPC to its shard owner (PR 2 made the connection
  cheap; this cuts the message count). The replica flushes a whole shard's
  records to the DHT as one batched ``dht.store`` frame per storage
  replica (``store_many``), so N peers' beats cost O(K) RPCs per interval
  instead of O(N*K). Volunteers fall back to the direct DHT path the
  moment no replica answers — the control plane accelerates the swarm, it
  never gates it.

Trust model matches the rest of the swarm: replicas are honest-but-mortal
(transport HMAC keeps outsiders out; a Byzantine replica is out of scope —
it could already lie in ``coord.status``, which steers no tensor).
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from typing import Dict, List, Optional, Tuple

from distributedvolunteercomputing_tpu_torch.swarm.dht import (
    ID_BITS,
    DHTNode,
    StaleWriteFenced,
    key_id,
)
from distributedvolunteercomputing_tpu_torch.swarm.membership import PEERS_KEY
from distributedvolunteercomputing_tpu_torch.swarm import controller as controller_mod
from distributedvolunteercomputing_tpu_torch.swarm import health as health_mod
from distributedvolunteercomputing_tpu_torch.swarm import telemetry as telemetry_mod
from distributedvolunteercomputing_tpu_torch.swarm import watchdog as watchdog_mod
from distributedvolunteercomputing_tpu_torch.swarm.transport import Addr, Transport
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)

REPLICAS_KEY = "cp/replicas"
ROLLUP_KEY = "cp/rollup"
# Fixed shard count, independent of how many replicas are live: ownership
# generations are PER SHARD, so the shard grid must not re-index itself
# when a replica joins or dies (only the owner mapping moves).
N_SHARDS = 16
# Active-set cap: candidates beyond this stay hot standbys (announced,
# serving status reads, owning nothing) until churn promotes them.
MAX_REPLICAS = 5


def shard_of(peer_id: str) -> int:
    """Fixed key-range shard a peer id hashes into (equal arcs of the
    160-bit keyspace — the same arc idiom the group schedule uses)."""
    return (key_id(peer_id) * N_SHARDS) >> ID_BITS


def owner_index(shard: int, n_replicas: int) -> int:
    """Which active replica (by index in rid-sorted order) owns ``shard``:
    contiguous ranges, so each replica serves one key range."""
    return shard * n_replicas // N_SHARDS


def active_replicas(records: Dict[str, dict]) -> List[Tuple[str, Addr]]:
    """The elected ACTIVE replica set from ``cp/replicas`` soft state:
    live, non-retiring candidates in rid order, first MAX_REPLICAS.
    Deterministic and local — every volunteer computes the same set from
    the same records, no negotiation (divergence from staleness costs one
    misrouted-then-failed-over RPC, never lost state)."""
    out: List[Tuple[str, Addr]] = []
    for rid in sorted(records):
        rec = records.get(rid)
        if not isinstance(rec, dict) or rec.get("retiring"):
            continue
        addr = rec.get("addr")
        if isinstance(addr, (list, tuple)) and len(addr) == 2:
            out.append((rid, (str(addr[0]), int(addr[1]))))
    return out[:MAX_REPLICAS]


class ControlPlaneReplica:
    """One control-plane replica: stateless-front coordinator logic any
    host can run. All durable state is DHT soft state; everything held in
    process memory is a cache or at most one reporting window deep, so a
    SIGKILL loses nothing a surviving replica can't re-serve within one
    heartbeat interval."""

    REPLICA_TTL = 15.0
    ROLLUP_TTL = 75.0
    # Reports older than this fall out of status rollups (same freshness
    # line the single coordinator drew).
    FRESH_S = 60.0
    COMMIT_WINDOW_S = 60.0
    # Volunteer ids are fresh uuids per process, so churn would grow the
    # per-peer maps without bound on a long-running replica; a peer silent
    # this long is dropped (a late reappearance re-seeds its commit
    # baseline at delta 0, identical to first sight).
    STALE_PEER_TTL_S = 600.0
    # Rendezvous read micro-cache: every member of a forming group polls
    # the same round key at ~100 ms cadence; one iterative DHT lookup per
    # cache window serves them all.
    RENDEZVOUS_CACHE_S = 0.25
    MAX_RENDEZVOUS_CACHE = 128
    RETIRE_TTL = 5.0

    def __init__(
        self,
        transport: Transport,
        dht: DHTNode,
        rid: Optional[str] = None,
        interval: Optional[float] = None,
        metrics_path: Optional[str] = None,
        telemetry=None,
    ):
        self.transport = transport
        self.dht = dht
        # Replica id: ELECTION RANK (smallest-id-first, like every leader
        # slot here). Stable per host:port so a restarted replica re-takes
        # its slot instead of reshuffling every shard. Resolved at start()
        # when no explicit id was given (the bound port isn't known yet).
        self._rid_given = rid
        self.rid = rid or f"cpr-{key_id(f'{transport.addr}') % 10**10:010d}"
        self.interval = float(interval) if interval else self.REPLICA_TTL / 3.0
        self.metrics_path = metrics_path
        self._t0 = time.time()
        # peer -> latest report (+recv_t): the live ingestion cache; the
        # durable form is the per-shard DHT rollup written every tick.
        self.latest_metrics: Dict[str, dict] = {}
        # Commit-rate / cross-zone-byte windows, PER SHARD so they ride the
        # shard's rollup record and survive this replica's death (the new
        # owner adopts the freshest rollup's window and re-seeds deltas).
        self._commit_seen: Dict[str, int] = {}
        self._commit_window: Dict[int, list] = {}
        self._xz_seen: Dict[str, int] = {}
        self._xz_window: Dict[int, list] = {}
        # Membership records heartbeated THROUGH this replica (batched
        # cp.exchange): pid -> (record_or_tombstone, expiry_mono, ttl).
        self._mem_records: Dict[str, Tuple[Optional[dict], float, float]] = {}
        self._mem_dirty: set = set()
        # Cached DHT views (refreshed once per tick, serving every client
        # between ticks): the whole point — N clients cost O(1) lookups.
        self._peers_view: Dict[str, object] = {}
        self._replica_view: Dict[str, dict] = {}
        self._rollup_view: Dict[str, dict] = {}
        self._views_t = 0.0
        # Peers-snapshot delta state (batched exchange replies ship
        # changes-since-version instead of the full map every beat — at
        # fleet scale the full map is the dominant control-plane byte
        # stream). _pv is this replica's monotone snapshot version;
        # _psig holds per-peer SIGNIFICANCE signatures (the beat
        # timestamp and jittery measured floats excluded — else every
        # record "changes" every beat and deltas degenerate to fulls);
        # _plog is the (version, pid) change log a delta is computed
        # from, trimmed whole-version-batches at a time so _plog_floor
        # (the oldest version a delta can be served FROM) is exact.
        # Versions are PER-REPLICA: clients echo (rid, version) and a
        # failover lands on a replica whose rid mismatch forces one
        # full-replace — stale-version fallback, by construction.
        self._pv = 0
        self._psig: Dict[str, str] = {}
        self._plog: List[Tuple[int, str]] = []
        self._plog_floor = 0
        self._psig_t = 0.0
        self._rendezvous_cache: Dict[str, Tuple[float, dict]] = {}
        # shard -> generation this replica owns it at (fence for writes).
        self._shard_gens: Dict[int, int] = {}
        # Highest fence watermark ever reported back for a shard
        # (StaleWriteFenced.gen): re-acquisition must claim ABOVE it, not
        # above the rollup record's gen — the record TTLs out in ~75s
        # while the watermark holds for FENCE_TTL (600s), and deriving the
        # claim from the record alone would livelock the shard against
        # the watermark for the difference (claim gen 1, fenced by gen 5,
        # drop, repeat) after any ownership gap longer than ROLLUP_TTL.
        self._gen_floor: Dict[int, int] = {}
        self.retiring = False
        # Peer replicas that failed a liveness probe (rid -> expiry_mono):
        # pruned from the active set and from every served replica view,
        # so a SIGKILLed replica disappears from the control plane within
        # ONE TICK — clients and ownership handoff do not wait out the
        # replica record's TTL. Negative-cached briefly so a corpse is
        # not re-probed every tick forever; a revived replica re-enters
        # once the cache entry lapses (ping-before-evict, control-plane
        # edition).
        self._dead_replicas: Dict[str, float] = {}
        # Consecutive soft probe failures per peer replica (see
        # _probe_replicas): one timeout under load must not depose a live
        # replica.
        self._probe_strikes: Dict[str, int] = {}
        self._tick_task: Optional[asyncio.Task] = None
        # Load/observability counters (the control-plane bench reads these).
        self.counters: Dict[str, int] = {
            "exchanges": 0, "joins": 0, "reports": 0, "status_served": 0,
            "rendezvous_served": 0, "rendezvous_lookups": 0,
            "rollup_writes": 0, "rollups_fenced": 0, "shards_acquired": 0,
            "shards_released": 0, "mem_flushed": 0,
            "peers_delta_replies": 0, "peers_full_replies": 0,
        }
        transport.register("coord.report", self._rpc_report)
        transport.register("coord.status", self._rpc_status)
        transport.register("cp.exchange", self._rpc_exchange)
        transport.register("cp.rendezvous", self._rpc_rendezvous)
        transport.register("cp.ping", self._rpc_ping)
        # Replica-side telemetry: the load counters re-register into a
        # scrapeable registry, and the telemetry.* debug RPCs answer on
        # the replica's transport too (a coordinator is also a fleet
        # member). A volunteer hosting a replica passes its OWN bundle —
        # the shared transport already serves that bundle's RPCs, so the
        # replica source lands in the registry every scrape reaches (and
        # honors the host's --no-telemetry); a standalone coordinator
        # gets a private bundle plus the RPC registration.
        if telemetry is not None:
            self.telemetry = telemetry
        else:
            self.telemetry = telemetry_mod.Telemetry(peer_id=self.rid)
            self.telemetry.register_rpcs(transport)
        self.telemetry.registry.source("control_plane.replica", self.stats)
        # Swarm watchdog (swarm/watchdog.py): SLO burn rates over the
        # merged rollup plus the swarm-level detectors no volunteer can
        # see (cross-zone mixing stall), evaluated once per tick and
        # served as coord.status["slo"] / ["alerts"]. Replica-side only —
        # pure rollup math, no per-round cost — so it stays on even when
        # a hosting volunteer disabled its own telemetry.
        self.watchdog = watchdog_mod.SwarmWatchdog(
            recorder=self.telemetry.recorder, peer_id=self.rid,
        )

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        if self._rid_given is None:
            self.rid = f"cpr-{key_id(f'{self.transport.addr}') % 10**10:010d}"
        await self._announce()
        await self._refresh_views()
        await self._recompute_ownership()
        # Claim writes for acquired shards go out IMMEDIATELY: the fenced
        # store is what raises the watermark that deposes the previous
        # owner — waiting a tick would leave a handoff window where its
        # stale writes still land.
        await self._write_rollups()
        self._tick_task = asyncio.create_task(self._tick_loop())
        log.info(
            "control-plane replica %s up on %s:%d (owns %d/%d shards)",
            self.rid, *self.transport.addr, len(self._shard_gens), N_SHARDS,
        )

    async def stop(self) -> None:
        if self._tick_task is not None:
            self._tick_task.cancel()
            try:
                await self._tick_task
            except (asyncio.CancelledError, Exception):
                pass
            self._tick_task = None

    async def retire(self, grace: float = 0.5) -> None:
        """Graceful shutdown (SIGTERM): publish a RETIRING tombstone under
        our replica record so volunteers and peer replicas re-resolve the
        active set immediately — within one exchange round-trip — instead
        of waiting for the record's TTL to expire. Keeps serving for
        ``grace`` so in-flight exchanges drain and the tombstone
        propagates; one final membership flush so records heartbeated
        through us don't gap while their owners re-route."""
        self.retiring = True
        try:
            await self.dht.store(
                REPLICAS_KEY, self._self_record(), subkey=self.rid,
                ttl=self.RETIRE_TTL,
            )
        except Exception as e:  # noqa: BLE001 — retiring must not hang shutdown
            log.warning("retire tombstone store failed: %s", errstr(e))
        try:
            await self._flush_mem_records(force=True)
        except Exception:
            pass
        if grace > 0:
            await asyncio.sleep(grace)
        await self.stop()
        log.info("control-plane replica %s retired", self.rid)

    def _self_record(self) -> dict:
        rec = {"addr": list(self.transport.addr), "t": time.time()}
        if self.retiring:
            rec["retiring"] = True
        return rec

    async def _announce(self) -> None:
        await self.dht.store(
            REPLICAS_KEY, self._self_record(), subkey=self.rid,
            ttl=self.RETIRE_TTL if self.retiring else self.REPLICA_TTL,
        )

    # -- periodic tick -----------------------------------------------------

    async def _tick_loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                await self._announce()
                await self._refresh_views()
                await self._probe_replicas()
                await self._recompute_ownership()
                await self._flush_mem_records()
                await self._write_rollups()
                self._sweep()
                self._eval_watchdog()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — the tick must not die
                log.warning("control-plane tick failed: %s", errstr(e))

    async def _rpc_ping(self, args: dict, payload: bytes):
        return {"rid": self.rid, "retiring": self.retiring}, b""

    async def _probe_replicas(self) -> None:
        """Liveness-probe the peer replicas in view (a handful, concurrent,
        fast-fail) and prune non-responders: a SIGKILLed replica must fall
        out of the ACTIVE set — and therefore out of every served replica
        view and the shard ownership map — within one tick, not one record
        TTL. A probe false-positive (a briefly-stalled replica) costs one
        spurious handoff generation, which the fencing arbitrates; the
        negative cache keeps a real corpse from being re-dialed every
        tick."""
        now = time.monotonic()
        self._dead_replicas = {
            r: e for r, e in self._dead_replicas.items() if e > now
        }
        targets = [
            (rid, rec.get("addr"))
            for rid, rec in self._replica_view.items()
            if rid != self.rid
            and rid not in self._dead_replicas
            and isinstance(rec.get("addr"), (list, tuple))
        ]
        if not targets:
            return

        async def probe(rid, addr):
            try:
                await self.transport.call(
                    tuple(addr), "cp.ping", {},
                    timeout=1.5, connect_timeout=1.0,
                )
                return rid, "ok"
            except ConnectionRefusedError:
                # Nothing listens on the advertised port: a genuine corpse
                # (SIGKILL path) — prune immediately.
                return rid, "dead"
            except Exception:  # noqa: BLE001 — timeout/transient
                # SOFT failure: a probe can time out because OUR loop or
                # the peer's is briefly saturated — one strike must not
                # depose a live replica (the false positive would ripple
                # into every served client view).
                return rid, "soft"

        for rid, verdict in await asyncio.gather(
            *(probe(rid, addr) for rid, addr in targets)
        ):
            if verdict == "ok":
                self._probe_strikes.pop(rid, None)
                continue
            strikes = self._probe_strikes.get(rid, 0) + 1
            self._probe_strikes[rid] = strikes
            if verdict == "dead" or strikes >= 2:
                self._dead_replicas[rid] = now + 4 * self.interval
                self._probe_strikes.pop(rid, None)
                log.info(
                    "replica %s: peer replica %s failed liveness probe "
                    "(%s), pruning from active set", self.rid, rid, verdict,
                )

    async def _refresh_views(self) -> None:
        # Stamped BEFORE the walks: concurrent exchanges must not stampede
        # duplicate lookups while one refresh is in flight.
        self._views_t = time.monotonic()
        self._replica_view = {
            rid: rec
            for rid, rec in (await self.dht.get(REPLICAS_KEY)).items()
            if isinstance(rec, dict)
        }
        # Tombstones (None) kept: a snapshot served to clients must carry
        # them so a leave propagates through batched beats too.
        self._peers_view = dict(await self.dht.get(PEERS_KEY))
        self._rollup_view = {
            sk: rec
            for sk, rec in (await self.dht.get(ROLLUP_KEY)).items()
            if isinstance(rec, dict)
        }

    def _live_replica_view(self) -> Dict[str, dict]:
        now = time.monotonic()
        return {
            rid: rec
            for rid, rec in self._replica_view.items()
            if not (
                rid in self._dead_replicas and self._dead_replicas[rid] > now
            )
        }

    def active_set(self) -> List[Tuple[str, Addr]]:
        view = self._live_replica_view()
        if not self.retiring:
            view[self.rid] = self._self_record()
        return active_replicas(view)

    async def _recompute_ownership(self) -> None:
        """Key-range handoff: recompute which shards this replica owns
        under the current active set; ACQUIRED shards claim generation =
        (highest seen in the shard's rollup record) + 1 — the PR-4 fencing
        move — so the deposed owner's next fenced write is refused."""
        active = self.active_set()
        rids = [rid for rid, _ in active]
        if self.retiring or self.rid not in rids:
            owned: set = set()
        else:
            i = rids.index(self.rid)
            owned = {
                s for s in range(N_SHARDS) if owner_index(s, len(rids)) == i
            }
        released = [s for s in self._shard_gens if s not in owned]
        for s in released:
            del self._shard_gens[s]
            # The windows go with the shard: keeping them would double-
            # count those deltas if this replica re-acquires later (it
            # re-adopts the then-current rollup's window below).
            self._commit_window.pop(s, None)
            self._xz_window.pop(s, None)
            self.counters["shards_released"] += 1
        fresh = [s for s in owned if s not in self._shard_gens]
        if released or fresh:
            # The per-peer delta BASELINES go with the shard too: a stale
            # baseline surviving a release/acquire cycle would compute a
            # delta spanning the other owner's tenure — commits already in
            # the adopted rollup window — and double-count them. Dropping
            # the baseline re-seeds the peer at first sight (delta 0), the
            # same contract a fresh replica has.
            moved = set(released) | set(fresh)
            for seen in (self._commit_seen, self._xz_seen):
                for pid in [p for p in seen if shard_of(p) in moved]:
                    del seen[pid]
        for s in fresh:
            prev = self._rollup_view.get(f"s{s}") or {}
            self._shard_gens[s] = (
                max(int(prev.get("gen") or 0), self._gen_floor.get(s, 0)) + 1
            )
            self.counters["shards_acquired"] += 1
            # ADOPT (replace, never merge) the previous owner's reporting
            # window so the commit-rate gauge survives the handoff: the
            # rollup is the authoritative view, and merging could repeat
            # deltas this replica saw in an earlier ownership stint.
            # Per-peer deltas re-seed at first sight, losing at most one
            # report per peer.
            self._commit_window[s] = [
                (float(t), int(d)) for t, d in (prev.get("commit_window") or [])
            ]
            self._xz_window[s] = [
                (float(t), int(d)) for t, d in (prev.get("xz_window") or [])
            ]
        if fresh:
            log.info(
                "replica %s acquired shards %s (gens %s)", self.rid,
                sorted(fresh), {s: self._shard_gens[s] for s in fresh},
            )

    async def _flush_mem_records(self, force: bool = False) -> None:
        """Write the membership records heartbeated through this replica to
        the shared ``peers`` DHT key — ONE batched store frame per storage
        replica for the whole cohort (vs one fan-out per peer on the
        direct path). Unfenced: membership subkeys are per-peer records
        only their own peer writes, so there is no cross-writer race for a
        generation to arbitrate."""
        now = time.monotonic()
        live = {
            pid: (rec, exp, ttl)
            for pid, (rec, exp, ttl) in self._mem_records.items()
            if exp > now
        }
        self._mem_records = live
        dirty = set(live) if force else (self._mem_dirty & set(live))
        self._mem_dirty = set()
        if not dirty:
            return
        await self.dht.store_many(
            PEERS_KEY,
            {pid: live[pid][0] for pid in dirty},
            ttls={pid: live[pid][2] for pid in dirty},
        )
        self.counters["mem_flushed"] += len(dirty)

    async def _write_rollups(self) -> None:
        """Fenced per-shard rollup writes: the durable (DHT) form of this
        replica's ingested reports. A StaleWriteFenced reply means a newer
        generation owns the shard — stop writing it and re-resolve."""
        now = time.time()
        fresh_cutoff = now - self.FRESH_S
        by_shard: Dict[int, Dict[str, dict]] = {}
        for pid, m in self.latest_metrics.items():
            if m.get("recv_t", 0) >= fresh_cutoff:
                by_shard.setdefault(shard_of(pid), {})[pid] = m
        for s in list(self._shard_gens):
            gen = self._shard_gens[s]
            cw = [
                (t, d) for t, d in self._commit_window.get(s, [])
                if t >= now - self.COMMIT_WINDOW_S
            ]
            xw = [
                (t, d) for t, d in self._xz_window.get(s, [])
                if t >= now - self.COMMIT_WINDOW_S
            ]
            self._commit_window[s] = cw
            self._xz_window[s] = xw
            rec = {
                "gen": gen,
                "rid": self.rid,
                "t": now,
                "peers": by_shard.get(s, {}),
                "commit_window": cw,
                "xz_window": xw,
            }
            try:
                # fence_owner arbitrates equal-generation claims from two
                # replicas with split views: smallest rid wins, the other
                # gets StaleWriteFenced and escalates — never a silent
                # dual-writer.
                await self.dht.store(
                    ROLLUP_KEY, rec, subkey=f"s{s}", ttl=self.ROLLUP_TTL,
                    fence=gen, fence_owner=self.rid,
                )
                self.counters["rollup_writes"] += 1
            except StaleWriteFenced as e:
                # Deposed: a newer owner claimed this key range while our
                # view was stale. Drop it now — the next tick's ownership
                # recompute decides whether we re-acquire, and the recorded
                # watermark floor guarantees any re-claim lands ABOVE the
                # generation that fenced us (the rollup record it would
                # otherwise derive from may long have expired).
                log.info(
                    "replica %s fenced off shard %d (watermark gen %d > "
                    "ours %d)", self.rid, s, e.gen, gen,
                )
                self._gen_floor[s] = max(self._gen_floor.get(s, 0), e.gen)
                self._shard_gens.pop(s, None)
                self.counters["rollups_fenced"] += 1
                self.counters["shards_released"] += 1

    def _eval_watchdog(self) -> None:
        """One SLO/detector evaluation over the merged view (tick-paced;
        the status path re-evaluates lazily under the same spacing guard).
        Advisory: a watchdog bug must never take the tick down."""
        try:
            fresh_map, commit_w, xz_w = self._merged_metrics()
            fresh = list(fresh_map.values())
            self.watchdog.evaluate(
                fresh,
                multigroup=self._multigroup_rollup(fresh, commit_w, xz_w),
                health=health_mod.rollup_status(fresh),
            )
        except Exception as e:  # noqa: BLE001
            log.debug("watchdog evaluation failed: %s", errstr(e))

    @staticmethod
    def _stamp_age(rollup: Optional[dict], fresh: list, now: float) -> Optional[dict]:
        """Staleness stamp for a status rollup section: seconds since the
        freshest contributing report landed — a frozen replica serves a
        growing age_s, a healthy quiet swarm a small one."""
        if rollup is None:
            return None
        recvs = [
            m.get("recv_t") for m in fresh
            if isinstance(m.get("recv_t"), (int, float))
        ]
        rollup["age_s"] = round(max(0.0, now - max(recvs)) if recvs else -1.0, 3)
        return rollup

    def _sweep(self) -> None:
        now = time.time()
        for p in [
            p for p, m in self.latest_metrics.items()
            if now - m.get("recv_t", 0) > self.STALE_PEER_TTL_S
        ]:
            self.latest_metrics.pop(p, None)
            self._commit_seen.pop(p, None)
            self._xz_seen.pop(p, None)
        # Windows for UNOWNED shards (strays ingested while a cohort
        # failed over through us) are trimmed here — the rollup writer
        # only trims the owned ones — so they cannot grow for the process
        # lifetime.
        cutoff = now - self.COMMIT_WINDOW_S
        for wmap in (self._commit_window, self._xz_window):
            for s in list(wmap):
                wmap[s] = [(t, d) for t, d in wmap[s] if t >= cutoff]
                if not wmap[s] and s not in self._shard_gens:
                    del wmap[s]
        if len(self._rendezvous_cache) > self.MAX_RENDEZVOUS_CACHE:
            self._rendezvous_cache.clear()

    # -- ingestion ---------------------------------------------------------

    def _ingest_report(self, report: dict) -> None:
        import json as _json

        peer = str(report.get("peer", "?"))
        now = time.time()
        self.latest_metrics[peer] = {**report, "recv_t": now}
        s = shard_of(peer)
        groups = report.get("groups")
        if isinstance(groups, dict):
            total = groups.get("rounds_ok")
            if isinstance(total, int):
                prev = self._commit_seen.get(peer)
                self._commit_seen[peer] = total
                if prev is None:
                    # First sight (fresh replica joining a long-running
                    # swarm, a new volunteer, or a shard handoff): seed the
                    # baseline only — injecting the lifetime total would
                    # report a bogus commit burst for the next window.
                    delta = 0
                elif total >= prev:
                    delta = total - prev
                else:
                    # Counter went backwards = the volunteer restarted;
                    # count from zero, don't subtract history.
                    delta = total
                if delta > 0:
                    self._commit_window.setdefault(s, []).append((now, delta))
            xz = groups.get("cross_zone_bytes_sent")
            if isinstance(xz, int):
                prev = self._xz_seen.get(peer)
                self._xz_seen[peer] = xz
                # Unlike the commit counter, a DECREASE here re-baselines
                # at delta 0: the byte sum is cumulative-but-not-strictly-
                # monotone (peer-stats LRU eviction / zone re-attribution),
                # and "count from zero" would re-inject a lifetime's bytes
                # as one phantom burst.
                xdelta = xz - prev if prev is not None and xz >= prev else 0
                if xdelta > 0:
                    self._xz_window.setdefault(s, []).append((now, xdelta))
        if self.metrics_path:
            with open(self.metrics_path, "a") as fh:
                fh.write(_json.dumps(self.latest_metrics[peer]) + "\n")

    # -- RPC handlers ------------------------------------------------------

    async def _rpc_report(self, args: dict, payload: bytes):
        """Legacy per-message metrics push (kept verbatim for mixed-version
        volunteers and tests); batched peers use cp.exchange instead."""
        self.counters["reports"] += 1
        self._ingest_report(args)
        return {"ok": True}, b""

    async def _rpc_exchange(self, args: dict, payload: bytes):
        """The coalesced per-interval control RPC: one frame carries the
        peer's membership announce AND its metrics report; the reply
        carries the peers snapshot AND the replica set — everything the
        volunteer's heartbeat interval needs, in one round trip."""
        self.counters["exchanges"] += 1
        if time.monotonic() - self._views_t > self.interval:
            # The serving views refresh once per interval regardless of
            # who pays (normally the tick; lazily here if the tick lagged
            # or the interval was stretched) — amortized over every client
            # served from the cache in between.
            await self._refresh_views()
        pid = str(args["peer"])
        ttl = float(args.get("ttl", 15.0))
        rec = args.get("record")
        if args.get("join"):
            self.counters["joins"] += 1
        self._mem_records[pid] = (rec, time.monotonic() + ttl, ttl)
        self._mem_dirty.add(pid)
        # The serving view must reflect this beat immediately: the NEXT
        # exchange this interval (any peer) already sees pid live.
        self._peers_view[pid] = rec
        report = args.get("report")
        if isinstance(report, dict):
            self._ingest_report(report)
        replicas = self._live_replica_view()
        # Our own record rides every reply (carries retiring=True during
        # the drain, which is how clients re-resolve "immediately").
        replicas[self.rid] = self._self_record()
        merged = self._merged_peers()
        self._version_peers(merged)
        reply: Dict[str, object] = {
            "ok": True,
            "rid": self.rid,
            "replicas": replicas,
            "peers_ver": self._pv,
        }
        cv = args.get("peers_ver")
        if (
            isinstance(cv, int)
            and not isinstance(cv, bool)
            and args.get("peers_rid") == self.rid
            and self._plog_floor <= cv <= self._pv
        ):
            # Delta reply: the records whose significance changed since
            # the client's version (None = departed/tombstoned), plus the
            # compact liveness sidecar — every live peer's beat timestamp
            # — so the client's failure detector keeps observing beats it
            # no longer receives full records for.
            changed = {p for v, p in self._plog if v > cv}
            reply["peers_delta"] = {p: merged.get(p) for p in changed}
            reply["beats"] = {
                p: r["t"] for p, r in merged.items()
                if isinstance(r, dict) and isinstance(r.get("t"), (int, float))
            }
            self.counters["peers_delta_replies"] += 1
        else:
            # Full replace: first contact, a failover from another
            # replica's version stream, or a client staler than the
            # change log covers.
            reply["peers"] = merged
            self.counters["peers_full_replies"] += 1
        return reply, b""

    def _merged_peers(self) -> Dict[str, object]:
        """Peers snapshot served to batched clients: the cached DHT view
        overlaid with records heartbeated through THIS replica (which are
        at most one flush behind in the DHT)."""
        now = time.monotonic()
        out = dict(self._peers_view)
        for pid, (rec, exp, _) in self._mem_records.items():
            if exp > now:
                out[pid] = rec
        return out

    # -- peers-snapshot deltas ---------------------------------------------

    # Change-log length bound; at ~one changed record per churn event this
    # covers minutes of heavy churn before a client falls back to a full.
    MAX_PLOG = 4096

    @staticmethod
    def _peers_sig(rec: object) -> str:
        """Significance signature of one membership record: what a delta
        considers "changed". The per-beat timestamp is EXCLUDED (it moves
        every beat by design — liveness rides the compact ``beats``
        sidecar instead) and floats are quantized to 2 significant digits
        (measured bandwidth EWMAs jitter every beat; a 1% wiggle is not a
        membership change)."""
        if not isinstance(rec, dict):
            return "~"
        parts = []
        for k in sorted(rec):
            if k == "t":
                continue
            v = rec[k]
            if isinstance(v, float):
                v = float(f"{v:.2g}")
            parts.append(f"{k}={v!r}")
        return hashlib.blake2b(
            "|".join(parts).encode(), digest_size=8
        ).hexdigest()

    def _version_peers(self, merged: Dict[str, object]) -> None:
        """Advance the snapshot version from a significance diff of the
        serving view. Record MUTATIONS are amortized once per interval
        like the view refresh itself (they already lag a delta by up to
        one interval through the view cache; same staleness class as
        every other serving-view read) — but a changed KEY SET (join,
        departure, expiry) bypasses the throttle: the live record store
        grows mid-interval as clients exchange, and a delta reply
        claiming the current version while the significance table
        predates a join would silently starve those clients of the new
        peer until the next interval tick. The diff runs over the MERGED
        view, so expiries and tombstones version exactly like fresh
        records do."""
        now = time.monotonic()
        if (
            self._psig
            and now - self._psig_t < self.interval
            and self._psig.keys() == merged.keys()
        ):
            return
        self._psig_t = now
        changed = set()
        for pid, rec in merged.items():
            s = self._peers_sig(rec)
            if self._psig.get(pid) != s:
                self._psig[pid] = s
                changed.add(pid)
        for pid in [p for p in self._psig if p not in merged]:
            del self._psig[pid]
            changed.add(pid)
        if not changed:
            return
        self._pv += 1
        self._plog.extend((self._pv, pid) for pid in sorted(changed))
        if len(self._plog) > self.MAX_PLOG:
            # Trim whole version batches: a partially-dropped version
            # would serve an INCOMPLETE delta as if it were complete.
            vcut = self._plog[len(self._plog) - self.MAX_PLOG][0]
            self._plog = [(v, p) for v, p in self._plog if v > vcut]
        self._plog_floor = (self._plog[0][0] - 1) if self._plog else self._pv

    async def _rpc_rendezvous(self, args: dict, payload: bytes):
        """Matchmaking rendezvous read through the replicated control
        plane: members polling a forming round's key hit the micro-cache
        instead of each paying an iterative DHT lookup per poll."""
        self.counters["rendezvous_served"] += 1
        key = str(args["key"])
        now = time.monotonic()
        hit = self._rendezvous_cache.get(key)
        if hit is not None and now - hit[0] <= self.RENDEZVOUS_CACHE_S:
            return {"ok": True, "rec": hit[1]}, b""
        rec = await self.dht.get(key)
        self.counters["rendezvous_lookups"] += 1
        if len(self._rendezvous_cache) >= self.MAX_RENDEZVOUS_CACHE:
            self._rendezvous_cache.clear()
        self._rendezvous_cache[key] = (now, rec)
        return {"ok": True, "rec": rec}, b""

    # -- status ------------------------------------------------------------

    def _merged_metrics(self) -> Tuple[Dict[str, dict], list, list]:
        """Swarm-wide fresh metrics + reporting windows, merged from the
        live local cache and every shard's DHT rollup. Per shard the
        highest GENERATION wins (fencing's reader half); per peer the
        freshest recv_t wins."""
        now = time.time()
        merged: Dict[str, dict] = {}
        best_gen: Dict[int, int] = {s: g for s, g in self._shard_gens.items()}
        commit_w: Dict[int, list] = {
            s: list(w) for s, w in self._commit_window.items()
            if s in self._shard_gens
        }
        xz_w: Dict[int, list] = {
            s: list(w) for s, w in self._xz_window.items()
            if s in self._shard_gens
        }
        for sk, rec in self._rollup_view.items():
            if not sk.startswith("s"):
                continue
            try:
                s = int(sk[1:])
            except ValueError:
                continue
            gen = int(rec.get("gen") or 0)
            if s in best_gen and gen <= best_gen[s]:
                continue  # our live ownership (or a newer rollup) wins
            best_gen[s] = gen
            commit_w[s] = [(float(t), int(d)) for t, d in rec.get("commit_window") or []]
            xz_w[s] = [(float(t), int(d)) for t, d in rec.get("xz_window") or []]
            for pid, m in (rec.get("peers") or {}).items():
                if not isinstance(m, dict):
                    continue
                cur = merged.get(pid)
                if cur is None or m.get("recv_t", 0) > cur.get("recv_t", 0):
                    merged[pid] = m
        # Local live cache LAST: whatever this replica ingested directly is
        # at least as fresh as what it wrote to the DHT.
        for pid, m in self.latest_metrics.items():
            cur = merged.get(pid)
            if cur is None or m.get("recv_t", 0) > cur.get("recv_t", 0):
                merged[pid] = m
        fresh = {
            pid: m for pid, m in merged.items()
            if now - m.get("recv_t", 0) < self.FRESH_S
        }
        cutoff = now - self.COMMIT_WINDOW_S
        commits = [
            (t, d) for w in commit_w.values() for t, d in w if t >= cutoff
        ]
        xz = [(t, d) for w in xz_w.values() for t, d in w if t >= cutoff]
        return fresh, commits, xz

    def _multigroup_rollup(
        self, fresh: list, commit_window: list, xz_window: list
    ) -> Optional[dict]:
        """Swarm-level view of the rotating group schedule, from the fresh
        reports that carry ``groups`` gauges. Namespaced PER GROUP — the
        flat per-peer maps elsewhere in status would silently average
        across groups — plus the rollups a dashboard needs: groups active
        this rotation, committed-round rate, and the slowest group's lag
        behind its last commit."""
        gstats = {
            m.get("peer", "?"): m["groups"]
            for m in fresh
            if isinstance(m.get("groups"), dict) and m["groups"].get("enabled")
        }
        if not gstats:
            return None
        now = time.time()
        rot = max(
            (gs.get("rot") for gs in gstats.values() if gs.get("rot") is not None),
            default=None,
        )
        active = {
            gs["group_id"] for gs in gstats.values() if gs.get("group_id")
        }
        # Per-group breakdown, merged across reporters. Counters are
        # volunteer-rounds (a committed group round counts once per member
        # that saw it commit) — a participation measure, not a round count.
        per_group: Dict[str, dict] = {}
        for peer, gs in gstats.items():
            for gid, rec in (gs.get("recent") or {}).items():
                g = per_group.setdefault(
                    gid,
                    {"volunteers": 0, "rounds_ok": 0, "rounds_skipped": 0,
                     "rounds_degraded": 0, "last_commit_t": None},
                )
                g["volunteers"] += 1
                for k in ("rounds_ok", "rounds_skipped", "rounds_degraded"):
                    g[k] += int(rec.get(k) or 0)
                t = rec.get("last_commit_t")
                if t is not None and (
                    g["last_commit_t"] is None or t > g["last_commit_t"]
                ):
                    g["last_commit_t"] = t
        # Slowest ACTIVE group's lag behind its last commit (volunteer
        # clocks, so skew-accurate only to ClockSync quality): the
        # "is any group silently stuck" gauge.
        lags = [
            now - per_group[gid]["last_commit_t"]
            for gid in active
            if gid in per_group and per_group[gid]["last_commit_t"] is not None
        ]
        # Per-zone breakdown (hierarchical schedule): volunteers, commit
        # totals, and each zone's cross-zone byte footprint — so an
        # operator sees WHICH zone is burning WAN bytes or lagging, not
        # one flat number averaging a DC slice against a home DSL line.
        per_zone: Dict[str, dict] = {}
        per_level: Dict[str, dict] = {}
        for gs in gstats.values():
            z = per_zone.setdefault(
                str(gs.get("zone") or ""),
                {"volunteers": 0, "rounds_ok": 0,
                 "cross_zone_bytes_sent": 0, "cross_zone_bytes_received": 0},
            )
            z["volunteers"] += 1
            z["rounds_ok"] += int(gs.get("rounds_ok") or 0)
            for k in ("cross_zone_bytes_sent", "cross_zone_bytes_received"):
                z[k] += int(gs.get(k) or 0)
            for lv, rec in (gs.get("levels") or {}).items():
                agg = per_level.setdefault(
                    str(lv),
                    {"rounds_ok": 0, "rounds_skipped": 0, "rounds_degraded": 0},
                )
                for k in agg:
                    agg[k] += int(rec.get(k) or 0)
        cutoff = now - self.COMMIT_WINDOW_S
        commits = sum(d for t, d in commit_window if t >= cutoff)
        xz_bytes = sum(d for t, d in xz_window if t >= cutoff)
        return {
            "volunteers": len(gstats),
            "rot": rot,
            "groups_active": len(active),
            "rounds_ok_total": sum(
                int(gs.get("rounds_ok") or 0) for gs in gstats.values()
            ),
            "commits_per_min": round(
                commits * 60.0 / self.COMMIT_WINDOW_S, 2
            ),
            "slowest_group_lag_s": round(max(lags), 3) if lags else None,
            "per_group": per_group,
            "per_zone": per_zone,
            "per_level": per_level or None,
            # The hierarchical schedule's headline metric, live: WAN bytes
            # that crossed a zone boundary (sent-side counters, each wire
            # byte counted once) per committed volunteer-round, over the
            # sliding window (None until a commit lands in it).
            "cross_zone_bytes_per_commit": (
                round(xz_bytes / commits, 1) if commits else None
            ),
        }

    async def _rpc_status(self, args: dict, payload: bytes):
        """Swarm-level view, servable from ANY replica: alive peers from
        the shared membership key, metrics merged across every shard's
        replicated rollup plus this replica's live ingestion cache."""
        self.counters["status_served"] += 1
        # Status is operator-cadence, not the hot path: pay the DHT walk so
        # the view is live (the batched exchange path is where the cached
        # views earn their keep).
        await self._refresh_views()
        peers = self._merged_peers()
        alive = {pid: rec for pid, rec in peers.items() if rec is not None}
        fresh_map, commit_w, xz_w = self._merged_metrics()
        fresh = list(fresh_map.values())
        agg_sps = sum(float(m.get("samples_per_sec", 0.0)) for m in fresh)
        multigroup = self._multigroup_rollup(fresh, commit_w, xz_w)
        now = time.time()
        health_roll = health_mod.rollup_status(fresh)
        # A status serve is also an evaluation opportunity (spacing-
        # guarded inside, so a status storm cannot inflate burn windows):
        # an operator probing a freshly-failed-over replica sees live
        # objectives, not a blank watchdog.
        self.watchdog.evaluate(fresh, multigroup=multigroup, health=health_roll)
        return {
            # Rotating group-schedule rollup (None until some volunteer
            # reports multi-group gauges).
            "multigroup": multigroup,
            # Telemetry-plane rollup (versioned; None until some volunteer
            # reports a telemetry summary): per-span count/sum merged
            # swarm-wide plus every reporter's verbatim summary — the
            # schema tests/test_telemetry.py pins per version. Every
            # rollup section carries an age_s staleness stamp (satellite:
            # a frozen replica is distinguishable from a quiet swarm).
            "telemetry": self._stamp_age(
                telemetry_mod.rollup_status(fresh), fresh, now
            ),
            # Training-health rollup (versioned; None until some volunteer
            # reports a health summary): cross-peer sketch dispersion —
            # the LIVE mixing error, global / per zone / across zone
            # means — plus mass-accounting stats, merged per-peer quality
            # scores, the flagged-peer union, and per-wire codec
            # distortion. Pinned by health.STATUS_HEALTH_SCHEMA.
            "health": self._stamp_age(health_roll, fresh, now),
            # Closed-loop controller rollup (versioned; None until some
            # volunteer reports a controller summary — a --no-adapt
            # fleet serves no section at all): worst regime per level,
            # topology/wire census, the tightest per-zone-pair cadence,
            # max learned deadline per level, transition totals + the
            # freshest transition with its reason. Pinned by
            # controller.STATUS_CONTROLLER_SCHEMA.
            "controller": self._stamp_age(
                controller_mod.rollup_status(fresh), fresh, now
            ),
            # Watchdog plane (versioned, ALWAYS dicts — the plane exists
            # the moment a replica does): declarative objectives with
            # fast/slow burn rates, and the swarm-wide firing-alert rollup
            # (volunteer-reported firing sets + replica-local swarm-level
            # alerts). Pinned by watchdog.STATUS_WATCHDOG_SCHEMA.
            "slo": self.watchdog.slo_status(now),
            "alerts": self.watchdog.alerts_status(fresh, now),
            "alive": alive,
            "n_alive": len(alive),
            "swarm_samples_per_sec": agg_sps,
            "uptime_s": time.time() - self._t0,
            # Which replica served this, and the active set it believes in
            # — the operator's first failover question.
            "control_plane": self.stats(),
            # Transport-level counters: THIS replica's WAN vantage.
            "transport": self.transport.stats(),
            # Per-volunteer leader-aggregation pipeline gauges from the
            # freshest reports — empty until some volunteer has led a
            # streaming round.
            "aggregation": {
                m.get("peer", "?"): m["aggregation"]
                for m in fresh
                if m.get("aggregation")
            },
            # Per-volunteer leader-failover gauges — empty until a
            # volunteer has lived through a leader death.
            "failover": {
                m.get("peer", "?"): m["failover"]
                for m in fresh
                if m.get("failover")
            },
        }, b""

    def stats(self) -> dict:
        active = self.active_set()
        return {
            "rid": self.rid,
            "retiring": self.retiring,
            "active_replicas": [rid for rid, _ in active],
            "n_replicas": len(active),
            "shards_owned": sorted(self._shard_gens),
            "shard_gens": {str(s): g for s, g in self._shard_gens.items()},
            **self.counters,
        }


class ControlPlaneClient:
    """Volunteer-side failover client for the replicated control plane.

    Discovers the live replica set from ``cp/replicas`` soft state (and
    from every exchange reply), routes each peer's control traffic to the
    replica OWNING its key-range shard, and on conn failure fails over to
    the next replica in ring order — the PR-4 deposal move applied to the
    control plane. Failed replicas go on bounded AIMD backoff (delay
    doubles per consecutive failure up to a cap, shrinks additively on
    recovery), and every attempt is FAST-FAIL (short connect budget), so a
    dead coordinator costs the heartbeat loop ~a second, never the generic
    call timeout."""

    # Fast-fail budgets: a control RPC to a corpse must cost the dial
    # budget, not the generic call timeout (satellite: heartbeat cadence
    # must hold through a coordinator outage).
    CALL_TIMEOUT = 2.5
    CONNECT_TIMEOUT = 1.0
    # Bounded AIMD backoff per replica.
    BACKOFF_START = 0.5
    BACKOFF_CAP = 8.0
    BACKOFF_DECREASE = 0.5
    # At most this many replicas tried per operation: bounds the worst
    # case (every replica dead) to ~2 dial budgets before the caller falls
    # back to the direct DHT path.
    MAX_TRIES = 2
    REFRESH_S = 5.0
    # Discovery backoff ceiling for swarms with NO replicas at all: a
    # refresh that finds nothing doubles the next refresh interval up to
    # this, so volunteers in a control-plane-less swarm don't pay an
    # iterative cp/replicas lookup on every heartbeat forever.
    EMPTY_REFRESH_CAP_S = 60.0

    # A replica record adopted this long ago without reconfirmation (an
    # exchange reply or a DHT refresh) no longer counts as live — matches
    # the replica announce TTL.
    RECORD_TTL = ControlPlaneReplica.REPLICA_TTL

    def __init__(self, transport: Transport, dht: DHTNode, peer_id: str):
        self.transport = transport
        self.dht = dht
        self.peer_id = peer_id
        # rid -> (record, adopted_mono)
        self._replicas: Dict[str, Tuple[dict, float]] = {}
        # Replicas a serving replica's reply did NOT list: likely dead
        # (replicas liveness-probe each other), but a reply can also
        # simply predate a young replica's announce — so absent rids are
        # DEMOTED to last-resort fallbacks rather than dropped (dropping
        # on a stale reply would erase a live replica and strand the
        # client when its shard owner dies). Re-listed or re-read from
        # the DHT -> re-confirmed.
        self._unconfirmed: set = set()
        self._refreshed = 0.0
        self._refresh_interval = self.REFRESH_S
        # rid -> (blocked_until_mono, current_delay)
        self._backoff: Dict[str, Tuple[float, float]] = {}
        self.counters: Dict[str, int] = {
            "calls_ok": 0, "calls_failed": 0, "failovers": 0,
            "refreshes": 0, "fallbacks": 0,
            "peers_full_replies": 0, "peers_delta_replies": 0,
        }
        # Peers-snapshot delta state: the cached full map delta replies
        # patch, and the (rid, version) echo that entitles this client to
        # deltas from that replica's change log. A failover to a replica
        # with a different rid mismatches the echo server-side and forces
        # one full-replace — the stale-version fallback needs no client
        # logic at all.
        self._peers_cache: Dict[str, object] = {}
        self._peers_ver: Optional[int] = None
        self._peers_rid: Optional[str] = None
        # RPC attempts the most recent _call made (1 on the happy path,
        # +1 per failover try): the per-beat message accounting reads this
        # instead of a transport-global counter delta, which would bill
        # concurrent round traffic to the beat.
        self.last_call_attempts = 0

    # -- replica-set discovery --------------------------------------------

    def update_replicas(self, records: Dict[str, dict]) -> None:
        """Adopt a replica-set view (from an exchange reply or a DHT
        read). Retiring records REPLACE live ones — that is the whole
        point of the retiring tombstone."""
        now = time.monotonic()
        for rid, rec in (records or {}).items():
            if isinstance(rec, dict):
                self._replicas[rid] = (rec, now)
                self._unconfirmed.discard(rid)
        self._refreshed = now
        if records:
            self._refresh_interval = self.REFRESH_S

    async def refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._refreshed <= self._refresh_interval:
            return
        self.counters["refreshes"] += 1
        try:
            recs = await self.dht.get(REPLICAS_KEY)
        except Exception as e:  # noqa: BLE001 — discovery is best-effort
            log.debug("replica-set refresh failed: %s", errstr(e))
            return
        # Full replace: records absent from the DHT have expired (the DHT
        # is authoritative up to the announce TTL).
        self._replicas = {
            rid: (rec, now)
            for rid, rec in recs.items()
            if isinstance(rec, dict)
        }
        self._unconfirmed.clear()
        self._refreshed = now
        if self._replicas:
            self._refresh_interval = self.REFRESH_S
        else:
            # No control plane anywhere: decay the discovery cadence so a
            # swarm not using the feature doesn't pay a DHT walk per beat.
            self._refresh_interval = min(
                self._refresh_interval * 2.0, self.EMPTY_REFRESH_CAP_S
            )

    def active(self) -> List[Tuple[str, Addr]]:
        cutoff = time.monotonic() - self.RECORD_TTL
        return active_replicas(
            {rid: rec for rid, (rec, at) in self._replicas.items() if at >= cutoff}
        )

    @property
    def has_replicas(self) -> bool:
        return bool(self.active())

    # -- routing + backoff -------------------------------------------------

    def _routes(self, shard: int) -> List[Tuple[str, Addr]]:
        """Replica attempt order for a shard: its owner first, then the
        ring in order — the same order every client computes, so failover
        traffic converges on the replica that will own the shard once the
        set re-forms, and backoff'd corpses are skipped outright."""
        active = self.active()
        if not active:
            return []
        start = owner_index(shard, len(active))
        ring = active[start:] + active[:start]
        now = time.monotonic()
        routes = [
            (rid, addr) for rid, addr in ring
            if self._backoff.get(rid, (0.0, 0.0))[0] <= now
        ]
        # CONFIRMED replicas first (ring order preserved within each
        # class): a replica absent from the last serving reply is probably
        # a corpse — dial it only after the confirmed ones fail.
        routes.sort(key=lambda r: r[0] in self._unconfirmed)
        if routes:
            return routes
        # Every replica in backoff: try the one whose backoff expires
        # SOONEST (the most-nearly-recovered) rather than going dark —
        # or rather than re-dialing the ring head, which is often exactly
        # the long-backed-off corpse.
        return [min(ring, key=lambda r: self._backoff.get(r[0], (0.0, 0.0))[0])]

    def _note_ok(self, rid: str) -> None:
        until, delay = self._backoff.get(rid, (0.0, 0.0))
        self._backoff[rid] = (0.0, max(delay - self.BACKOFF_DECREASE, 0.0))
        self.counters["calls_ok"] += 1

    def _note_fail(self, rid: str) -> None:
        _, delay = self._backoff.get(rid, (0.0, 0.0))
        delay = min(max(delay * 2.0, self.BACKOFF_START), self.BACKOFF_CAP)
        self._backoff[rid] = (time.monotonic() + delay, delay)
        self.counters["calls_failed"] += 1

    async def _call(
        self, shard: int, method: str, args: dict
    ) -> Optional[dict]:
        """Fast-fail, failover call: first reachable replica in route
        order wins. None when no replica answered (caller falls back to
        the direct DHT path)."""
        routes = self._routes(shard)
        last_err: Optional[Exception] = None
        self.last_call_attempts = min(len(routes), self.MAX_TRIES)
        for i, (rid, addr) in enumerate(routes[: self.MAX_TRIES]):
            try:
                ret, _ = await self.transport.call(
                    addr, method, args,
                    timeout=self.CALL_TIMEOUT,
                    connect_timeout=self.CONNECT_TIMEOUT,
                )
                self._note_ok(rid)
                self.last_call_attempts = i + 1
                if i > 0:
                    self.counters["failovers"] += 1
                return ret
            except Exception as e:  # noqa: BLE001 — replica down: fail over
                self._note_fail(rid)
                last_err = e
        if routes:
            log.debug(
                "control-plane call %s failed on %d replica(s): %s",
                method, min(len(routes), self.MAX_TRIES), errstr(last_err),
            )
            self.counters["fallbacks"] += 1
        return None

    # -- operations --------------------------------------------------------

    async def exchange(
        self,
        record: Optional[dict],
        ttl: float,
        report: Optional[dict] = None,
        join: bool = False,
    ) -> Optional[dict]:
        """The batched per-interval control RPC (see ControlPlaneReplica).
        Returns the reply (peers snapshot + replica set, already adopted
        into this client's view) or None when no replica answered."""
        args: Dict[str, object] = {
            "peer": self.peer_id,
            "record": record,
            "ttl": float(ttl),
            "report": report,
            "join": bool(join),
        }
        if self._peers_ver is not None and self._peers_rid is not None:
            # Entitles us to a changes-since-version reply instead of the
            # full peers map (see merge_peers_reply).
            args["peers_ver"] = self._peers_ver
            args["peers_rid"] = self._peers_rid
        ret = await self._call(shard_of(self.peer_id), "cp.exchange", args)
        if ret is not None:
            recs = {
                rid: rec
                for rid, rec in (ret.get("replicas") or {}).items()
                if isinstance(rec, dict)
            }
            if recs:
                # The reply is the serving replica's liveness-probed view:
                # listed rids are CONFIRMED live; known rids it does NOT
                # list are DEMOTED to last-resort fallbacks (they are
                # probably corpses — but the reply may also just predate a
                # young replica's announce, so they are not dropped; the
                # RECORD_TTL ages real corpses out).
                self.update_replicas(recs)
                for rid in self._replicas:
                    if rid not in recs:
                        self._unconfirmed.add(rid)
        return ret

    def merge_peers_reply(self, ret: Optional[dict]) -> Dict[str, object]:
        """Resolve an exchange reply into the FULL peers snapshot the
        membership layer adopts, whichever shape the reply took:

        - a full reply (``peers``) replaces the local cache outright —
          also the legacy shape, so mixed-version replicas keep working;
        - a delta reply (``peers_delta``) patches the cache (None values
          evict) and folds the ``beats`` sidecar's timestamps into the
          cached records, so the caller's failure detector keeps seeing
          every peer's beat even though only changed records shipped.

        Tombstones are delivered to the caller exactly once (they ride
        the returned map this call, then leave the cache), matching the
        one-shot departure semantics of the full map. The version echo
        for the NEXT exchange is adopted here too."""
        if not isinstance(ret, dict):
            return {}
        delta = ret.get("peers_delta")
        if not isinstance(delta, dict):
            snap = dict(ret.get("peers") or {})
            self.counters["peers_full_replies"] += 1
            self._peers_cache = {
                p: r for p, r in snap.items() if r is not None
            }
        else:
            self.counters["peers_delta_replies"] += 1
            for pid, rec in delta.items():
                if rec is None:
                    self._peers_cache.pop(pid, None)
                else:
                    self._peers_cache[pid] = rec
            beats = ret.get("beats")
            if isinstance(beats, dict):
                for pid, t in beats.items():
                    rec = self._peers_cache.get(pid)
                    if (
                        isinstance(rec, dict)
                        and isinstance(t, (int, float))
                        and rec.get("t") != t
                    ):
                        # Copy-on-write: the cached record may still be
                        # referenced by a snapshot handed out earlier.
                        rec = dict(rec)
                        rec["t"] = t
                        self._peers_cache[pid] = rec
            snap = dict(self._peers_cache)
            for pid, rec in delta.items():
                if rec is None:
                    snap[pid] = None
        ver = ret.get("peers_ver")
        if isinstance(ver, int) and not isinstance(ver, bool):
            self._peers_ver = ver
            self._peers_rid = str(ret.get("rid") or "") or None
        else:
            # Legacy replica: no version stream to subscribe to.
            self._peers_ver = None
            self._peers_rid = None
        return snap

    async def status(self, fresh: bool = False) -> Optional[dict]:
        await self.refresh()
        return await self._call(
            shard_of(self.peer_id), "coord.status", {"fresh": bool(fresh)}
        )

    async def rendezvous_get(self, key: str) -> Optional[Dict[str, object]]:
        """Matchmaking rendezvous read via a replica's micro-cache; None
        on failure (the matchmaker then walks the DHT itself). Routed by
        the KEY's shard so all members polling one forming round hit the
        same replica's cache."""
        if not self.has_replicas:
            return None
        ret = await self._call(shard_of(key), "cp.rendezvous", {"key": key})
        if ret is None or not ret.get("ok"):
            return None
        return dict(ret.get("rec") or {})

    def stats(self) -> dict:
        now = time.monotonic()
        return {
            "replicas_known": len(self._replicas),
            "active": [rid for rid, _ in self.active()],
            "unconfirmed": sorted(self._unconfirmed),
            "backed_off": sorted(
                rid for rid, (until, _) in self._backoff.items() if until > now
            ),
            **self.counters,
        }
