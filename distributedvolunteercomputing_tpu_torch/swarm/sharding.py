"""Zone-sharded training state: the swarm outgrows one volunteer's mesh.

Every volunteer so far held a full model replica, so the largest trainable
model was capped by one volunteer's memory. This module shards the
parameter/optimizer tree into K contiguous element ranges of the flattened
buffer and assigns each range to a holder WITHIN a zone (the PR-8 zone is
the shard domain): fat intra-zone links carry the gather/scatter legs, and
cross-zone rounds average only your own shard's gradients — cutting each
volunteer's WAN bytes per round by ~K (the HSDP trade: shard inside the
datacenter, replicate across them).

Three deliberate design rules keep churn survivable:

- **Shard RANGES depend only on (n_elems, K)** — never on membership. A
  join/leave re-assigns holders but never re-cuts the buffer, so the
  cross-zone per-shard averaging schema (and therefore the wire schema
  hash every group member validates) is stable through arbitrary churn.
- **Holder assignment is an HRW (rendezvous) hash** over the zone's
  members per shard. Minimal disruption by construction: a departed
  member's shards move, everyone else's stay put — a modulo assignment
  would reshuffle nearly every shard on every membership change and turn
  each churn event into a zone-wide state migration.
- **Every shard move is membership-fenced** exactly like leader failover
  (PR 4), except the fence token is a CONTENT digest of the map (domain,
  K, sorted member set) rather than a counter: every ``shard.fetch``
  carries the requester's (domain, fence), and both ends reject a
  same-domain mismatch — so a deposed holder's late serve (or a stale
  puller's adoption) can never mix an old map's bytes into a newer one.
  Two peers agree on the fence iff they adopted the SAME membership,
  even when their local ``gen`` counters disagree (a late joiner or
  restarted volunteer starts at gen 0 while incumbents are at gen N; a
  slow peer collapses two quick churn events into one reshard) — the
  generation is a purely local version number kept for logs and flight
  events, never compared across peers. The cross-zone rung (an
  independent domain) is instead guarded by the ADOPTER-side fence: the
  puller's own map must be unchanged through the pull, or the bytes are
  discarded.

Recovery ladder on holder loss (PR 13's hedged-fetch shape):

1. the shard's PREVIOUS holder (alive on a graceful leave/re-zone — the
   freshest copy, one intra-zone hop);
2. the zone REPLICA (the HRW runner-up keeps a copy refreshed at commits;
   a SIGKILLed holder's shard is served from here);
3. any SAME-zone peer announcing the shard — including a demoted
   ex-holder still LINGERING the bytes: a holder demoted below
   runner-up at a reshard keeps its copy for a grace window instead of
   dropping it immediately, so a joiner-heavy churn event cannot strand
   the zone's only copy before the new holder has pulled it;
4. any CROSS-zone holder of the same shard (discovered via the DHT shard
   announce — the other zones replicate the full tree collectively).

Candidates are raced hedged: the first is dialed immediately, the next
joins after a soft deadline (``ResiliencePolicy.hedge_params`` when
attached), first success wins. An in-flight round that loses its holder
commits through the loss via the degraded-slice pattern: the leader falls
back to the zone's replicated copy and the gradient-mass accounting books
the slot as recovered/excluded — balanced, never silently dropped
(``health.mass_by_shard`` splits the buckets per shard domain).

Flight events: ``shard_lost`` (warn) when a holder departs with its shard,
``shard_recovered`` (info) with the recovery source + latency,
``shard_fence_rejected`` (warn) on a stale serve/pull attempt, and
``shard_recovery_failed`` (page) when the whole ladder came up empty. The
watchdog's ``shard_recovery_latency`` SLO burns on the recent-window
latency riding the report beat (``summary()``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import os
import signal
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.transport import Addr, RPCError, Transport
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)


def shard_ranges(n_elems: int, k: int) -> List[Tuple[int, int]]:
    """K contiguous [lo, hi) element ranges covering an ``n_elems`` flat
    buffer, sizes differing by at most one element. A pure function of
    (n_elems, k) — the schema-stability rule in the module doc rides on
    membership never entering this cut."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if n_elems < 0:
        raise ValueError(f"n_elems must be >= 0, got {n_elems}")
    base, rem = divmod(n_elems, k)
    out: List[Tuple[int, int]] = []
    lo = 0
    for s in range(k):
        hi = lo + base + (1 if s < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def shard_slice(buf: np.ndarray, ranges: List[Tuple[int, int]], s: int) -> np.ndarray:
    """View of shard ``s``'s element range of a flat buffer."""
    lo, hi = ranges[s]
    return buf[lo:hi]


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """One fenced version of the zone's shard→holder assignment.

    Immutable: a re-shard builds a NEW map at generation+1 (the fenced
    handoff), so concurrent readers can never observe a half-updated
    assignment. ``domain`` scopes the HRW hash (zone + namespace), so two
    zones sharding the same model never compute correlated rankings."""

    members: Tuple[str, ...]
    k: int
    gen: int
    domain: str = ""

    def __post_init__(self):
        object.__setattr__(self, "members", tuple(sorted(set(self.members))))
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.gen < 0:
            raise ValueError(f"gen must be >= 0, got {self.gen}")

    @property
    def fence(self) -> str:
        """The fencing token: a content digest of (domain, K, members).
        Two peers compute the same fence iff they adopted the same
        membership — unlike ``gen``, which is a purely local counter
        that skews across peers who observed a different number of
        churn events (a late joiner starts at 0, an incumbent is at N);
        comparing gens across peers would wedge in-zone recovery
        forever on such skew."""
        h = hashlib.blake2b(
            f"{self.domain}|k{self.k}|{'|'.join(self.members)}".encode(),
            digest_size=8,
        )
        return h.hexdigest()

    @staticmethod
    def _rank(domain: str, shard: int, pid: str) -> int:
        h = hashlib.blake2b(
            f"{domain}|s{shard}|{pid}".encode(), digest_size=8
        ).digest()
        return int.from_bytes(h, "big")

    def ranking(self, shard: int) -> List[str]:
        """Members by HRW weight for ``shard`` (holder first, replica
        second, then the rest of the failover order — every member
        computes the same list with no coordination)."""
        return sorted(
            self.members,
            key=lambda pid: self._rank(self.domain, shard, pid),
            reverse=True,
        )

    def holder_of(self, shard: int) -> Optional[str]:
        r = self.ranking(shard)
        return r[0] if r else None

    def replica_of(self, shard: int) -> Optional[str]:
        r = self.ranking(shard)
        return r[1] if len(r) > 1 else None

    def shards_of(self, pid: str) -> List[int]:
        return [s for s in range(self.k) if self.holder_of(s) == pid]

    def replica_shards_of(self, pid: str) -> List[int]:
        return [s for s in range(self.k) if self.replica_of(s) == pid]

    def primary_shard_of(self, pid: str) -> Optional[int]:
        """The shard a peer GROUPS under for shard-aware matchmaking (its
        lowest owned shard; None for a member holding none — possible
        when the zone has more members than shards)."""
        owned = self.shards_of(pid)
        return owned[0] if owned else None

    def version(self) -> dict:
        return {
            "domain": self.domain,
            "gen": self.gen,
            "k": self.k,
            "members": list(self.members),
        }


class ShardStore:
    """Held shard buffers (own + replica), with a byte high-water mark.

    ``peak_bytes`` is THE memory claim of the whole subsystem: the
    acceptance test asserts a sharded volunteer's persistent high-water
    stays a ~1/K sliver of the full replica it could never hold."""

    def __init__(self):
        self._own: Dict[int, np.ndarray] = {}
        self._replica: Dict[int, np.ndarray] = {}
        self.peak_bytes = 0

    def _note(self) -> None:
        self.peak_bytes = max(self.peak_bytes, self.bytes())

    def bytes(self) -> int:
        return sum(a.nbytes for a in self._own.values()) + sum(
            a.nbytes for a in self._replica.values()
        )

    def put(self, shard: int, arr: np.ndarray, *, replica: bool = False) -> None:
        arr = np.ascontiguousarray(arr, np.float32)
        if replica:
            self._replica[shard] = arr
        else:
            self._own[shard] = arr
            # One buffer per shard per role: a promotion replaces the
            # replica copy rather than double-holding it.
            self._replica.pop(shard, None)
        self._note()

    def get(self, shard: int, *, allow_replica: bool = True) -> Optional[np.ndarray]:
        arr = self._own.get(shard)
        if arr is None and allow_replica:
            arr = self._replica.get(shard)
        return arr

    def promote(self, shard: int) -> bool:
        """Replica copy → owned (the zero-RPC rung of the recovery ladder:
        the HRW runner-up already holds the bytes)."""
        arr = self._replica.pop(shard, None)
        if arr is None:
            return False
        self._own[shard] = arr
        self._note()
        return True

    def drop(self, shard: int, *, replica: bool = False) -> None:
        (self._replica if replica else self._own).pop(shard, None)

    def held(self) -> List[int]:
        return sorted(self._own)

    def replicas(self) -> List[int]:
        return sorted(self._replica)


class ShardManager:
    """One volunteer's half of the zone's shard protocol: holds its
    shards, serves fenced ``shard.fetch``, re-shards on churn, and runs
    the hedged recovery ladder for shards it newly owns.

    The manager is deliberately NOT on the averaging hot path: the
    cross-zone per-shard rounds run through the ordinary averager (the
    shard slice is just that averager's tree, the shard-scoped group ids
    come from the schedule's ``shards`` map), and the manager only moves
    state when membership does."""

    FETCH_TIMEOUT = 30.0
    CONNECT_TIMEOUT = 2.0
    # Round budget the hedge soft-deadline fraction applies to (the
    # recovery ladder's analog of the averaging round budget).
    FETCH_BUDGET_S = 6.0
    ANNOUNCE_TTL = 30.0
    # Grace window a demoted ex-holder keeps (lingers) its old copy for
    # after a reshard, so the new holder — possibly a joiner with no
    # prior map — can still pull the zone's only copy instead of
    # falling back to a cold checkpoint restore.
    DEMOTED_LINGER_S = 60.0
    # Consecutive maintain() beats a changed membership snapshot must
    # persist before it triggers a fenced reshard: a peer whose beat is
    # merely delayed past the snapshot max-age must not cost the zone a
    # gen bump, shard_lost events, and a round of recovery pulls.
    RESHARD_DEBOUNCE_BEATS = 2
    # Recent-window for the SLO metric riding the report beat: a recovery
    # slower than the bound must burn for a while, not forever.
    RECENT_WINDOW_S = 120.0
    MAX_LATENCIES = 256
    # Sanity bound for adopted shard values (state_sync's guard: trained
    # params live in O(1); beyond this is garbage, not a model).
    MAX_ABS_VALUE = 1e4

    # The instrumented re-shard phase point (the kill-at-phase matrix's
    # fourth column, next to the averager's three leader phases).
    SHARD_PHASES = ("mid_resharding",)

    def __init__(
        self,
        transport: Transport,
        dht: DHTNode,
        membership,
        peer_id: str,
        *,
        n_elems: int,
        k: int,
        namespace: str = "",
        zone: Optional[str] = None,
        telemetry=None,
        resilience=None,
        controller=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.transport = transport
        self.dht = dht
        self.membership = membership
        self.peer_id = peer_id
        self.n_elems = int(n_elems)
        self.k = int(k)
        self.namespace = namespace
        self._zone = zone
        self.telemetry = telemetry
        self.resilience = resilience
        self.controller = controller
        self.clock = clock
        self.ranges = shard_ranges(self.n_elems, self.k)
        self.map: Optional[ShardMap] = None
        self.store = ShardStore()
        self.recoveries = 0
        self.recoveries_failed = 0
        self.resharding_count = 0
        self.fence_rejections = 0
        self._recovery_lat: Deque[Tuple[float, float]] = deque(
            maxlen=self.MAX_LATENCIES
        )
        self._last_recovery_lat: Optional[float] = None
        self._recovering: set = set()
        # shard -> holder under the PREVIOUS map: the recovery ladder's
        # first rung (a graceful leaver still serves for a grace period).
        self._prev_holders: Dict[int, str] = {}
        # shard -> (bytes, expiry): copies this peer was demoted out of
        # at a reshard, lingering until the new holder has pulled them.
        self._demoted: Dict[int, Tuple[np.ndarray, float]] = {}
        # maintain()'s reshard debounce: the candidate member list, how
        # many consecutive beats it has been observed unchanged, and how
        # many consecutive beats the map has disagreed with the snapshot
        # at all (the backstop against a flapping view never settling).
        self._pending_members: Optional[List[str]] = None
        self._pending_beats = 0
        self._stale_beats = 0
        self._phase_hooks: Dict[str, Callable[[], Any]] = {}
        self._maint_task: Optional[asyncio.Task] = None
        self._announced_t = float("-inf")
        transport.register("shard.fetch", self._rpc_fetch)

    # -- identity ----------------------------------------------------------

    @property
    def zone(self) -> str:
        if self._zone is not None:
            return self._zone
        return str(
            getattr(self.membership, "extra_info", {}).get("zone") or ""
        )

    @property
    def domain(self) -> str:
        """HRW scope: zone + namespace, so two zones (or two models) never
        compute correlated holder rankings."""
        return f"{self.zone}|{self.namespace}"

    @property
    def announce_key(self) -> str:
        """DHT key the cross-zone recovery rung discovers holders under —
        deliberately NOT zone-scoped: the other zones ARE the rung."""
        return f"shard/{self.namespace or '~'}"

    def primary_shard(self) -> Optional[int]:
        return self.map.primary_shard_of(self.peer_id) if self.map else None

    def owned(self) -> List[int]:
        return self.map.shards_of(self.peer_id) if self.map else []

    def missing(self) -> List[int]:
        held = set(self.store.held())
        return [s for s in self.owned() if s not in held]

    def advertise(self) -> None:
        """Stamp the shard assignment into the membership record so the
        next heartbeat carries it — the group schedule's ``shards`` map
        (shard-aware cross-rotation grouping) reads peers' advertised
        primary shard exactly like it reads zones."""
        extra = getattr(self.membership, "extra_info", None)
        if extra is None:
            return
        p = self.primary_shard()
        if p is None:
            extra.pop("shard", None)
        else:
            extra["shard"] = int(p)

    def _prune_demoted(self, now: Optional[float] = None) -> None:
        """Expire lingering demoted copies whose grace window closed."""
        now = self.clock() if now is None else now
        for s in [s for s, (_, exp) in self._demoted.items() if exp <= now]:
            del self._demoted[s]

    # -- chaos instrumentation ---------------------------------------------

    async def _phase(self, name: str) -> None:
        """Instrumented re-shard phase point (mirrors the averager's
        leader phases). No-op in production; chaos installs hooks, and
        DVC_CHAOS_SHARD_DIE_PHASE makes a subprocess holder SIGKILL
        itself exactly like a preempted volunteer."""
        hook = self._phase_hooks.get(name)
        if hook is not None:
            res = hook()
            if asyncio.iscoroutine(res):
                await res
        if os.environ.get("DVC_CHAOS_SHARD_DIE_PHASE") == name:
            log.warning("chaos: shard holder dying at phase %r (SIGKILL)", name)
            os.kill(os.getpid(), signal.SIGKILL)

    # -- flight/controller plumbing ----------------------------------------

    def _record(self, kind: str, **fields) -> None:
        rec = getattr(self.telemetry, "recorder", None)
        if rec is None:
            return
        try:
            rec.record(kind, **fields)
        except Exception as e:  # noqa: BLE001 — observability must not fail state moves
            log.debug("flight record %s failed: %s", kind, errstr(e))

    def health(self) -> str:
        """Shard-domain health, the controller's regime input: "degraded"
        while an owned shard has no bytes (a loss the ladder has not
        closed), "recovering" while pulls are in flight, else "ok"."""
        if self.map is None:
            return "ok"
        if self.missing():
            return "recovering" if self._recovering else "degraded"
        return "ok"

    def feed_controller(self) -> None:
        """Report shard-domain health into the closed-loop controller: a
        degraded shard zone widens deadlines / tightens cadence for the
        intra level (the gather/scatter plane the loss actually sits on)
        through the same regime model every other signal feeds."""
        c = self.controller
        if c is None:
            return
        try:
            c.observe_shard_health(level="intra", ok=self.health() == "ok")
        except Exception as e:  # noqa: BLE001
            log.debug("controller shard-health feed failed: %s", errstr(e))

    # -- serving (fenced) ---------------------------------------------------

    async def _rpc_fetch(self, args: dict, payload: bytes):
        """Fenced shard serve. The requester names the map it is
        recovering INTO via the content fence (domain + K + member set);
        any same-domain mismatch is rejected on this side (and the reply
        fence is re-validated on the puller side), so bytes can only
        ever move between two peers that adopted the SAME membership —
        the leader-failover fencing rule, applied to state. Generations
        are deliberately NOT compared across peers: they are local
        counters and skew under uneven churn observation (a late joiner
        is at gen 0 while an incumbent is at gen N). A legacy request
        naming no fence falls back to strict generation equality.

        The fence is DOMAIN-scoped: a cross-zone rung pull (different
        ``domain``) is served at whatever this zone currently holds —
        the ranges are schema-stable by construction, and the puller's
        adopter-side fence (map unchanged through the pull) is what
        guards that path.

        A shard no longer assigned here may still be served from the
        lingering demoted copy (grace window after a reshard): that is
        exactly the path a joiner-promoted holder pulls through."""
        if self.map is None:
            raise RPCError("no shard map yet")
        shard = int(args["shard"])
        gen = int(args.get("gen", -1))
        dom = args.get("domain")
        req_fence = args.get("fence")
        if dom is None or dom == self.domain:
            stale = (
                req_fence != self.map.fence
                if req_fence is not None
                else gen != self.map.gen
            )
            if stale:
                self.fence_rejections += 1
                self._record(
                    "shard_fence_rejected",
                    shard=shard,
                    got_gen=gen,
                    have_gen=self.map.gen,
                    got_fence=req_fence,
                    have_fence=self.map.fence,
                    requester=str(args.get("peer", "?")),
                )
                raise RPCError(
                    f"shard fencing mismatch: requester fence {req_fence}"
                    f"/gen {gen} vs map fence {self.map.fence}"
                    f"/gen {self.map.gen}"
                )
        arr = self.store.get(shard)
        if arr is None:
            ent = self._demoted.get(shard)
            if ent is not None and ent[1] > self.clock():
                arr = ent[0]
        if arr is None:
            raise RPCError(f"shard {shard} not held here")
        return (
            {
                "shard": shard,
                "gen": self.map.gen,
                "fence": self.map.fence,
                "total": int(arr.nbytes),
                "wire": "f32",
            },
            arr.tobytes(),
        )

    # -- discovery ----------------------------------------------------------

    async def announce(self) -> None:
        """Publish (addr, zone, gen, shards, lingering) under the shard
        key — the announce-rung candidate source, both same-zone
        (demoted lingering copies included, so a joiner-promoted holder
        can find the ex-holder's grace copy) and cross-zone. Call on the
        heartbeat cadence (the volunteer's announce loop); TTL'd like
        peer records."""
        if self.map is None:
            return
        await self.dht.store(
            self.announce_key,
            {
                "addr": list(self.transport.addr),
                "zone": self.zone,
                "gen": self.map.gen,
                "shards": self.owned(),
                "lingering": sorted(self._demoted),
            },
            subkey=self.peer_id,
            ttl=self.ANNOUNCE_TTL,
        )

    async def _announced_candidates(
        self, shard: int
    ) -> Tuple[List[Tuple[str, Addr]], List[Tuple[str, Addr]]]:
        """(same_zone, cross_zone) peers announcing ``shard`` — owned or
        lingering. The same-zone list is the ladder rung that reaches a
        demoted ex-holder a joiner has no previous map to name; the
        cross-zone list is the last rung."""
        try:
            records = await self.dht.get(self.announce_key)
        except Exception as e:  # noqa: BLE001 — discovery hiccup: rung is empty
            log.debug("shard announce lookup failed: %s", errstr(e))
            return [], []
        same: List[Tuple[str, Addr]] = []
        cross: List[Tuple[str, Addr]] = []
        for pid, rec in (records or {}).items():
            if pid == self.peer_id or not isinstance(rec, dict):
                continue
            if shard not in (rec.get("shards") or []) and shard not in (
                rec.get("lingering") or []
            ):
                continue
            addr = rec.get("addr")
            if not (isinstance(addr, (list, tuple)) and len(addr) == 2):
                continue
            dst = (str(addr[0]), int(addr[1]))
            if str(rec.get("zone") or "") == self.zone:
                same.append((pid, dst))
            else:
                cross.append((pid, dst))
        return same, cross

    # -- re-shard (fenced handoff) ------------------------------------------

    async def reshard(
        self,
        members: Optional[List[str]] = None,
        *,
        reason: str = "churn",
        recover: bool = True,
    ) -> dict:
        """Adopt a new zone membership: build the generation+1 map, emit
        ``shard_lost`` for shards whose holder departed, drop what we no
        longer hold, and (by default) run the recovery ladder for shards
        we newly own. Idempotent on an unchanged member set."""
        if members is None:
            members = await self._zone_members()
        members = sorted(set(members) | {self.peer_id})
        old = self.map
        if old is not None and list(old.members) == members:
            return {"gen": old.gen, "changed": False}
        new = ShardMap(
            members=tuple(members),
            k=self.k,
            gen=(old.gen + 1) if old is not None else 0,
            domain=self.domain,
        )
        lost: List[int] = []
        if old is not None:
            self._prev_holders = {
                s: old.holder_of(s) for s in range(self.k)
            }
            for s in range(self.k):
                h_old = old.holder_of(s)
                if h_old is not None and h_old not in new.members:
                    lost.append(s)
                    self._record(
                        "shard_lost",
                        shard=s,
                        holder=h_old,
                        gen=new.gen,
                        reason=reason,
                    )
        self.map = new
        self.resharding_count += 1
        self.advertise()
        log.info(
            "re-shard gen %d (%s): %d members, own %s%s",
            new.gen, reason, len(members), new.shards_of(self.peer_id),
            f", lost holders for {lost}" if lost else "",
        )
        if old is not None:
            # The phase point instruments the fenced HANDOFF between two
            # live maps; the gen-0 initial adoption has no predecessor
            # (and a DVC_CHAOS_SHARD_DIE_PHASE subprocess must die at a
            # real re-shard, not at its own startup).
            await self._phase("mid_resharding")
        # Demote shards neither owned nor replicated under the new map —
        # AFTER the phase point, so a mid-resharding kill leaves the old
        # copies for the survivors' ladders. Demoted bytes are NOT
        # dropped: they linger for a grace window so the new holder
        # (possibly a joiner with no copy anywhere in the zone yet) can
        # still pull them through the fenced fetch path — dropping at
        # reshard would strand the zone's only copy whenever a holder is
        # demoted below runner-up by joiners.
        now = self.clock()
        self._prune_demoted(now)
        owned = set(new.shards_of(self.peer_id))
        repl = set(new.replica_shards_of(self.peer_id))
        for s in self.store.held():
            if s not in owned:
                arr = self.store.get(s, allow_replica=False)
                if s in repl:
                    if arr is not None:
                        self.store.put(s, arr, replica=True)
                elif arr is not None:
                    self._demoted[s] = (arr, now + self.DEMOTED_LINGER_S)
                self.store.drop(s)
        for s in self.store.replicas():
            if s not in repl and s not in owned:
                arr = self.store.get(s)
                if arr is not None:
                    self._demoted.setdefault(
                        s, (arr, now + self.DEMOTED_LINGER_S)
                    )
                self.store.drop(s, replica=True)
        self.feed_controller()
        summary = {"gen": new.gen, "changed": True, "lost": lost}
        if recover:
            summary["recovered"] = await self.ensure_shards()
        return summary

    async def _zone_members(self) -> List[str]:
        """Same-zone, same-namespace live peers (the shard domain), from
        the membership snapshot at heartbeat resolution."""
        try:
            peers = await self.membership.alive_peers(
                include_self=True, max_age=self.membership.ttl / 3.0
            )
        except Exception as e:  # noqa: BLE001
            log.debug("zone member lookup failed: %s", errstr(e))
            return [self.peer_id]
        out = []
        for pid, rec in peers.items():
            if pid == self.peer_id:
                out.append(pid)
                continue
            if str(rec.get("zone") or "") != self.zone:
                continue
            ns = rec.get("avg_ns")
            if self.namespace and ns is not None and ns != self.namespace:
                continue
            out.append(pid)
        return out

    # -- autopilot maintenance ----------------------------------------------

    async def maintain(self) -> dict:
        """One autopilot beat: adopt zone churn (fenced re-shard + the
        recovery ladder), close any still-missing shards, refresh
        runner-up replicas, and re-announce before the DHT record
        expires. The volunteer runs this on a background cadence so a
        SIGKILLed holder's shards come back WITHOUT anyone restarting
        the epoch — the live form of the explicit reshard() the tests
        drive."""
        out: Dict[str, Any] = {"resharded": False, "recovered": [],
                               "replicas": []}
        self._prune_demoted()
        members = sorted(set(await self._zone_members()) | {self.peer_id})
        reshard_now = self.map is None
        if self.map is not None and list(self.map.members) != members:
            # Debounce: membership snapshots flap at heartbeat
            # resolution (a merely-delayed beat looks like a departure
            # for one beat, then un-looks like one). Require the changed
            # member set to persist across consecutive beats before
            # paying for a fenced reshard — gen churn both moves shard
            # bytes for peers that never died and re-fences in-flight
            # pulls.
            self._stale_beats += 1
            if members == self._pending_members:
                self._pending_beats += 1
            else:
                self._pending_members, self._pending_beats = members, 1
            # The backstop (2x the debounce) covers a view flapping
            # BETWEEN values every beat: the candidate never stabilizes,
            # but the map must not stay stale forever.
            reshard_now = (
                self._pending_beats >= self.RESHARD_DEBOUNCE_BEATS
                or self._stale_beats >= 2 * self.RESHARD_DEBOUNCE_BEATS
            )
        elif self.map is not None:
            self._pending_members, self._pending_beats = None, 0
            self._stale_beats = 0
        if reshard_now:
            self._pending_members, self._pending_beats = None, 0
            self._stale_beats = 0
            res = await self.reshard(members=members)
            out["resharded"] = bool(res.get("changed"))
            out["recovered"] = res.get("recovered", [])
        elif self.missing():
            out["recovered"] = await self.ensure_shards()
        out["replicas"] = await self.refresh_replicas()
        now = self.clock()
        if now - self._announced_t >= self.ANNOUNCE_TTL / 3.0:
            await self.announce()
            self._announced_t = now
        return out

    def start_maintenance(self, interval_s: float = 5.0) -> None:
        """Run maintain() every ``interval_s`` until stop()."""
        if self._maint_task is None or self._maint_task.done():
            self._maint_task = asyncio.get_event_loop().create_task(
                self._maint_loop(float(interval_s))
            )

    async def _maint_loop(self, interval_s: float) -> None:
        while True:
            await asyncio.sleep(interval_s)
            try:
                await self.maintain()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — one bad beat must not kill the loop
                log.debug("shard maintenance beat failed: %s", errstr(e))

    async def stop(self) -> None:
        t, self._maint_task = self._maint_task, None
        if t is not None:
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    # -- recovery ladder -----------------------------------------------------

    async def ensure_shards(self) -> List[int]:
        """Recover every owned-but-missing shard; returns the recovered
        list. Shards run concurrently (distinct sources), each through
        its own hedged ladder."""
        missing = self.missing()
        if not missing or self.map is None:
            return []
        # return_exceptions: one shard's unexpected failure (an
        # exception type the hedge loop doesn't anticipate) must not
        # cancel every sibling shard's in-flight recovery and abort the
        # whole beat.
        results = await asyncio.gather(
            *(self._recover_shard(s) for s in missing),
            return_exceptions=True,
        )
        self.feed_controller()
        got: List[int] = []
        for s, res in zip(missing, results):
            if isinstance(res, BaseException):
                log.warning(
                    "shard %d recovery raised unexpectedly: %s",
                    s, errstr(res),
                )
            elif res:
                got.append(s)
        return got

    async def _recover_shard(self, shard: int) -> bool:
        assert self.map is not None
        gen = self.map.gen
        fence = self.map.fence
        t0 = self.clock()
        self._recovering.add(shard)
        try:
            # Rung 0, zero RPCs: we were the shard's replica — promote.
            if self.store.promote(shard):
                self._note_recovered(shard, gen, "local_replica", t0)
                return True
            # Rung 0.5, still zero RPCs: we held this shard before a
            # demotion and the lingering copy has not expired (the
            # A->B->A membership wobble on a single-zone swarm).
            ent = self._demoted.pop(shard, None)
            if ent is not None and ent[1] > self.clock():
                self.store.put(shard, ent[0])
                self._note_recovered(shard, gen, "lingering_local", t0)
                return True
            cands: List[Tuple[str, str]] = []
            prev = self._prev_holders.get(shard)
            if prev and prev != self.peer_id:
                cands.append(("prev_holder", prev))
            rep = self.map.replica_of(shard)
            if rep and rep != self.peer_id and rep != prev:
                cands.append(("zone_replica", rep))
            targets: List[Tuple[str, str, Addr]] = []
            for src, pid in cands:
                rec = self.membership.peer_record(pid) or {}
                addr = rec.get("addr")
                if isinstance(addr, (list, tuple)) and len(addr) == 2:
                    targets.append((src, pid, (str(addr[0]), int(addr[1]))))
            same, cross = await self._announced_candidates(shard)
            seen = {pid for _, pid, _ in targets}
            for pid, addr in same:
                if pid not in seen:
                    targets.append(("zone_announce", pid, addr))
            for pid, addr in cross:
                targets.append(("cross_zone", pid, addr))
            arr, src = await self._hedged_fetch(shard, gen, fence, targets)
            if arr is None:
                self.recoveries_failed += 1
                self._record(
                    "shard_recovery_failed",
                    shard=shard,
                    gen=gen,
                    candidates=len(targets),
                )
                log.warning(
                    "shard %d recovery failed at gen %d (%d candidates)",
                    shard, gen, len(targets),
                )
                return False
            if self.map is None or self.map.fence != fence:
                # The map moved under us mid-pull (another churn event):
                # adopting would mix memberships — the fencing rule's
                # adopter half. The NEXT reshard's ladder runs fresh.
                self._record(
                    "shard_fence_rejected",
                    shard=shard,
                    got_gen=gen,
                    have_gen=self.map.gen if self.map else -1,
                    got_fence=fence,
                    have_fence=self.map.fence if self.map else None,
                    requester=self.peer_id,
                )
                return False
            self.store.put(shard, arr)
            self._note_recovered(shard, gen, src, t0)
            return True
        finally:
            self._recovering.discard(shard)

    def _note_recovered(self, shard: int, gen: int, src: str, t0: float) -> None:
        dt = max(self.clock() - t0, 0.0)
        self.recoveries += 1
        self._last_recovery_lat = dt
        self._recovery_lat.append((self.clock(), dt))
        self._record(
            "shard_recovered", shard=shard, gen=gen, src=src,
            dt_s=round(dt, 4),
        )
        log.info(
            "shard %d recovered from %s in %.3fs (gen %d)", shard, src, dt, gen
        )

    async def _hedged_fetch(
        self,
        shard: int,
        gen: int,
        fence: Optional[str],
        targets: List[Tuple[str, str, Addr]],
    ) -> Tuple[Optional[np.ndarray], str]:
        """Race the ladder: first target dialed immediately, the next
        joins after the hedge soft deadline, first success wins (losers
        cancelled). The soft deadline comes from the resilience policy's
        learned hedge operating point when one is attached, so shard
        recovery and tile recovery share one tail model."""
        if not targets:
            return None, ""
        soft_frac, max_inflight = 0.5, 2
        if self.resilience is not None:
            try:
                soft_frac, max_inflight = self.resilience.hedge_params("intra")
            except Exception:  # noqa: BLE001 — policy is advisory here
                pass
        soft_s = max(0.2, float(soft_frac) * self.FETCH_BUDGET_S)
        pending: Dict[asyncio.Task, str] = {}
        idx = 0
        try:
            while True:
                while idx < len(targets) and len(pending) < max(1, max_inflight):
                    src, pid, addr = targets[idx]
                    idx += 1
                    t = asyncio.create_task(
                        self._fetch_from(
                            addr, shard, gen, fence=fence,
                            cross_domain=(src == "cross_zone"),
                        )
                    )
                    pending[t] = src
                    if len(pending) == 1 and idx < len(targets):
                        break  # let the first run alone until the soft deadline
                if not pending:
                    return None, ""
                done, _ = await asyncio.wait(
                    set(pending),
                    timeout=soft_s if idx < len(targets) else None,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                for t in done:
                    src = pending.pop(t)
                    try:
                        arr = t.result()
                    except Exception as e:  # noqa: BLE001 — any one rung's failure just advances the ladder
                        log.debug(
                            "shard %d fetch via %s failed: %s",
                            shard, src, errstr(e),
                        )
                        continue
                    return arr, src
                if not done and idx >= len(targets) and not pending:
                    return None, ""
        finally:
            for t in pending:
                t.cancel()

    async def _fetch_from(
        self,
        addr: Addr,
        shard: int,
        gen: int,
        *,
        fence: Optional[str] = None,
        cross_domain: bool = False,
    ) -> np.ndarray:
        args = {
            "shard": shard,
            "gen": gen,
            "peer": self.peer_id,
            "domain": self.domain,
        }
        if fence is not None:
            args["fence"] = fence
        ret, payload = await self.transport.call(
            addr,
            "shard.fetch",
            args,
            timeout=self.FETCH_TIMEOUT,
            connect_timeout=self.CONNECT_TIMEOUT,
            # Bulk transfer: keep it out of the failure detector's
            # control-plane latency EWMA (state_sync's rule).
            record_latency=False,
        )
        # A cross-domain serve reports the SERVING zone's map — an
        # independent sequence, so equality is meaningless there; the
        # adopter-side fence in _recover_shard (our map unchanged through
        # the pull) is the guard on that rung. Same-domain replies are
        # held to the content fence when we named one (a deposed
        # holder's stale serve reports a stale fence), and to gen
        # equality on the legacy gen-only path.
        if not cross_domain:
            if fence is not None:
                if ret.get("fence") != fence:
                    raise RPCError(
                        "shard fencing mismatch in reply: fence "
                        f"{ret.get('fence')} != {fence}"
                    )
            elif int(ret.get("gen", -1)) != gen:
                raise RPCError(
                    f"shard fencing mismatch in reply: gen {ret.get('gen')} != {gen}"
                )
        lo, hi = self.ranges[shard]
        arr = np.frombuffer(bytes(payload), np.float32)
        if arr.size != hi - lo:
            raise RPCError(
                f"shard {shard} payload {arr.size} elems != range {hi - lo}"
            )
        if arr.size:
            vlo = float(np.min(arr))
            vhi = float(np.max(arr))
            if not (-self.MAX_ABS_VALUE < vlo <= vhi < self.MAX_ABS_VALUE):
                raise RPCError("shard payload failed the sanity guard")
        return arr.copy()

    # -- replica refresh -----------------------------------------------------

    async def refresh_replicas(self) -> List[int]:
        """Pull a copy of every shard this peer is the HRW runner-up for
        (best-effort, off the round's critical path — call after commits,
        the way the redundancy shares refresh). This is what makes rung 1
        of a SIGKILLed holder's ladder land: the replica was refreshed at
        the last commit, so recovery costs replay-from-replica, not an
        epoch restart."""
        if self.map is None:
            return []
        got: List[int] = []
        for s in self.map.replica_shards_of(self.peer_id):
            if self.store.get(s, allow_replica=False) is not None:
                continue  # we own it; no separate replica copy needed
            holder = self.map.holder_of(s)
            if holder is None or holder == self.peer_id:
                continue
            rec = self.membership.peer_record(holder) or {}
            addr = rec.get("addr")
            if not (isinstance(addr, (list, tuple)) and len(addr) == 2):
                continue
            try:
                arr = await self._fetch_from(
                    (str(addr[0]), int(addr[1])), s, self.map.gen,
                    fence=self.map.fence,
                )
            except (RPCError, OSError, asyncio.TimeoutError, ValueError) as e:
                log.debug("replica refresh of shard %d failed: %s", s, errstr(e))
                continue
            self.store.put(s, arr, replica=True)
            got.append(s)
        return got

    def degraded_copy(self, shard: int) -> Optional[np.ndarray]:
        """The zone's replicated copy of ``shard`` if this peer holds one
        — the degraded-slice commit source when a round's holder died
        mid-stream (the leader folds this + replay instead of aborting
        the epoch; the mass accounting books the slot recovered)."""
        arr = self.store.get(shard, allow_replica=True)
        if arr is None:
            ent = self._demoted.get(shard)
            if ent is not None and ent[1] > self.clock():
                arr = ent[0]
        return None if arr is None else arr.copy()

    # -- report surface ------------------------------------------------------

    def recent_recovery_latency_s(self) -> Optional[float]:
        now = self.clock()
        vals = [
            dt for t, dt in self._recovery_lat
            if now - t <= self.RECENT_WINDOW_S
        ]
        return round(max(vals), 4) if vals else None

    def summary(self) -> dict:
        """The ``sharding`` section of the volunteer report beat: the
        watchdog's ``shard_recovery_latency`` SLO reads
        ``recent_recovery_latency_s`` (None = no recent recovery = no
        tick), the doctor joins the counters with the flight events, and
        the campaign artifact snapshots the whole dict."""
        m = self.map
        return {
            "k": self.k,
            "gen": m.gen if m else None,
            "fence": m.fence if m else None,
            "zone": self.zone,
            "members": len(m.members) if m else 0,
            "owned": self.owned(),
            "replica": self.store.replicas(),
            "lingering": sorted(self._demoted),
            "missing": self.missing(),
            "health": self.health(),
            "bytes": self.store.bytes(),
            "peak_bytes": self.store.peak_bytes,
            "recoveries": self.recoveries,
            "recoveries_failed": self.recoveries_failed,
            "resharding_count": self.resharding_count,
            "fence_rejections": self.fence_rejections,
            "last_recovery_latency_s": (
                round(self._last_recovery_lat, 4)
                if self._last_recovery_lat is not None
                else None
            ),
            "recent_recovery_latency_s": self.recent_recovery_latency_s(),
        }
