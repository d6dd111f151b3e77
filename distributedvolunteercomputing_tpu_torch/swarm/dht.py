"""Kademlia-style DHT: decentralized peer discovery and rendezvous.

Reference parity: "coordinator/DHT peer-discovery on the host"
(BASELINE.json:5). The genre (SURVEY.md §0.2) uses the DHT for three things,
all supported here:

1. peer discovery — volunteers announce themselves under a shared key;
2. liveness — heartbeat records with TTL (absence == death);
3. matchmaking rendezvous — averaging groups form under round-scoped keys.

Design notes:
- 160-bit node ids, XOR metric, k-bucket routing table, iterative
  alpha-parallel lookups — standard Kademlia, sized down (k=8, alpha=3) for
  swarm scales the reference targets (4-ish volunteer slices, BASELINE.json:2).
- **Dict-valued keys**: every key holds a {subkey: (value, expiry)} map and
  STORE merges subkeys. Plain Kademlia can't enumerate "all peers"; the
  dict-value pattern makes membership listing one GET. (Same trick the
  hivemind lineage uses for its DHT records.)
- Values are small JSON blobs (addresses, step counts) — tensors NEVER go
  through the DHT; they ride Transport payloads peer-to-peer.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import random
import time
from typing import Dict, List, Optional, Set, Tuple

from distributedvolunteercomputing_tpu_torch.swarm.transport import Addr, RPCError, Transport
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)

ID_BITS = 160
K = 8       # bucket size / replication factor
ALPHA = 3   # lookup parallelism


class StaleWriteFenced(RPCError):
    """A fenced store was rejected because a storage node holds a HIGHER
    generation watermark for the (key, subkey): the writer has been deposed
    (the control plane handed its key range to a newer replica). Carries the
    highest watermark seen so the writer can re-resolve ownership."""

    def __init__(self, key: str, subkey: str, gen: int):
        super().__init__(f"fenced: {key}/{subkey} watermark gen {gen}")
        self.key, self.subkey, self.gen = key, subkey, gen


def _sha1_int(data: bytes) -> int:
    return int.from_bytes(hashlib.sha1(data).digest(), "big")


def key_id(key: str) -> int:
    return _sha1_int(key.encode())


def keyspace_position(peer_id: str, salt: int = 0) -> int:
    """Deterministic 160-bit keyspace position for ``peer_id`` under
    ``salt``. The group schedule (swarm/matchmaking.py) partitions the
    swarm by cutting this keyspace into equal arcs and re-salting per
    rotation, so every volunteer computes the same grid from nothing but
    the peer id — no negotiation, no coordinator round-trip."""
    return _sha1_int(f"grid|{salt}|{peer_id}".encode())


def node_id_for(addr: Addr) -> int:
    return _sha1_int(f"{addr[0]}:{addr[1]}".encode())


class RoutingTable:
    """k-buckets by XOR-distance prefix; most-recently-seen wins."""

    def __init__(self, own_id: int):
        self.own_id = own_id
        self.buckets: List[List[Tuple[int, Addr]]] = [[] for _ in range(ID_BITS)]

    def _bucket_of(self, nid: int) -> int:
        d = nid ^ self.own_id
        return d.bit_length() - 1 if d else 0

    def add(self, nid: int, addr: Addr) -> Optional[Tuple[int, Addr]]:
        """Insert or touch (move to most-recently-seen).

        Returns ``None`` when the contact was inserted/refreshed, or the
        least-recently-seen (nid, addr) of the FULL bucket as an eviction
        CANDIDATE — the new contact is NOT inserted; the caller decides via
        ping-before-evict (DHTNode._add_contact). Blind LRS-drop would let
        churny newcomers evict stable long-lived nodes, the exact opposite
        of Kademlia's stability heuristic."""
        if nid == self.own_id:
            return None
        bucket = self.buckets[self._bucket_of(nid)]
        for i, (bid, _) in enumerate(bucket):
            if bid == nid:
                bucket.pop(i)
                bucket.append((nid, addr))
                return None
        if len(bucket) < K:
            bucket.append((nid, addr))
            return None
        return bucket[0]

    def replace(self, old_nid: int, nid: int, addr: Addr) -> None:
        """Evict ``old_nid`` and insert the pending contact in its place."""
        self.remove(old_nid)
        self.add(nid, addr)

    def remove(self, nid: int) -> None:
        bucket = self.buckets[self._bucket_of(nid)]
        self.buckets[self._bucket_of(nid)] = [(b, a) for b, a in bucket if b != nid]

    def closest(self, target: int, n: int = K) -> List[Tuple[int, Addr]]:
        allnodes = [na for bucket in self.buckets for na in bucket]
        allnodes.sort(key=lambda na: na[0] ^ target)
        return allnodes[:n]

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets)


class DHTNode:
    """One DHT participant bound to a Transport."""

    def __init__(self, transport: Transport, maintenance_interval: float = 15.0):
        self.transport = transport
        self.node_id: int = 0  # assigned at start() once the port is known
        self.table: Optional[RoutingTable] = None
        # key -> {subkey -> (json_value, expiry_monotonic)}
        self.storage: Dict[str, Dict[str, Tuple[str, float]]] = {}
        # Records THIS node stored via store(): republished to the (possibly
        # changed) k-closest set until their TTL runs out, so a record
        # survives its original replicas churning away. Value is
        # (json, expiry, fence_gen_or_None, fence_owner).
        self._owned: Dict[Tuple[str, str], Tuple[str, float, Optional[int], str]] = {}
        # Fencing watermarks for control-plane writes: (key, subkey) ->
        # (highest generation seen, its writer id, expiry). A store
        # carrying a LOWER generation is refused — the stale-replica-write
        # rejection the replicated control plane's shard handoff depends
        # on (same epoch+generation idea round leadership uses). An EQUAL
        # generation from a DIFFERENT writer is arbitrated by smallest
        # writer id (the election idiom): two replicas whose split views
        # both claimed gen g must converge on one writer, not flip-flop
        # silently forever. Kept well past the record's own TTL so a
        # deposed writer stays fenced across a gap.
        self._fence_gens: Dict[Tuple[str, str], Tuple[int, str, float]] = {}
        # Replica-set cache for stores: target -> (stamp, k-closest). A
        # periodic re-store of the SAME key (membership heartbeats every
        # ttl/3) was paying a full iterative lookup each time for an
        # answer that changes only on churn; within the TTL the cached set
        # is as fresh as the republish window already tolerated. Evicted
        # on any store failure to a cached replica (the churn signal).
        self._store_routes: Dict[int, Tuple[float, List[Tuple[int, Addr]]]] = {}
        self._last_sweep = time.monotonic()
        self.maintenance_interval = maintenance_interval
        self._maint_task: Optional[asyncio.Task] = None
        self._tasks: Set[asyncio.Task] = set()
        self._pinging: Set[int] = set()  # LRS nodes with a probe in flight
        transport.register("dht.ping", self._rpc_ping)
        transport.register("dht.store", self._rpc_store)
        transport.register("dht.find", self._rpc_find)

    def _sweep_storage(self, interval: float = 30.0) -> None:
        """Drop expired subkeys/keys (amortized on writes): long-lived nodes
        otherwise accumulate one dead record per averaging round forever."""
        now = time.monotonic()
        if now - self._last_sweep < interval:
            return
        self._last_sweep = now
        for key in list(self.storage):
            rec = {sk: ve for sk, ve in self.storage[key].items() if ve[1] > now}
            if rec:
                self.storage[key] = rec
            else:
                del self.storage[key]
        for ks in [ks for ks, (_, _, exp) in self._fence_gens.items() if exp <= now]:
            del self._fence_gens[ks]

    async def start(self, bootstrap: Optional[List[Addr]] = None) -> None:
        addr = self.transport.addr
        if self.transport._server is None:
            addr = await self.transport.start()
        self.node_id = node_id_for(addr)
        self.table = RoutingTable(self.node_id)
        for peer in bootstrap or []:
            try:
                ret, _ = await self.transport.call(
                    tuple(peer), "dht.ping", {"sender": self._self_info()}, timeout=5.0
                )
                self._add_contact(int(ret["id"]), tuple(ret["addr"]))
            except (RPCError, OSError, asyncio.TimeoutError) as e:
                log.warning("bootstrap peer %s unreachable: %s", peer, errstr(e))
        if bootstrap:
            # Standard Kademlia join: lookup own id to populate the table.
            await self._lookup(self.node_id)
        if self.maintenance_interval > 0:
            self._maint_task = asyncio.create_task(self._maintenance_loop())

    async def stop(self) -> None:
        """Cancel background maintenance (pings, refresh, republish)."""
        for task in [self._maint_task, *self._tasks]:
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
        self._maint_task = None
        self._tasks.clear()

    def _self_info(self) -> dict:
        return {"id": str(self.node_id), "addr": list(self.transport.addr)}

    def _add_contact(self, nid: int, addr: Addr) -> None:
        """Routing-table insert with PING-BEFORE-EVICT: when the bucket is
        full, probe its least-recently-seen node; only a dead one is
        replaced (a live stable node beats an unknown newcomer)."""
        if self.table is None:
            return
        cand = self.table.add(nid, addr)
        if cand is None:
            return
        lrs_nid, lrs_addr = cand
        if lrs_nid in self._pinging:
            return  # probe already in flight; drop the newcomer for now
        self._pinging.add(lrs_nid)

        async def probe():
            try:
                try:
                    # Split budget: a dead LRS node usually fails at the dial
                    # (2s), leaving the RPC budget for peers that do accept.
                    await self.transport.call(
                        lrs_addr, "dht.ping", {"sender": self._self_info()},
                        timeout=3.0, connect_timeout=2.0,
                    )
                    self.table.add(lrs_nid, lrs_addr)  # alive: refresh to MRU
                except (RPCError, OSError, asyncio.TimeoutError):
                    self.table.replace(lrs_nid, nid, addr)
            finally:
                self._pinging.discard(lrs_nid)

        task = asyncio.create_task(probe())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _note_sender(self, args: dict) -> None:
        sender = args.get("sender")
        if sender and self.table is not None:
            self._add_contact(int(sender["id"]), tuple(sender["addr"]))

    # -- RPC handlers ------------------------------------------------------

    async def _rpc_ping(self, args: dict, payload: bytes) -> Tuple[dict, bytes]:
        self._note_sender(args)
        return {"id": str(self.node_id), "addr": list(self.transport.addr)}, b""

    FENCE_TTL = 600.0

    def _store_local(
        self, key: str, subkey: str, value_json: str, ttl: float,
        fence: Optional[int] = None, fence_owner: str = "",
    ) -> Optional[int]:
        """Apply one subkey store to local storage, honoring the fence
        watermark. Returns None on success, or the blocking watermark
        generation when the write is stale-fenced (NOT applied). A write
        at the CURRENT generation from a different owner is accepted only
        from a SMALLER owner id (deterministic tiebreak for two replicas
        whose split views claimed the same generation — the larger id is
        fenced and escalates, instead of both flip-flopping the record
        silently)."""
        now = time.monotonic()
        if fence is not None:
            cur = self._fence_gens.get((key, subkey))
            if cur is not None and cur[2] > now:
                cur_gen, cur_owner, _ = cur
                if cur_gen > fence or (
                    cur_gen == fence
                    and fence_owner
                    and cur_owner
                    and fence_owner > cur_owner
                ):
                    return cur_gen
            self._fence_gens[(key, subkey)] = (
                int(fence), fence_owner, now + max(self.FENCE_TTL, ttl)
            )
        rec = self.storage.setdefault(key, {})
        rec[subkey] = (value_json, now + ttl)
        return None

    async def _rpc_store(self, args: dict, payload: bytes) -> Tuple[dict, bytes]:
        """Single-subkey store, or a BATCHED one: ``values`` maps subkey ->
        [json, ttl] so one RPC can carry a whole membership shard's records
        (the control plane's heartbeat coalescing — N peers' beats cross as
        one frame per storage replica instead of N)."""
        self._note_sender(args)
        self._sweep_storage()
        key = args["key"]
        fence = args.get("fence")
        fence = int(fence) if fence is not None else None
        fence_owner = str(args.get("fence_owner") or "")
        values = args.get("values")
        if values is None:
            values = {args.get("subkey", ""): [args["value"], float(args.get("ttl", 60.0))]}
        blocked = None
        for sk, (value_json, ttl) in values.items():
            w = self._store_local(
                key, sk, value_json, float(ttl),
                fence=fence, fence_owner=fence_owner,
            )
            if w is not None:
                blocked = max(blocked or 0, w)
        if blocked is not None:
            return {"ok": False, "fenced": True, "gen": blocked}, b""
        return {"ok": True}, b""

    async def _rpc_find(self, args: dict, payload: bytes) -> Tuple[dict, bytes]:
        """FIND_VALUE + FIND_NODE in one: returns value (if any) and closer nodes."""
        self._note_sender(args)
        target = int(args["target"])
        out: dict = {"nodes": [[str(nid), list(a)] for nid, a in self.table.closest(target)]}
        key = args.get("key")
        if key is not None and key in self.storage:
            now = time.monotonic()
            live = {
                sk: (v, exp - now)
                for sk, (v, exp) in self.storage[key].items()
                if exp > now
            }
            if live:
                out["value"] = {sk: [v, ttl] for sk, (v, ttl) in live.items()}
        return out, b""

    # -- iterative lookup --------------------------------------------------

    async def _lookup(
        self, target: int, key: Optional[str] = None
    ) -> Tuple[List[Tuple[int, Addr]], Dict[str, Tuple[str, float]]]:
        """Iterative Kademlia lookup. Returns (k closest nodes, merged values)."""
        assert self.table is not None
        shortlist: Dict[int, Addr] = dict(self.table.closest(target, K))
        queried: set = set()
        found_values: Dict[str, Tuple[str, float]] = {}

        while True:
            candidates = sorted(
                (nid for nid in shortlist if nid not in queried), key=lambda n: n ^ target
            )[:ALPHA]
            if not candidates:
                break

            async def query(nid: int):
                try:
                    ret, _ = await self.transport.call(
                        shortlist[nid],
                        "dht.find",
                        {"target": str(target), "key": key, "sender": self._self_info()},
                        timeout=5.0,
                    )
                    return nid, ret
                except (RPCError, OSError, asyncio.TimeoutError):
                    return nid, None

            results = await asyncio.gather(*(query(nid) for nid in candidates))
            for nid, ret in results:
                queried.add(nid)
                if ret is None:
                    self.table.remove(nid)
                    shortlist.pop(nid, None)
                    continue
                self._add_contact(nid, shortlist[nid])
                for nid_s, addr in ret.get("nodes", []):
                    n = int(nid_s)
                    if n != self.node_id and n not in queried:
                        shortlist.setdefault(n, tuple(addr))
                for sk, (v, ttl) in ret.get("value", {}).items():
                    # freshest record per subkey wins
                    if sk not in found_values or found_values[sk][1] < ttl:
                        found_values[sk] = (v, ttl)

        closest = sorted(shortlist.items(), key=lambda na: na[0] ^ target)[:K]
        return closest, found_values

    # -- maintenance (refresh / republish) ---------------------------------

    async def _maintenance_loop(self) -> None:
        """Periodic table refresh + owned-record republish.

        Refresh: look up a random id in a random non-empty bucket's range
        (plus the node's own id), so stale buckets relearn the topology and
        dead contacts get pruned even when the application is idle.
        Republish: push every still-live owned record to the CURRENT
        k-closest set — nodes that joined closer to the key since the
        original store get a replica; without this, a rolling restart of the
        original replica set silently loses live records."""
        while True:
            await asyncio.sleep(self.maintenance_interval)
            try:
                await self._republish_owned()
                await self._refresh_bucket()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — maintenance must not die
                log.debug("dht maintenance iteration failed: %s", errstr(e))

    async def _republish_owned(self) -> None:
        now = time.monotonic()
        for (key, subkey) in list(self._owned):
            value_json, expiry, fence, fence_owner = self._owned[(key, subkey)]
            if expiry <= now:
                del self._owned[(key, subkey)]
                continue
            # Remaining ttl, not the original: republish must never extend a
            # record's life beyond what its owner asked for.
            try:
                await self._store_raw(
                    key, subkey, value_json, expiry - now,
                    fence=fence, fence_owner=fence_owner,
                )
            except StaleWriteFenced:
                # Deposed mid-life: a newer generation owns this record now;
                # republishing it would be exactly the stale write the fence
                # exists to reject. Drop ownership.
                del self._owned[(key, subkey)]

    async def _refresh_bucket(self) -> None:
        nonempty = [i for i, b in enumerate(self.table.buckets) if b]
        if not nonempty:
            return
        i = random.choice(nonempty)
        # A random id at XOR-distance with highest bit i from ourselves.
        rand = random.getrandbits(i) | (1 << i) if i else 1
        await self._lookup(self.node_id ^ rand)

    # -- public API --------------------------------------------------------

    STORE_ROUTE_TTL = 15.0
    MAX_STORE_ROUTES = 64

    async def _store_raw(
        self,
        key: str,
        subkey: str,
        value_json: str,
        ttl: float,
        fence: Optional[int] = None,
        fence_owner: str = "",
        batch: Optional[Dict[str, Tuple[str, float]]] = None,
    ) -> int:
        """Fan one store (or a ``batch`` of subkeys in ONE RPC per storage
        replica) to the k-closest set. Raises StaleWriteFenced when any
        replica (or the local store) holds a higher fence watermark."""
        target = key_id(key)
        now = time.monotonic()
        cached = self._store_routes.get(target)
        if cached is not None and now - cached[0] <= self.STORE_ROUTE_TTL:
            closest = cached[1]
        else:
            closest, _ = await self._lookup(target)
            if len(self._store_routes) >= self.MAX_STORE_ROUTES:
                self._store_routes.pop(next(iter(self._store_routes)))
            self._store_routes[target] = (now, closest)
        entries = batch if batch is not None else {subkey: (value_json, ttl)}

        def _legacy_args(sk: str, vj: str, t: float) -> dict:
            # The pre-batching wire shape every storage-node version
            # understands.
            args = {
                "key": key, "subkey": sk, "value": vj, "ttl": t,
                "sender": self._self_info(),
            }
            if fence is not None:
                args["fence"] = int(fence)
                if fence_owner:
                    args["fence_owner"] = fence_owner
            return args

        if batch is not None:
            payload_args: dict = {
                "key": key,
                "values": {sk: [vj, t] for sk, (vj, t) in entries.items()},
                "sender": self._self_info(),
            }
            if fence is not None:
                payload_args["fence"] = int(fence)
                if fence_owner:
                    payload_args["fence_owner"] = fence_owner
        else:
            # Single-subkey stores keep the legacy wire shape outright: a
            # storage node one version behind (no ``values`` support) must
            # keep accepting ordinary membership/rendezvous stores from
            # upgraded peers.
            payload_args = _legacy_args(subkey, value_json, ttl)
        # Always keep a local replica too: tiny swarms (N < K) stay robust.
        fenced_gen: Optional[int] = None
        local_blocked: Optional[int] = None
        for sk, (vj, t) in entries.items():
            w = self._store_local(key, sk, vj, t, fence=fence, fence_owner=fence_owner)
            if w is not None:
                local_blocked = max(local_blocked or 0, w)
        if local_blocked is not None:
            # Our own storage already holds a higher watermark: the write
            # is KNOWN stale — fanning it out would waste K RPCs and seed
            # laggard replicas with bytes whose rejection is foregone.
            raise StaleWriteFenced(key, subkey, local_blocked)
        ok = 1
        for nid, addr in closest:
            try:
                try:
                    ret, _ = await self.transport.call(
                        addr, "dht.store", payload_args, timeout=5.0
                    )
                except RPCError:
                    if batch is None:
                        raise
                    # A storage node one version behind chokes on the
                    # batched ``values`` shape (its handler KeyErrors on
                    # args["value"]): it is alive, just old — replay the
                    # batch as individual legacy frames instead of
                    # misreading the version skew as death and evicting a
                    # healthy node from the table every flush.
                    ret = {"ok": True}
                    for sk, (vj, t) in entries.items():
                        r1, _ = await self.transport.call(
                            addr, "dht.store", _legacy_args(sk, vj, t),
                            timeout=5.0,
                        )
                        if r1.get("fenced"):
                            ret = r1
                if ret.get("fenced"):
                    fenced_gen = max(fenced_gen or 0, int(ret.get("gen", 0)))
                else:
                    ok += 1
            except (RPCError, OSError, asyncio.TimeoutError):
                self.table.remove(nid)
                # A cached replica died: next store re-walks the keyspace.
                self._store_routes.pop(target, None)
        if fenced_gen is not None:
            # Any higher watermark means a newer generation owns this key
            # range — the caller must stop writing and re-resolve, even if
            # some laggard replicas accepted the stale bytes (status
            # merges break the tie by generation, see control_plane).
            raise StaleWriteFenced(key, subkey, fenced_gen)
        return ok

    async def store(
        self,
        key: str,
        value: object,
        subkey: str = "",
        ttl: float = 60.0,
        fence: Optional[int] = None,
        fence_owner: str = "",
    ) -> int:
        """Store (replicated to the K closest nodes incl. possibly self).
        Owned records are republished to the current closest set until their
        TTL expires (see _maintenance_loop). ``fence`` attaches a generation
        watermark: storage nodes refuse stores whose generation is below the
        highest they have seen for the (key, subkey) — StaleWriteFenced —
        the control plane's stale-replica-write rejection. ``fence_owner``
        (the writer's id) arbitrates EQUAL generations: smallest id wins,
        so two writers whose split views claimed the same generation
        resolve deterministically instead of flip-flopping the record."""
        self._sweep_storage()
        value_json = json.dumps(value)
        self._owned[(key, subkey)] = (
            value_json, time.monotonic() + ttl, fence, fence_owner
        )
        try:
            return await self._store_raw(
                key, subkey, value_json, ttl, fence=fence, fence_owner=fence_owner
            )
        except StaleWriteFenced:
            self._owned.pop((key, subkey), None)
            raise

    async def store_many(
        self,
        key: str,
        values: Dict[str, object],
        ttl: float = 60.0,
        ttls: Optional[Dict[str, float]] = None,
        fence: Optional[int] = None,
        fence_owner: str = "",
    ) -> int:
        """Batched store: ALL subkeys of ``values`` cross in ONE dht.store
        RPC per storage replica (the dict-valued-key merge makes this
        natural). The control plane's heartbeat coalescing: a replica
        flushes a whole membership shard per interval as one frame instead
        of one RPC per peer. NOT registered as owned — callers re-send at
        their own cadence."""
        if not values:
            return 0
        self._sweep_storage()
        batch = {
            sk: (json.dumps(v), float((ttls or {}).get(sk, ttl)))
            for sk, v in values.items()
        }
        return await self._store_raw(
            key, "", "", 0.0, fence=fence, fence_owner=fence_owner, batch=batch
        )

    async def get(self, key: str) -> Dict[str, object]:
        """All live subkeys of ``key``, merged across replicas."""
        target = key_id(key)
        now = time.monotonic()
        local = {
            sk: (v, exp - now)
            for sk, (v, exp) in self.storage.get(key, {}).items()
            if exp > now
        }
        _, remote = await self._lookup(target, key=key)
        merged = dict(local)
        for sk, (v, ttl) in remote.items():
            if sk not in merged or merged[sk][1] < ttl:
                merged[sk] = (v, ttl)
        return {sk: json.loads(v) for sk, (v, _) in merged.items()}

    async def get_value(self, key: str, default: object = None) -> object:
        rec = await self.get(key)
        return rec.get("", default)
