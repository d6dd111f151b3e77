"""Matchmaking: form an averaging group for one round.

The averaging cohort problem (SURVEY.md §7 hard part a): volunteers at
roughly the same training point must agree on WHO is in this round before any
tensor moves, and a peer dying mid-formation must not wedge anyone.

Protocol (leader-based, one DHT rendezvous key per round):

1. every interested peer announces under ``avg/<round_no>`` (TTL'd);
2. peers poll the key; the smallest peer_id present is the LEADER;
3. the leader freezes the member list, stamps a round EPOCH
   (hash of round key + members), and pushes ``avg.begin`` to each member;
4. members wait for the begin; no begin within the timeout -> round skipped
   (local training continues — averaging is best-effort, Moshpit-style).

The epoch travels with every subsequent tensor exchange; a message from a
stale or conflicting group is rejected by epoch mismatch rather than
corrupting the round.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import math
import re
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from distributedvolunteercomputing_tpu_torch.swarm.dht import (
    ID_BITS,
    DHTNode,
    keyspace_position,
)
from distributedvolunteercomputing_tpu_torch.swarm.transport import Addr, RPCError, Transport
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class GroupAssignment:
    """One volunteer's slot in one rotation of the group schedule."""

    rot: int        # rotation index (wall-clock window of the schedule)
    group_id: str   # rendezvous-key suffix, e.g. "r42.g3" / "r42.zdc1.g0"
    n_groups: int   # how many groups THIS view's live count splits into
    n_peers: int    # live peers behind that split (this view)
    # The peer ids this view puts in MY group (sorted). The whole point of
    # a deterministic schedule: the group is KNOWN before the round, so
    # formation can skip the generic DHT rendezvous (store + poll loop, a
    # full iterative lookup per poll) and members can join their leader
    # candidate directly — see Matchmaker.form_group_direct.
    members: Tuple[str, ...] = ()
    # Hierarchy level this assignment schedules ("flat" = the single-level
    # PR-7 grid; "intra" = a group scoped to one zone's members; "cross" =
    # a cross-zone mixing rotation). The level rides in the group_id, so
    # the group-scoped round key — and therefore the epoch hash, fencing
    # tokens, and retained-bytes keys — is level-scoped by construction.
    level: str = "flat"
    # Zone an "intra" assignment is scoped to ("" otherwise).
    zone: str = ""
    # Shard domain this assignment is scoped to (zone-sharded training,
    # swarm/sharding.py): None = unsharded. When set, every member of the
    # group holds the SAME shard, the ``.s<k>`` segment rides in the
    # group_id — so the round key, epoch hash, and fencing tokens are
    # shard-scoped by construction and two shards' gradients can never
    # rendezvous into one round.
    shard: Optional[int] = None


class GroupSchedule:
    """Moshpit-style rotating multi-group partition of the live swarm.

    One group per epoch caps swarm-wide sync throughput at one leader's
    NIC and one group's size. This schedule instead partitions the live
    membership into ``~n_peers / target_size`` groups every rotation by
    cutting the DHT keyspace into equal arcs: a volunteer's group is the
    arc its salted ``keyspace_position`` falls in, and the salt is the
    rotation index — so successive rounds regroup the swarm along a fresh
    seeded grid and group averages mix globally in O(log N) rounds
    (Moshpit SGD's argument; the mixing unit test in
    tests/test_multigroup.py measures the bound, and a NON-rotating
    schedule measurably fails it).

    Properties the swarm depends on:

    - **deterministic and local**: any volunteer computes its own group
      from (peer ids, rotation) alone — no negotiation, no extra RPCs.
      Each group then runs the ORDINARY rendezvous/leader/begin protocol
      under its group-scoped key, so the epoch+generation fencing from
      leader failover applies per group unchanged.
    - **view-divergence tolerant**: a peer's arc depends only on its OWN
      id, never on its rank in a sorted list, so two volunteers whose
      membership views differ by a churned peer still compute the same
      groups for everyone else. Disagreement about the group COUNT (only
      near ``n / target_size`` boundaries) degrades to an underfilled
      rendezvous, never to mixed tensors (the epoch guards that).
    - **best-effort sizing**: arcs are equal but positions are hashed, so
      group sizes fluctuate around ``target_size``; an undersized group
      skips its round (min_group) and its members re-mix next rotation.

    **Hierarchy** (``cross_zone_every_k`` > 0): real swarms have locality
    structure — same-DC TPU slices next to homes behind asymmetric WAN
    links — and the flat grid burns slow cross-zone bandwidth every round
    moving gradient mass an intra-zone group could have averaged locally.
    With volunteers advertising a ``zone`` (membership ``extra_info``),
    the schedule becomes a two-level grid in the hierarchical-HSDP shape:
    most rotations are INTRA-zone (the hash-arc layout scoped to each
    zone's own member set, so groups never span a zone boundary and no
    cross-zone byte moves), and every k-th rotation is a CROSS-zone
    mixing rotation (the ordinary zone-blind flat grid, whose hashed arcs
    span zones). Group means still reach the global mean because the
    Moshpit argument applies per level — O(log zone_size) intra rotations
    converge each zone, O(log N) cross rotations mix the zone means — and
    the level rides in the group id (``r<rot>.z<zone>.g<i>`` vs
    ``r<rot>.x<i>``), so the epoch+generation fencing and group-local
    failover of the flat schedule carry over unchanged. Fallback rules:
    fewer than two distinct advertised zones (or ``cross_zone_every_k``
    0) degrade to the flat grid — a mixed-version swarm where some peers
    never advertise a zone schedules those peers as one "" pseudo-zone,
    and never crashes.
    """

    def __init__(
        self,
        target_size: int = 8,
        rotation_s: float = 15.0,
        clock: Callable[[], float] = time.time,
        min_size: int = 2,
        cross_zone_every_k: int = 0,
    ):
        if target_size < 2:
            raise ValueError(f"target_size must be >= 2, got {target_size}")
        if rotation_s <= 0:
            raise ValueError(f"rotation_s must be > 0, got {rotation_s}")
        if cross_zone_every_k < 0:
            raise ValueError(
                f"cross_zone_every_k must be >= 0 (0 = flat), got {cross_zone_every_k}"
            )
        self.target_size = int(target_size)
        self.rotation_s = float(rotation_s)
        # The consensus wall clock when one exists (ClockSync.now): every
        # member of a prospective group must land in the same rotation
        # window or they rendezvous under different keys and miss.
        self.clock = clock
        self.min_size = int(min_size)
        # Hierarchy cadence: every k-th rotation mixes across zones; the
        # rest stay intra-zone. 0 = flat single-level grid (and any value
        # degrades to flat while fewer than two zones are advertised).
        self.cross_zone_every_k = int(cross_zone_every_k)

    def rotation(self) -> int:
        return int(self.clock() // self.rotation_s)

    def retune(
        self,
        target_size: Optional[int] = None,
        cross_zone_every_k: Optional[int] = None,
    ) -> None:
        """Live re-tune by the closed-loop controller (swarm/controller.py):
        group geometry (the topology knob — sync-group / butterfly /
        gossip map onto target sizes) and the cross-zone cadence (the
        learned k replacing the static flag). Validated like the ctor.

        Consistency note: the schedule is LOCAL — every volunteer
        computes its own split — so a retune takes effect at this
        volunteer's next ``assign`` and peers whose controllers have not
        (yet) made the same decision compute a different split for one or
        more rotations. That divergence is the schedule's documented
        degradation class: an underfilled rendezvous or a skipped round,
        never mixed tensors (the epoch hash covers the frozen member
        list). Hysteresis + shared evidence converge the fleet; the
        chaos_adaptive campaign measures the cost."""
        if target_size is not None:
            if target_size < 2:
                raise ValueError(f"target_size must be >= 2, got {target_size}")
            self.target_size = int(target_size)
        if cross_zone_every_k is not None:
            if cross_zone_every_k < 0:
                raise ValueError(
                    f"cross_zone_every_k must be >= 0 (0 = flat), got "
                    f"{cross_zone_every_k}"
                )
            self.cross_zone_every_k = int(cross_zone_every_k)

    def level_of(self, rot: int, zones_by_peer: Optional[Dict[str, str]] = None) -> str:
        """Hierarchy level rotation ``rot`` schedules at, given the zone
        advertisements in view ("flat" when the hierarchy is off or fewer
        than two distinct zones are advertised)."""
        k = self.cross_zone_every_k
        if k <= 0 or len(set((zones_by_peer or {}).values())) < 2:
            return "flat"
        return "cross" if rot % k == 0 else "intra"

    @staticmethod
    def zone_tag(zone: str) -> str:
        """Deterministic, key-safe tag for a zone name. Readable when the
        name already is; a sanitized name gets a crc suffix so two zones
        that sanitize identically ("a b" vs "a_b") cannot collide onto one
        keyspace (collision would only cost an accidental cross-zone
        group, never mixed tensors — the epoch hash covers members — but
        it would silently defeat the locality the operator asked for).
        The unzoned "" pseudo-zone tags as "~", a character the sanitizer
        can never emit for a real zone name — so no operator-chosen zone
        (not even one literally named "none") can share its keyspace."""
        if not zone:
            return "~"
        safe = re.sub(r"[^A-Za-z0-9_-]", "_", zone)[:16]
        if safe == zone:
            return safe
        return f"{safe}-{zlib.crc32(zone.encode()) & 0xFFFF:04x}"

    @staticmethod
    def n_groups(n_peers: int, target_size: int, min_size: int = 2) -> int:
        """Groups an ``n_peers`` swarm splits into: ``round(n / target)``,
        floored at 1 and capped so the EXPECTED group size never drops
        below ``min_size`` (a split that mostly produces unformable
        groups is worse than fewer, larger groups)."""
        if n_peers <= 0:
            return 0
        g = int(round(n_peers / float(target_size))) or 1
        return max(1, min(g, n_peers // max(min_size, 1)))

    @staticmethod
    def group_of(peer_id: str, rot: int, n_groups: int) -> int:
        """Arc index of ``peer_id`` under rotation ``rot`` — a function of
        the peer's own id only (view-divergence tolerance, see class doc)."""
        return (keyspace_position(peer_id, rot) * n_groups) >> ID_BITS

    def assign(
        self,
        member_ids,
        peer_id: str,
        rot: Optional[int] = None,
        zones: Optional[Dict[str, str]] = None,
        shards: Optional[Dict[str, int]] = None,
    ) -> Optional[GroupAssignment]:
        """This peer's assignment for rotation ``rot`` (current window when
        None), or None when the live swarm is too small to split — the
        caller then falls back to the single constant rendezvous key,
        which keeps small swarms byte-identical to the pre-schedule
        behavior.

        ``zones`` maps peer_id -> advertised zone (absent/None/"" = the
        unzoned pseudo-zone). With the hierarchy on and >= 2 distinct
        zones in view, intra rotations scope the hash-arc layout to this
        peer's zone — an assignment with fewer than ``min_size`` members
        (a lone peer in its zone) is returned as-is so the caller can
        skip the round CHEAPLY (it is deterministic that nobody else will
        rendezvous under that key) instead of burning a join timeout.

        ``shards`` maps peer_id -> advertised primary shard (zone-sharded
        training). A sharded peer's view is restricted to SAME-shard
        peers before any level logic runs, and the shard rides in the
        group id (``r<rot>.s<k>...``): cross/flat rotations then average
        only the peer's own shard across zones (the ~1/K wire saving),
        and an intra rotation degenerates to a singleton skip (inside a
        zone each shard has one holder; the intra links carry
        gather/scatter, not averaging). Sharded and unsharded peers never
        share a group — mixed fleets split along the advertisement, and
        the shard-scoped key + epoch hash make cross-shard mixing
        structurally impossible rather than merely unlikely. Because a
        shard-scoped view can be far below ``target_size``, an undersized
        sharded group is returned as-is (cheap-skip contract above)
        instead of falling back to the shard-blind constant key."""
        ids = set(member_ids)
        ids.add(peer_id)
        rot = self.rotation() if rot is None else int(rot)
        sk: Optional[int] = None
        if shards:
            if peer_id in shards:
                sk = int(shards[peer_id])
                ids = {pid for pid in ids if shards.get(pid) == sk}
            else:
                ids = {pid for pid in ids if pid not in shards}
        zmap = {pid: str((zones or {}).get(pid) or "") for pid in ids}
        level = self.level_of(rot, zmap)
        stag = "" if sk is None else f"s{sk}."
        if level == "intra":
            zone = zmap[peer_id]
            zone_ids = {pid for pid, z in zmap.items() if z == zone}
            n = len(zone_ids)
            g = max(self.n_groups(n, self.target_size, self.min_size), 1)
            ztag = self.zone_tag(zone)
            for home, grp in self._arcs(zone_ids, rot, g, self.min_size):
                if peer_id in grp:
                    return GroupAssignment(
                        rot=rot, group_id=f"r{rot}.{stag}z{ztag}.g{home}",
                        n_groups=g, n_peers=n, members=tuple(sorted(grp)),
                        level="intra", zone=zone, shard=sk,
                    )
            # Singleton zone: _arcs yields one group of one; still scoped.
            return GroupAssignment(
                rot=rot, group_id=f"r{rot}.{stag}z{ztag}.g0", n_groups=1,
                n_peers=n, members=(peer_id,), level="intra", zone=zone,
                shard=sk,
            )
        n = len(ids)
        g = self.n_groups(n, self.target_size, self.min_size)
        gtag = "x" if level == "cross" else "g"
        if g <= 1:
            if sk is None:
                return None
            # Shard-scoped views are small by design: one same-shard group
            # under the shard-scoped key (never the shard-blind fallback).
            return GroupAssignment(
                rot=rot, group_id=f"r{rot}.{stag}{gtag}0", n_groups=1,
                n_peers=n, members=tuple(sorted(ids)), level=level, shard=sk,
            )
        for home, grp in self._arcs(ids, rot, g, self.min_size):
            if peer_id in grp:
                return GroupAssignment(
                    rot=rot, group_id=f"r{rot}.{stag}{gtag}{home}", n_groups=g,
                    n_peers=n, members=tuple(sorted(grp)), level=level,
                    shard=sk,
                )
        return None  # unreachable: peer_id is in ids

    @classmethod
    def _arcs(
        cls, ids, rot: int, g: int, min_size: int
    ) -> List[Tuple[int, List[str]]]:
        """(home_arc, members) groups for one view: peers bucketed by their
        own salted arc, then undersized arcs CARRY-MERGED into the next
        arc — a hash partition leaves occasional arcs below ``min_size``,
        and without the merge their members burn a whole join timeout on a
        rendezvous that can never form. The merge is computed from the
        local view, so divergent views can disagree about a carried
        member's group; like every other divergence here that costs an
        underfilled round, never mixed tensors."""
        arcs: List[List[str]] = [[] for _ in range(g)]
        for pid in sorted(ids):
            arcs[cls.group_of(pid, rot, g)].append(pid)
        out: List[Tuple[int, List[str]]] = []
        carry: List[str] = []
        for a in range(g):
            cur = arcs[a] + carry
            if 0 < len(cur) < min_size:
                carry = cur
                continue
            if cur:
                out.append((a, cur))
            carry = []
        if carry:
            # Leftover tail: fold into the last formed group (or stand
            # alone when nothing formed at all — the caller's min_group
            # then decides).
            if out:
                out[-1][1].extend(carry)
            else:
                out.append((g - 1, carry))
        return out

    @classmethod
    def partition(
        cls,
        member_ids,
        rot: int,
        target_size: int,
        min_size: int = 2,
        zones: Optional[Dict[str, str]] = None,
        cross_zone_every_k: int = 0,
        shards: Optional[Dict[str, int]] = None,
    ) -> List[List[str]]:
        """The full partition one view computes for rotation ``rot``
        (groups in arc order, members sorted by id). Tests, the chaos
        campaign, and the scale bench use this to know who SHOULD group
        with whom; the swarm itself never needs the global view. With
        ``zones`` + ``cross_zone_every_k`` the partition is the
        hierarchical one: per-zone arcs on intra rotations (zones in
        sorted order), the zone-blind flat grid on cross rotations. With
        ``shards`` the partition runs per shard domain (shards in sorted
        order, unsharded peers last), mirroring ``assign``'s view
        restriction."""
        if shards:
            out: List[List[str]] = []
            ids_all = sorted(set(member_ids))
            buckets = sorted({int(s) for p, s in shards.items() if p in set(ids_all)})
            for sk in buckets:
                sub = [p for p in ids_all if shards.get(p) == sk]
                out.extend(
                    cls.partition(
                        sub, rot, target_size, min_size, zones,
                        cross_zone_every_k,
                    )
                )
            rest = [p for p in ids_all if p not in shards]
            if rest:
                out.extend(
                    cls.partition(
                        rest, rot, target_size, min_size, zones,
                        cross_zone_every_k,
                    )
                )
            return out
        ids = sorted(set(member_ids))
        zmap = {pid: str((zones or {}).get(pid) or "") for pid in ids}
        k = int(cross_zone_every_k)
        hier = k > 0 and len(set(zmap.values())) >= 2
        if hier and rot % k != 0:
            out: List[List[str]] = []
            for zone in sorted(set(zmap.values())):
                zone_ids = [pid for pid in ids if zmap[pid] == zone]
                g = max(cls.n_groups(len(zone_ids), target_size, min_size), 1)
                out.extend(
                    sorted(grp) for _, grp in cls._arcs(zone_ids, rot, g, min_size)
                )
            return out
        g = cls.n_groups(len(ids), target_size, min_size)
        if g <= 1:
            return [ids] if ids else []
        return [sorted(grp) for _, grp in cls._arcs(ids, rot, g, min_size)]


@dataclasses.dataclass
class Group:
    epoch: str
    members: List[Tuple[str, Addr]]  # sorted by peer_id; [0] is the leader
    my_index: int
    # Leader-issued per-member secret: each member receives ONLY its own in
    # its private begin message, and echoes it with every contribution, so a
    # member cannot forge traffic under another member's id (the leader holds
    # the full table in member_tokens; everyone else sees just their own).
    token: str = ""
    member_tokens: Optional[Dict[str, str]] = None
    # Absolute consensus-clock time this round must COMMIT by (leader-stamped
    # at begin; None for legacy leaders). Every member bounds its waits by
    # this instead of its full configured timeout, so the whole group agrees
    # on when the round closes — the deadline-bounded averaging contract.
    deadline: Optional[float] = None
    # The leader's round budget (seconds) behind that deadline, plus when
    # THIS node learned the round on its own monotonic clock. Together they
    # give a skew-free bound on the remaining wait: on step-cadence swarms
    # the deadline clock is raw wall time, and a member whose clock runs
    # ahead of the leader's by more than the budget would otherwise see the
    # round as already expired (see AveragerBase._deadline_wait).
    budget: Optional[float] = None
    formed_mono: float = dataclasses.field(default_factory=time.monotonic)
    # Round GENERATION — the fencing token. 0 for the round the matchmaking
    # leader began; each leader-failover recovery over the same epoch bumps
    # it. Every sync.contribute/sync.fetch carries it, and handlers reject a
    # mismatch, so a deposed or partitioned ex-leader's late serve (or a
    # member's stale push) can never mix into a newer generation's round.
    gen: int = 0
    # Group-schedule id this round formed under ("" = the single constant
    # rendezvous key). Purely observational: the schedule's group id is
    # already folded into the epoch hash via the group-scoped round_key,
    # so fencing/tokens/retained bytes are group-scoped by construction —
    # this field just lets stats and failover logs name the group.
    group_id: str = ""

    @property
    def leader_id(self) -> str:
        return self.members[0][0]

    @property
    def size(self) -> int:
        return len(self.members)

    def addr_of(self, peer_id: str) -> Addr:
        for pid, addr in self.members:
            if pid == peer_id:
                return addr
        raise KeyError(peer_id)


class Matchmaker:
    def __init__(
        self,
        transport: Transport,
        dht: DHTNode,
        peer_id: str,
        *,
        clock: Callable[[], float] = time.time,
        exclude: Optional[Callable[[str], bool]] = None,
        lead_exclude: Optional[Callable[[str], bool]] = None,
        lead_weight: Optional[Callable[[str], Optional[float]]] = None,
        rendezvous_get=None,
    ):
        self.transport = transport
        self.dht = dht
        self.peer_id = peer_id
        # Replicated-control-plane rendezvous reader (an async callable:
        # key -> records dict, or None on failure): form_group's poll loop
        # reads the round key through a replica's micro-cache — N members
        # polling one forming round cost the swarm ~one iterative DHT
        # lookup per cache window instead of one per member per poll. Any
        # failure (replica churn, no control plane) falls back to the
        # direct DHT walk, so matchmaking never depends on a coordinator
        # being alive. Writes stay direct DHT stores either way.
        self.rendezvous_get = rendezvous_get
        # ``clock`` is the consensus wall clock round deadlines are stamped
        # on (the volunteer passes ClockSync.now). ``exclude`` is the
        # straggler pre-exclusion predicate (resilience policy / phi
        # detector): a LEADER drops candidates it returns True for when
        # freezing the member list — they stay in the swarm and retry next
        # round, they just don't gate THIS round. ``lead_exclude`` is the
        # LEADERSHIP exclusion predicate: candidates it flags (recently
        # deposed as leader, currently suspected) are passed over when
        # deciding who self-elects, so a flaky peer is not handed the lead
        # again the moment it reappears. ``lead_weight`` maps a candidate
        # to its advertised uplink bandwidth (bytes/s; None = none
        # advertised): the leader serves the whole group's begin fan-out,
        # contribution gather, and result fetches, so among non-excluded
        # candidates the fattest advertised uplink self-elects — computed
        # from the membership snapshot alone, no extra RPCs.
        self.clock = clock
        self.exclude = exclude
        self.lead_exclude = lead_exclude
        self.lead_weight = lead_weight
        # Peers dropped from the last led round's member list (stats/tests).
        self.last_preexcluded: List[str] = []
        self._begin_futures: Dict[str, asyncio.Future] = {}
        # Begins that arrived while no form_group() was waiting, stamped with
        # arrival time: consumed only if still fresh (a begin parked after a
        # round timed out must not leak into the NEXT round as a dead epoch).
        self._parked_begins: Dict[str, Tuple[float, dict]] = {}
        # Direct-join fast path (form_group_direct): joins collected while
        # we lead a scheduled round, and joins that arrived BEFORE our
        # form_group_direct() registered the collector (a member can dial
        # its leader candidate the instant its clock enters the rotation
        # window) — same park-with-TTL discipline as begins.
        self._join_collectors: Dict[str, dict] = {}
        self._parked_joins: Dict[str, Tuple[float, Dict[str, Addr]]] = {}
        # round_keys we already led (direct path), with lead time: a join
        # arriving AFTER the freeze gets an immediate "too late" reply, so
        # a straggler skips its round in one RPC instead of burning the
        # whole join timeout waiting for a begin that can never come.
        self._recent_leads: Dict[str, float] = {}
        transport.register("avg.begin", self._rpc_begin)
        transport.register("avg.join", self._rpc_join)

    PARKED_BEGIN_TTL = 3.0
    # Distinct round_keys a remote peer can park begins under; entries are
    # also swept by TTL on every begin RPC, so keys that never reach a
    # form_group() cannot accumulate for the process lifetime.
    MAX_PARKED_BEGINS = 64

    async def _rpc_begin(self, args: dict, payload: bytes):
        fut = self._begin_futures.get(args["round_key"])
        if fut is not None and not fut.done():
            fut.set_result(args)
        else:
            # Begin can arrive before our form_group() registers the future.
            now = time.monotonic()
            for k in [
                k for k, (ts, _) in self._parked_begins.items()
                if now - ts > self.PARKED_BEGIN_TTL
            ]:
                del self._parked_begins[k]
            if (
                args["round_key"] not in self._parked_begins
                and len(self._parked_begins) >= self.MAX_PARKED_BEGINS
            ):
                raise RPCError("parked begin cap reached")
            self._parked_begins[args["round_key"]] = (now, args)
        return {"ok": True}, b""

    async def _rpc_join(self, args: dict, payload: bytes):
        """A scheduled member announcing itself directly to this node, its
        computed leader candidate for ``round_key`` (form_group_direct).
        Collected live when our own form_group_direct is leading that key;
        parked briefly otherwise (we may be about to)."""
        round_key = args["round_key"]
        pid = str(args["peer"])
        addr = tuple(args["addr"])
        col = self._join_collectors.get(round_key)
        if col is not None:
            if pid not in col["members"]:
                col["members"][pid] = addr
                col["event"].set()
            return {"ok": True}, b""
        now = time.monotonic()
        led_at = self._recent_leads.get(round_key)
        if led_at is not None and now - led_at <= self.PARKED_BEGIN_TTL:
            return {"ok": False, "late": True}, b""
        for k in [
            k for k, (ts, _) in self._parked_joins.items()
            if now - ts > self.PARKED_BEGIN_TTL
        ]:
            del self._parked_joins[k]
        ts, joiners = self._parked_joins.get(round_key, (now, {}))
        if (
            round_key not in self._parked_joins
            and len(self._parked_joins) >= self.MAX_PARKED_BEGINS
        ):
            # Table full: refuse WITHOUT raising — an RPCError here would
            # read as "candidate dead" to the joiner, who would then
            # self-elect a splinter group under the same key. A not-ok
            # reply makes it retry/skip instead (form_group_direct).
            return {"ok": False, "busy": True}, b""
        joiners[pid] = addr
        self._parked_joins[round_key] = (ts, joiners)
        return {"ok": True}, b""

    async def _read_rendezvous(self, round_key: str) -> Dict[str, object]:
        """One poll of the rendezvous key: via the control plane's cached
        read when wired (and answering), else the direct DHT lookup."""
        if self.rendezvous_get is not None:
            try:
                rec = await self.rendezvous_get(round_key)
            except Exception as e:  # noqa: BLE001 — reader is an accelerator
                log.debug("rendezvous reader failed: %s", errstr(e))
                rec = None
            if rec is not None:
                return rec
        return await self.dht.get(round_key)

    @staticmethod
    def _epoch(round_key: str, member_ids: List[str], nonce: str) -> str:
        return hashlib.sha1(
            (round_key + "|" + ",".join(member_ids) + "|" + nonce).encode()
        ).hexdigest()[:16]

    async def form_group(
        self,
        round_key: str,
        min_group: int = 2,
        max_group: int = 16,
        join_timeout: float = 10.0,
        settle: float = 0.5,
        round_budget_s: Optional[float] = None,
    ) -> Optional[Group]:
        """Rendezvous under ``round_key``.

        The key is a CONSTANT per averaging mode (e.g. ``avg/sync``), not a
        step number: volunteers at different local steps (fast peers, resumed
        checkpoints) must still find each other. Round uniqueness comes from
        the leader's nonce baked into the epoch, so two back-to-back rounds
        under the same key can never mix tensors.
        """
        my_addr = list(self.transport.addr)
        await self.dht.store(round_key, {"addr": my_addr}, subkey=self.peer_id, ttl=60.0)

        # form_group is serial per Matchmaker and always pops its future on
        # exit, so no prior future can exist here.
        fut = self._begin_futures[round_key] = asyncio.Future()
        parked = self._parked_begins.pop(round_key, None)
        if parked is not None and not fut.done():
            ts, begin = parked
            if time.monotonic() - ts <= self.PARKED_BEGIN_TTL:
                fut.set_result(begin)
            else:
                log.info("round %s: dropping stale parked begin (%.1fs old)",
                         round_key, time.monotonic() - ts)

        deadline = time.monotonic() + join_timeout
        members: List[Tuple[str, Addr]] = []
        stable_since = None
        try:
            while time.monotonic() < deadline:
                if fut.done():  # someone elected themselves leader already
                    return self._group_from_begin(fut.result(), round_key)
                rec = await self._read_rendezvous(round_key)
                current = sorted(
                    (pid, tuple(info["addr"])) for pid, info in rec.items() if info is not None
                )
                if [m[0] for m in current] != [m[0] for m in members]:
                    members = current
                    stable_since = time.monotonic()
                enough = len(members) >= min_group
                stable = stable_since is not None and time.monotonic() - stable_since >= settle
                full = len(members) >= max_group
                if enough and (stable or full):
                    # Elect over the same [:max_group] window _lead will
                    # freeze, so the winner is always in its own group.
                    if self._pick_leader(members[:max_group]) == self.peer_id:
                        return await self._lead(
                            round_key, members[:max_group],
                            min_group=min_group, round_budget_s=round_budget_s,
                        )
                    # not leader: fall through to awaiting begin
                    break
                await asyncio.sleep(0.1)

            if not (len(members) >= min_group):
                log.info("round %s: only %d peers, skipping", round_key, len(members))
                return None
            remaining = max(deadline - time.monotonic(), 2.0)
            begin = await asyncio.wait_for(fut, timeout=remaining)
            return self._group_from_begin(begin, round_key)
        except asyncio.TimeoutError:
            log.info("round %s: no begin from leader, skipping", round_key)
            return None
        finally:
            self._begin_futures.pop(round_key, None)

    async def form_group_direct(
        self,
        round_key: str,
        expected: List[Tuple[str, Addr]],
        min_group: int = 2,
        max_group: int = 16,
        join_timeout: float = 10.0,
        settle: float = 0.5,
        round_budget_s: Optional[float] = None,
    ) -> Optional[Group]:
        """Scheduled-group formation: rendezvous WITHOUT the DHT.

        ``expected`` is the (pid, addr) set the group schedule puts in this
        round's group — deterministic and already known to every member, so
        the generic DHT rendezvous (a store fanned to K replicas plus a
        full iterative lookup per 100 ms poll) is pure waste here. Instead
        each member sends ONE ``avg.join`` RPC to its leader candidate
        (``_pick_leader`` over the expected set) and awaits the begin; the
        candidate collects joins and leads the moment every expected member
        has joined (or min_group + a ``settle`` quiet period, or the join
        timeout — whichever first). ~4 RPCs per member-round total, and no
        settle wait on the common path.

        Degradation matches the classic path class-for-class: a dead
        candidate is skipped (its conn failure is the signal) and the next
        expected id self-elects; divergent views (churn near arc
        boundaries, disagreeing suspicion) can split a group into two
        epochs or cost an underfilled round, never mixed tensors — the
        epoch hash still covers the frozen member list. Joiners outside
        ``expected`` (a peer whose view merged them into this arc) are
        accepted up to ``max_group``: inclusion under divergence beats
        symmetry. The epoch/token/begin machinery is byte-identical to
        form_group's — failover, fencing, and recovery see no difference.
        """
        deadline = time.monotonic() + join_timeout
        dead: set = set()
        fut = self._begin_futures[round_key] = asyncio.Future()
        parked = self._parked_begins.pop(round_key, None)
        if parked is not None and not fut.done():
            ts, begin = parked
            if time.monotonic() - ts <= self.PARKED_BEGIN_TTL:
                fut.set_result(begin)
        try:
            while True:
                alive = [m for m in expected if m[0] not in dead]
                if not alive:
                    log.info("round %s: every expected peer dead, skipping",
                             round_key)
                    return None
                # begin-wins, same as form_group: a peer whose view diverged
                # (suspicion, arc-boundary churn) may have self-elected and
                # already sent us a begin — joining it beats leading a
                # splinter group under the same key and stalling its round.
                if fut.done():
                    return self._group_from_begin(fut.result(), round_key)
                cand = self._pick_leader(alive)
                if cand == self.peer_id:
                    return await self._lead_direct(
                        round_key, expected, dead,
                        min_group=min_group, max_group=max_group,
                        settle=settle, deadline_mono=deadline,
                        round_budget_s=round_budget_s,
                    )
                addr = next(a for pid, a in alive if pid == cand)
                try:
                    ret, _ = await self.transport.call(
                        addr, "avg.join",
                        {"round_key": round_key, "peer": self.peer_id,
                         "addr": list(self.transport.addr)},
                        timeout=5.0, connect_timeout=3.0,
                    )
                except Exception as e:  # noqa: BLE001 — candidate down/refusing
                    dead.add(cand)
                    log.info("round %s: leader candidate %s unreachable "
                             "(%s), trying next", round_key, cand, errstr(e))
                    if time.monotonic() >= deadline:
                        return None
                    continue
                if not ret.get("ok", True):
                    # The candidate froze a round under this key moments ago
                    # (late) or its parked-join table is full (busy). When
                    # the cadence runs several rounds per rotation window,
                    # the NEXT round reuses this key and a re-sent join
                    # lands in its collector (or parks once the recent-lead
                    # TTL expires) — so retry at settle intervals until the
                    # join deadline instead of skipping: a genuine
                    # last-round straggler pays a few tiny RPCs and the
                    # same timeout the classic rendezvous would have
                    # burned, while skipping here would drop a whole round
                    # for every member that starts slightly ahead of its
                    # leader, every round.
                    if time.monotonic() >= deadline:
                        log.info("round %s: joined after the freeze, "
                                 "skipping", round_key)
                        return None
                    log.debug("round %s: candidate %s froze without us, "
                              "retrying", round_key, cand)
                    await asyncio.sleep(
                        min(max(settle, 0.05),
                            max(deadline - time.monotonic(), 0.0))
                    )
                    continue
                remaining = max(deadline - time.monotonic(), 2.0)
                begin = await asyncio.wait_for(fut, timeout=remaining)
                return self._group_from_begin(begin, round_key)
        except asyncio.TimeoutError:
            log.info("round %s: no begin from leader, skipping", round_key)
            return None
        finally:
            self._begin_futures.pop(round_key, None)

    async def _lead_direct(
        self,
        round_key: str,
        expected: List[Tuple[str, Addr]],
        dead: set,
        *,
        min_group: int,
        max_group: int,
        settle: float,
        deadline_mono: float,
        round_budget_s: Optional[float],
    ) -> Optional[Group]:
        """Leader half of form_group_direct: collect ``avg.join``s for
        ``round_key``, freeze, and run the ordinary ``_lead``."""
        col = self._join_collectors[round_key] = {
            "members": {}, "event": asyncio.Event(),
        }
        parked = self._parked_joins.pop(round_key, None)
        if parked is not None:
            ts, joiners = parked
            if time.monotonic() - ts <= self.PARKED_BEGIN_TTL:
                col["members"].update(joiners)
        expect_ids = {
            pid for pid, _ in expected
            if pid != self.peer_id and pid not in dead
        }
        try:
            t0 = last_join = time.monotonic()
            # Expected members get a real grace before the quiet-period
            # break can freeze them out: under load a member can easily be
            # a settle late, and freezing early costs it the whole round.
            # Only a dead-but-not-yet-expired expected peer pays this wait.
            grace = min(max(4.0 * settle, 1.0), deadline_mono - t0)
            while True:
                now = time.monotonic()
                joined = col["members"]
                if expect_ids <= joined.keys():
                    break  # everyone this view expects is here: lead NOW
                if len(joined) + 1 >= max_group:
                    break
                if (
                    len(joined) + 1 >= min_group
                    and now - last_join >= settle
                    and now - t0 >= grace
                ):
                    break  # formable, quiet, and stragglers had their grace
                if now >= deadline_mono:
                    if len(joined) + 1 >= min_group:
                        break
                    log.info("round %s: only %d peers joined, skipping",
                             round_key, len(joined) + 1)
                    return None
                col["event"].clear()
                # Formable already: wake at the settle boundary. Not yet:
                # wake at 1s ticks just to re-check the deadline.
                wait = min(
                    settle if len(joined) + 1 >= min_group else 1.0,
                    deadline_mono - now,
                )
                try:
                    await asyncio.wait_for(col["event"].wait(), timeout=wait)
                    last_join = time.monotonic()
                except asyncio.TimeoutError:
                    pass
            if len(col["members"]) + 1 < min_group:
                # Every expected member joined but the group is still
                # below the floor (an undersized scheduled group under a
                # divergent view — the caller's own deterministic check
                # normally skips these before dialing): min_group is a
                # robustness guarantee, never lead beneath it.
                log.info("round %s: only %d peers joined (< min_group %d), "
                         "skipping", round_key, len(col["members"]) + 1,
                         min_group)
                return None
        finally:
            self._join_collectors.pop(round_key, None)
        # Freeze. From here a late join is answered "too late" (bounded
        # map: TTL-swept on insert, same cap discipline as parked begins).
        now = time.monotonic()
        for k in [
            k for k, t in self._recent_leads.items()
            if now - t > self.PARKED_BEGIN_TTL
        ]:
            del self._recent_leads[k]
        while len(self._recent_leads) >= self.MAX_PARKED_BEGINS:
            self._recent_leads.pop(next(iter(self._recent_leads)))
        self._recent_leads[round_key] = now
        # Self leads, joiners fill the group in id order (the cap
        # can never drop the leader).
        others = sorted(col["members"].items())[: max(max_group - 1, 1)]
        members = [(self.peer_id, self.transport.addr)] + [
            (pid, tuple(addr)) for pid, addr in others
        ]
        return await self._lead(
            round_key, sorted(members),
            min_group=min_group, round_budget_s=round_budget_s,
        )

    def _pick_leader(self, members: List[Tuple[str, Addr]]) -> str:
        """Who should self-elect for this candidate set: among candidates
        the local ``lead_exclude`` predicate does NOT flag, the one with
        the fattest advertised uplink (``lead_weight``, bucketed to
        octaves so heartbeat-to-heartbeat EWMA jitter between two
        similar links cannot flap the choice), ties and no-advertisement
        falling back to the smallest peer_id; the plain smallest when
        every candidate is flagged (a round with a suspect leader beats
        no round). Purely local and advisory: peers with divergent
        suspicion or stale bandwidth views may elect different leaders,
        which yields two distinct epochs (never mixed tensors) and one
        underfilled round — the members' begin-wins rule resolves it."""
        best: Optional[Tuple[int, str]] = None
        for pid, _ in members:
            if self.lead_exclude is not None:
                try:
                    flagged = bool(self.lead_exclude(pid))
                except Exception:  # noqa: BLE001 — a policy bug must not kill rounds
                    flagged = False
                if flagged:
                    continue
            bucket = -1
            if self.lead_weight is not None:
                try:
                    bw = self.lead_weight(pid)
                except Exception:  # noqa: BLE001 — a policy bug must not kill rounds
                    bw = None
                if isinstance(bw, (int, float)) and bw > 0:
                    bucket = int(math.log2(float(bw)))
            if best is None or bucket > best[0] or (
                bucket == best[0] and pid < best[1]
            ):
                best = (bucket, pid)
        if best is not None:
            return best[1]
        return members[0][0]

    def _group_from_begin(self, begin: dict, round_key: str) -> Optional[Group]:
        members = [(pid, tuple(addr)) for pid, addr in begin["members"]]
        ids = [pid for pid, _ in members]
        if begin["epoch"] != self._epoch(round_key, ids, begin.get("nonce", "")):
            log.warning("round %s: epoch mismatch in begin, skipping", round_key)
            return None
        if self.peer_id not in ids:
            return None
        deadline = begin.get("deadline")
        budget = begin.get("budget")
        return Group(
            epoch=begin["epoch"],
            members=members,
            my_index=ids.index(self.peer_id),
            token=begin.get("token", ""),
            deadline=float(deadline) if isinstance(deadline, (int, float)) else None,
            budget=float(budget) if isinstance(budget, (int, float)) else None,
        )

    async def _lead(
        self,
        round_key: str,
        members: List[Tuple[str, Addr]],
        *,
        min_group: int = 2,
        round_budget_s: Optional[float] = None,
    ) -> Optional[Group]:
        import os as _os

        members = self._preexclude(members, min_group)
        # The protocol's leader slot IS members[0] (Group.leader_id; the
        # averagers take the leader path iff my_index == 0): rotate
        # ourselves to the front — we are the one leading — so a
        # _pick_leader winner that is not the plain smallest id still
        # produces a coherent group. The rest keep sorted (epoch) order,
        # which successor election depends on. The epoch hash is computed
        # over this exact order and travels in the begin, so every member
        # sees the same rotated list.
        members = (
            [m for m in members if m[0] == self.peer_id]
            + [m for m in members if m[0] != self.peer_id]
        )
        ids = [pid for pid, _ in members]
        # One urandom syscall covers the nonce and every member token
        # (one uuid4 per member was ~5 getrandom syscalls per round).
        rand = _os.urandom(4 + 16 * len(ids))
        nonce = rand[:4].hex()
        epoch = self._epoch(round_key, ids, nonce)
        # One secret per member, delivered only in that member's begin.
        tokens = {
            pid: rand[4 + 16 * i : 20 + 16 * i].hex()
            for i, pid in enumerate(ids)
        }
        # Deadline stamped BEFORE the begin fan-out: the fan-out itself
        # (up to 5s per unreachable member) spends round budget, and every
        # member must agree on the same absolute commit time.
        deadline = (
            self.clock() + float(round_budget_s) if round_budget_s else None
        )
        stamp_mono = time.monotonic()
        begin = {
            "round_key": round_key,
            "epoch": epoch,
            "nonce": nonce,
            "members": [[pid, list(addr)] for pid, addr in members],
        }
        if deadline is not None:
            begin["deadline"] = deadline
            begin["budget"] = float(round_budget_s)
        async def _begin_one(pid: str, addr: Addr) -> Optional[str]:
            try:
                # The begin fan-out spends round budget per member: bound
                # the dial separately (an unreachable member should cost its
                # connect timeout, not the full per-call budget). Members
                # already dialed this round (their join traffic shares the
                # pooled connection) skip the dial entirely.
                await self.transport.call(
                    addr, "avg.begin", {**begin, "token": tokens[pid]},
                    timeout=5.0, connect_timeout=3.0,
                )
                return pid
            except Exception as e:  # noqa: BLE001 — one corpse must not kill the round
                log.warning("round %s: member %s unreachable at begin: %s", round_key, pid, errstr(e))
                return None

        # Concurrent fan-out: one dead member costs its connect timeout in
        # PARALLEL with the live sends, not serially ahead of them (a
        # serial loop made every member behind a corpse start late).
        reached = [
            pid
            for pid in await asyncio.gather(
                *(
                    _begin_one(pid, addr)
                    for pid, addr in members
                    if pid != self.peer_id
                )
            )
            if pid is not None
        ]
        if not reached:
            return None
        return Group(
            epoch=epoch,
            members=members,
            my_index=ids.index(self.peer_id),
            token=tokens[self.peer_id],
            member_tokens=tokens,
            deadline=deadline,
            budget=float(round_budget_s) if deadline is not None else None,
            # The leader's budget counts from the STAMP, not from after the
            # begin fan-out — slow formation must keep shrinking its gather.
            formed_mono=stamp_mono,
        )

    def _preexclude(
        self, members: List[Tuple[str, Addr]], min_group: int
    ) -> List[Tuple[str, Addr]]:
        """Drop likely stragglers from a member list about to be frozen —
        never ourselves (we're leading) and never below ``min_group`` (a
        round with suspects beats no round: the deadline bounds the damage
        a straggler can do anyway)."""
        self.last_preexcluded = []
        if self.exclude is None:
            return members
        kept = list(members)
        for pid, addr in members:
            if len(kept) <= min_group:
                break
            if pid == self.peer_id:
                continue
            try:
                drop = bool(self.exclude(pid))
            except Exception:  # noqa: BLE001 — a policy bug must not kill rounds
                drop = False
            if drop:
                kept.remove((pid, addr))
                self.last_preexcluded.append(pid)
        if self.last_preexcluded:
            log.info(
                "round formation: pre-excluded likely stragglers %s",
                self.last_preexcluded,
            )
        return kept
