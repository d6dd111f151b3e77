"""Fault injection for swarm tests (SURVEY.md §5): a Transport that lies.

ChaosTransport wraps the real TCP transport with seeded, tunable faults on
the OUTBOUND path:

- ``drop_rate``   — a call fails with OSError before touching the network
                    (peer unreachable / mid-round death);
- ``delay_s``     — uniform random delay before each call (WAN jitter,
                    stragglers; drives timeout paths without sleeping tests
                    for real-world durations);
- ``corrupt_rate``— one payload byte is flipped AFTER the frame checksum is
                    computed, so the corruption is wire-level and must be
                    caught by the receiver's CRC — this validates the
                    integrity machinery itself, not just error handling.

Rates are attributes, so a test can flip a node from lossy to healthy
mid-scenario deterministically. Production code never imports this module.

Chaos CAMPAIGNS (the resilience layer's proving ground) want more than
constant rates: a scripted, reproducible SEQUENCE of faults — a latency
spike from t=10..20, a partition from t=30..40, a peer that is 10x slow for
the whole run. ``FaultSchedule`` is that script: a list of ``FaultEvent``
windows (relative to ``start()``), optionally scoped to destination
addresses, combined deterministically (same seed + same schedule = same
fault decisions) and attached to a ChaosTransport via ``schedule=``.
Window-scoped effects COMBINE with the constant attribute rates: delays
add, drop/corrupt probabilities take the max.
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import random
import time
from typing import Dict, Iterable, Optional, Sequence, Set, Tuple

from distributedvolunteercomputing_tpu_torch.swarm.transport import (
    Addr,
    Transport,
    _payload_len,
)
from distributedvolunteercomputing_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault window, relative to the schedule's start.

    ``kind``:
      - "delay"     — add ``magnitude`` seconds before every matching call
                      (latency spike / slow peer);
      - "drop"      — fail matching calls with probability ``magnitude``
                      (flaky link; 1.0 = hard partition);
      - "partition" — alias for drop at rate 1.0 (magnitude ignored);
      - "corrupt"   — flip one payload byte with probability ``magnitude``.

    ``targets``: destination addresses the event applies to (None = every
    destination) — a partition event scoped to two addrs cuts exactly that
    edge of the mesh.
    """

    t0: float
    t1: float
    kind: str
    magnitude: float = 0.0
    targets: Optional[frozenset] = None

    _KINDS = ("delay", "drop", "partition", "corrupt")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known: {self._KINDS}")
        if self.t1 < self.t0:
            raise ValueError(f"fault window ends before it starts: {self.t0}..{self.t1}")

    def applies(self, rel_t: float, addr: Addr) -> bool:
        if not (self.t0 <= rel_t < self.t1):
            return False
        return self.targets is None or tuple(addr) in self.targets


def fault_event(
    t0: float,
    t1: float,
    kind: str,
    magnitude: float = 0.0,
    targets: Optional[Iterable[Addr]] = None,
) -> FaultEvent:
    """Convenience constructor normalizing ``targets`` into a frozenset of
    addr tuples (the dataclass itself wants hashable, comparable state)."""
    return FaultEvent(
        t0=float(t0),
        t1=float(t1) if t1 is not None else float("inf"),
        kind=kind,
        magnitude=float(magnitude),
        targets=frozenset(tuple(a) for a in targets) if targets is not None else None,
    )


class FaultSchedule:
    """A deterministic, seedable script of fault windows.

    The schedule is inert until ``start()`` anchors its clock; every
    ChaosTransport sharing one schedule then sees the same timeline, and
    the drop/corrupt coin flips come from the schedule's OWN seeded rng —
    replaying the same schedule with the same traffic order reproduces the
    same faults (the property the chaos-campaign artifact rests on)."""

    def __init__(self, events: Sequence[FaultEvent], seed: int = 0):
        self.events = list(events)
        self.seed = seed
        self._rng = random.Random(seed)
        self._t_start: Optional[float] = None

    def start(self, now: Optional[float] = None) -> None:
        self._t_start = time.monotonic() if now is None else float(now)
        self._rng = random.Random(self.seed)  # restart = same coin flips

    @property
    def started(self) -> bool:
        return self._t_start is not None

    def rel_time(self, now: Optional[float] = None) -> float:
        if self._t_start is None:
            return float("-inf")  # not started: no event matches
        return (time.monotonic() if now is None else float(now)) - self._t_start

    def effects(self, addr: Addr, now: Optional[float] = None) -> Tuple[float, float, float]:
        """(delay_s, drop_rate, corrupt_rate) active for a call to ``addr``
        right now: delays ADD across overlapping windows, probabilities
        take the max (two half-broken links don't make a mended one)."""
        rel = self.rel_time(now)
        delay, drop, corrupt = 0.0, 0.0, 0.0
        for ev in self.events:
            if not ev.applies(rel, addr):
                continue
            if ev.kind == "delay":
                delay += ev.magnitude
            elif ev.kind == "drop":
                drop = max(drop, ev.magnitude)
            elif ev.kind == "partition":
                drop = 1.0
            elif ev.kind == "corrupt":
                corrupt = max(corrupt, ev.magnitude)
        return delay, drop, corrupt

    def coin(self, p: float) -> bool:
        """One seeded fault decision (shared rng -> reproducible runs)."""
        return p > 0 and self._rng.random() < p


# Scheduled corruption travels from the per-CALL decision to the per-FRAME
# write through the task context (each call's message write runs inside the
# call's own wait_for task, which snapshots this at creation) — concurrent
# calls multiplexed onto ONE pooled connection cannot steal each other's
# corruption.
_corrupt_this_call: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "chaos_corrupt_this_call", default=False
)


class ChaosTransport(Transport):
    # Process-wide blackholed peer pairs, shared by every ChaosTransport in
    # the process: entering (a, b) here makes calls between those two
    # addresses fail like a severed link, in BOTH directions provided both
    # endpoints run ChaosTransports (each side refuses its own outbound
    # half). Class-level on purpose — a partition is a property of the
    # network between two nodes, not of one endpoint — so a scenario script
    # can cut an edge with one call on any instance. Tests/campaigns must
    # ``heal()`` in teardown. Composes with the constant rates, the
    # corrupt-offset hook, and any attached FaultSchedule: the partition
    # check runs first (a cut link delivers nothing to delay or corrupt).
    _partitions: Set[frozenset] = set()
    # Process-wide per-peer-pair LINK MODEL (set_link): propagation latency
    # plus serialization bandwidth — and, optionally, a heavy-tailed
    # per-call jitter distribution — for the edge between two addresses.
    # Class-level for the same reason as _partitions — a link is a property
    # of the path between two nodes. Applied on the OUTBOUND half at each
    # endpoint (delay = latency + request_payload/bw before the call), so a
    # WAN scenario models what the hierarchical schedule cares about: a
    # member's bulk contribution push crossing a thin/far edge pays for it
    # in wall time. Composes with everything above — partition first (a cut
    # link delivers nothing), then the link delay, then rates/schedules.
    # Tests/campaigns must ``clear_links()`` in teardown.
    _links: Dict[frozenset, Tuple[float, Optional[float], Optional[dict]]] = {}
    # Process-wide STAR-isolated peer addresses (isolate/restore): every
    # link touching one of these is cut, in both directions, wherever a
    # ChaosTransport runs either endpoint. The shard-kill primitive — a
    # holder "dies" to the whole zone with one call while its process
    # stays inspectable. Class-level like _partitions; tests/campaigns
    # must ``restore_all()`` in teardown. Checked inside _partitioned, so
    # it composes everywhere partitions do.
    _isolated: Set[Addr] = set()

    # Known heavy-tailed jitter shapes for set_link(jitter=...).
    _JITTER_DISTS = ("pareto", "lognormal")

    def __init__(
        self,
        *args,
        drop_rate: float = 0.0,
        delay_s: float = 0.0,
        corrupt_rate: float = 0.0,
        corrupt_at_frac: Optional[float] = None,
        seed: int = 0,
        schedule: Optional[FaultSchedule] = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.drop_rate = drop_rate
        self.delay_s = delay_s
        self.corrupt_rate = corrupt_rate
        # Deterministic corruption PLACEMENT: flip the byte at this fraction
        # of the payload (0.0 = first byte, ~1.0 = last) instead of a seeded
        # random offset. On the chunked wire that pins which CHUNK dies —
        # the streaming-aggregation tests use it to control exactly how many
        # tiles a contribution seals before its stream aborts.
        self.corrupt_at_frac = corrupt_at_frac
        self.schedule = schedule
        self._chaos = random.Random(seed)

    # Overrides the base transport's fault-injection hook — consulted once
    # per outbound MESSAGE (client request or server response) with the
    # total payload size. Returning an offset makes the transport flip that
    # payload byte AFTER computing the frame/chunk checksums, so the
    # corruption is wire-level and must be caught by the receiver's CRC;
    # on the chunked path the flip lands inside exactly one chunk, whose
    # per-chunk CRC is what fails.
    def _chaos_corrupt_offset(self, ftype: int, total: int):  # type: ignore[override]
        if total <= 0:
            return None
        if _corrupt_this_call.get() or (
            self.corrupt_rate and self._chaos.random() < self.corrupt_rate
        ):
            if self.corrupt_at_frac is not None:
                pos = min(int(self.corrupt_at_frac * total), total - 1)
            else:
                pos = self._chaos.randrange(total)
            log.debug("chaos: corrupting payload byte %d", pos)
            return pos
        return None

    # -- scriptable partitions --------------------------------------------

    @staticmethod
    def _pair(peer_a, peer_b) -> frozenset:
        return frozenset(
            ((str(peer_a[0]), int(peer_a[1])), (str(peer_b[0]), int(peer_b[1])))
        )

    def partition(self, peer_a, peer_b) -> None:
        """Blackhole traffic between two peer addresses: every call either
        of them makes to the other fails with OSError before touching the
        network (both endpoints must run ChaosTransports for both
        directions to be cut). Unlike a scheduled ``partition`` FaultEvent
        this is imperative — a scenario script cuts and heals edges at
        exact protocol points instead of wall-clock windows."""
        ChaosTransport._partitions.add(self._pair(peer_a, peer_b))
        log.debug("chaos: partitioned %s <-> %s", tuple(peer_a), tuple(peer_b))

    def heal(self, peer_a=None, peer_b=None) -> None:
        """Remove one blackholed pair; with a single peer, every partition
        touching that peer; with no arguments, every partition (scenario
        teardown)."""
        if peer_a is None:
            ChaosTransport._partitions.clear()
        elif peer_b is None:
            pa = (str(peer_a[0]), int(peer_a[1]))
            ChaosTransport._partitions = {
                p for p in ChaosTransport._partitions if pa not in p
            }
        else:
            ChaosTransport._partitions.discard(self._pair(peer_a, peer_b))

    def _partitioned(self, addr: Addr) -> bool:
        me = (str(self.addr[0]), int(self.addr[1]))
        a = (str(addr[0]), int(addr[1]))
        if me in ChaosTransport._isolated or a in ChaosTransport._isolated:
            return True
        if not ChaosTransport._partitions:
            return False
        return self._pair(self.addr, addr) in ChaosTransport._partitions

    # -- star isolation (shard-holder kill at the network level) ------------

    def isolate(self, peer=None) -> None:
        """Cut EVERY link touching one peer address (self when None) — the
        network half of a shard-holder SIGKILL: the process lives (its
        state is inspectable by the test) but the zone sees a silent
        death, must re-shard around it, and its own late serves fail
        exactly like a dead socket's would. A star partition, not N
        ``partition`` calls: joins/leaves during the isolation window are
        covered too."""
        addr = self.addr if peer is None else peer
        ChaosTransport._isolated.add((str(addr[0]), int(addr[1])))
        log.debug("chaos: isolated %s", tuple(addr))

    def restore(self, peer=None) -> None:
        """Lift one peer's star isolation (self when None); with
        ``peer=...`` absent AND no self addr, scenario teardown clears
        via ``restore_all``."""
        addr = self.addr if peer is None else peer
        ChaosTransport._isolated.discard((str(addr[0]), int(addr[1])))

    @staticmethod
    def restore_all() -> None:
        ChaosTransport._isolated.clear()

    # -- per-pair link model ------------------------------------------------

    def set_link(
        self,
        peer_a,
        peer_b,
        latency_s: float = 0.0,
        bw_bps: Optional[float] = None,
        jitter: Optional[dict] = None,
    ) -> None:
        """Model the link between two peer addresses: every call either
        endpoint makes to the other first pays ``latency_s`` plus the
        request payload's serialization time at ``bw_bps`` bytes/s (None =
        unconstrained). The WAN building block for hierarchical-scheduling
        scenarios — a two-zone swarm is a few fat intra-zone links plus
        thin, far cross-zone ones. Both endpoints must run ChaosTransports
        for both directions to be modeled; response payloads ride the
        receiver's own outbound model when it calls back. Re-setting a
        pair replaces its link; composes with ``partition``/``heal``,
        constant rates, ``corrupt_at_frac``, and fault schedules.

        ``jitter`` adds a HEAVY-TAILED per-call delay on top of the base
        latency — the tail-latency model tail-optimal benches need (most
        calls near the base, a fat tail of 10-100x outliers), replacing
        hand-rolled x10 stragglers:

        - ``{"dist": "pareto", "scale": s, "alpha": a}`` — extra delay
          ``s * (X - 1)`` with X ~ Pareto(alpha); alpha in (1, 2] is the
          classic heavy WAN tail (smaller alpha = fatter). Median extra
          ~``s * (2^(1/a) - 1)``, unbounded tail.
        - ``{"dist": "lognormal", "scale": s, "sigma": g}`` — extra delay
          ``s * LogNormal(0, g)``; median exactly ``s``.
        - optional ``"cap"``: ceiling (seconds) on the extra delay — real
          stacks retransmit/abort rather than stall a flow for minutes,
          and an uncapped alpha~1 draw otherwise turns one unlucky
          control RPC into a process-scale stall.
        - optional ``"min_bytes"``: draw the jitter only for calls whose
          request payload is at least this size — the bulk-flow tail
          model (a straggler's *data* transfers stall; its meta-sized
          control RPCs ride the base latency), which is the tail the
          hedged-recovery pipeline targets.

        Draws come from this transport's own SEEDED rng, so a campaign
        replay with the same traffic order reproduces the same tail.

        Fidelity limit (same as the PR-8 note on the base model): the
        delay — jitter included — is applied BEFORE the call's bytes are
        written, so it shapes WALL TIME but not the receiver's measured
        arrival rate — the production bandwidth-measurement path (the
        read-timed bw_down EWMA and the rx_bps uplink echo) still
        observes localhost speed over a modeled thin link, and a jittered
        call stalls WHOLE (one draw per call, not per packet — a fresh
        hedged request re-draws, which is exactly the tail-dodging effect
        hedging exploits, but intra-payload pacing is not modeled).
        Scenarios that need bandwidth ADVERTISEMENTS under a modeled WAN
        inject them directly via membership ``extra_info``
        (hierarchy_bench does); pacing the actual socket writes is a
        transport change, not a wrapper's."""
        if latency_s < 0:
            raise ValueError(f"latency_s must be >= 0, got {latency_s}")
        if bw_bps is not None and bw_bps <= 0:
            raise ValueError(f"bw_bps must be > 0 (or None), got {bw_bps}")
        if jitter is not None:
            dist = jitter.get("dist")
            if dist not in self._JITTER_DISTS:
                raise ValueError(
                    f"unknown jitter dist {dist!r}; known: {self._JITTER_DISTS}"
                )
            if float(jitter.get("scale", 0.0)) <= 0:
                raise ValueError("jitter needs scale > 0")
            if dist == "pareto" and float(jitter.get("alpha", 0.0)) <= 0:
                raise ValueError("pareto jitter needs alpha > 0")
            if dist == "lognormal" and float(jitter.get("sigma", 0.0)) <= 0:
                raise ValueError("lognormal jitter needs sigma > 0")
            if jitter.get("cap") is not None and float(jitter["cap"]) < 0:
                raise ValueError("jitter cap must be >= 0")
            jitter = dict(jitter)
        ChaosTransport._links[self._pair(peer_a, peer_b)] = (
            float(latency_s),
            float(bw_bps) if bw_bps is not None else None,
            jitter,
        )

    def clear_links(self, peer_a=None, peer_b=None) -> None:
        """Remove one modeled link; with a single peer, every link touching
        that peer; with no arguments, every link (scenario teardown)."""
        if peer_a is None:
            ChaosTransport._links.clear()
        elif peer_b is None:
            pa = (str(peer_a[0]), int(peer_a[1]))
            ChaosTransport._links = {
                p: v for p, v in ChaosTransport._links.items() if pa not in p
            }
        else:
            ChaosTransport._links.pop(self._pair(peer_a, peer_b), None)

    def _link_delay(self, addr: Addr, n_bytes: int) -> float:
        link = ChaosTransport._links.get(self._pair(self.addr, addr))
        if link is None:
            return 0.0
        latency, bw, jitter = link
        delay = latency + (n_bytes / bw if bw else 0.0)
        if jitter is not None and n_bytes < int(jitter.get("min_bytes") or 0):
            jitter = None
        if jitter is not None:
            # One seeded draw per CALL: most calls ride near the base
            # latency, a heavy tail stalls whole — and a hedged re-request
            # is a fresh call with a fresh draw.
            scale = float(jitter["scale"])
            if jitter["dist"] == "pareto":
                extra = scale * (
                    self._chaos.paretovariate(float(jitter["alpha"])) - 1.0
                )
            else:  # lognormal
                extra = scale * self._chaos.lognormvariate(
                    0.0, float(jitter["sigma"])
                )
            cap = jitter.get("cap")
            if cap is not None:
                extra = min(extra, float(cap))
            delay += extra
        return delay

    async def call(
        self,
        addr: Addr,
        method: str,
        args: Optional[dict] = None,
        payload=b"",
        timeout: float = 30.0,
        **kw,
    ):
        if self._partitioned((str(addr[0]), int(addr[1]))):
            raise OSError(
                f"chaos: partitioned link {self.addr} <-> {tuple(addr)} "
                f"(call {method} dropped)"
            )
        if ChaosTransport._links:
            link_delay = self._link_delay(
                (str(addr[0]), int(addr[1])), _payload_len(payload)
            )
            if link_delay > 0:
                # Deterministic (no jitter), like scheduled delays: a link
                # model should reproduce exactly across campaign replays.
                await asyncio.sleep(link_delay)
        if self.drop_rate and self._chaos.random() < self.drop_rate:
            raise OSError(f"chaos: dropped call {method} to {addr}")
        if self.delay_s:
            await asyncio.sleep(self._chaos.random() * self.delay_s)
        if self.schedule is not None and self.schedule.started:
            delay, drop, corrupt = self.schedule.effects(addr)
            if self.schedule.coin(drop):
                raise OSError(
                    f"chaos schedule: dropped call {method} to {addr} "
                    f"(t={self.schedule.rel_time():.1f}s)"
                )
            if delay > 0:
                # Deterministic magnitude (no jitter): a scheduled latency
                # spike should reproduce exactly across campaign replays.
                await asyncio.sleep(delay)
            if self.schedule.coin(corrupt):
                # Task-local, not a transport-level flag: Transport.call runs
                # the request write inside the call's own wait_for task,
                # which COPIES this context at creation — so under
                # concurrent pushes (asyncio.gather) sharing one pooled
                # connection the corruption lands on exactly the scheduled
                # call's request frame, never on whichever unrelated frame
                # (or server-half response) writes next.
                tok = _corrupt_this_call.set(True)
                try:
                    return await super().call(
                        addr, method, args=args, payload=payload, timeout=timeout, **kw
                    )
                finally:
                    _corrupt_this_call.reset(tok)
        return await super().call(
            addr, method, args=args, payload=payload, timeout=timeout, **kw
        )
