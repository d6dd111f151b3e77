"""Peer-pull state synchronisation: join the swarm at the swarm's step.

The capability that makes churn recovery real (SURVEY.md §5
checkpoint/resume): a volunteer that (re)joins — fresh process, restored
preemption, long absence — pulls the freshest params straight from a live
peer instead of training from its cold init and poisoning the next averaging
round with stale weights (the hivemind ``load_state_from_peers`` role, done
the swarm's way: DHT announcement + transport RPCs).

Protocol:
- every provider periodically announces ``state/<namespace>`` in the DHT
  with its current step (subkey = peer_id, TTL'd like heartbeats);
- a puller reads the key, targets the highest announced step above its own,
  and fetches the flattened f32 payload in CHUNKS (``state.fetch`` with
  offset/length). The first chunk opens a session: the provider serializes
  its tree ONCE and pins the buffer for the session, so a multi-chunk pull
  is a consistent snapshot even while the provider keeps training. Every
  chunk rides the transport's CRC-checked framing, so a flipped byte in any
  chunk fails that chunk, not the whole transfer;
- the puller validates the total length against ITS OWN schema before
  adopting (a wrong-model payload can't be loaded) and runs a sanity guard
  (finite, magnitude-bounded) so a garbage provider can't hand a rejoiner
  NaN params; it walks down the candidate list on failure.

What the payload is: the SYNC SUBTREE, not necessarily the full params. The
volunteer wires the model bundle's ``avg_select``/``avg_merge`` through this
service, so a LoRA model ships only its adapters (~1000x less than the
frozen base, which every volunteer reconstructs bit-identically from the
task-constant ``init_seed``).

Trust model (byzantine mode): a pulled state comes from ONE provider; the
sanity guard rejects gross poison (NaN/Inf/absurd magnitudes) but a
malicious provider could serve subtly-wrong values. This is accepted under
the HONEST-MAJORITY assumption the byzantine averager itself rests on: the
rejoiner's very next averaging round contracts it toward the robust
aggregate of the group, so a poisoned pull survives at most one averaging
interval and the poisoner's own round contributions are trimmed by the
estimator. (Cross-checking a second provider cannot distinguish malice from
normal between-round drift — two honest peers at the same step legitimately
differ by their local steps — so it would reject honest providers.)

Optimizer moments are NOT transferred: a pulled state resumes with a cold
optimizer at the correct step (the standard trade — moments are 2x params of
extra WAN bytes for marginal benefit after averaging rounds resync anyway).
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.transport import Addr, RPCError, Transport
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger
from distributedvolunteercomputing_tpu_torch.utils.pytree import (
    flatten_to_buffer,
    tree_specs,
    unflatten_from_buffer,
)

log = get_logger(__name__)

# (step, sync_subtree) supplier — reads the live trainer state.
StateProvider = Callable[[], Tuple[int, Any]]

# Per-chunk payload bytes. Well under the transport's frame guard; big
# enough that a GPT-2-small full tree (~500 MB f32) is ~8 chunks.
DEFAULT_CHUNK_BYTES = 64 * 1024 * 1024


class _Session:
    __slots__ = ("buf", "step", "t0", "pending")

    def __init__(self):
        self.buf = b""
        self.step = 0
        self.t0 = time.monotonic()
        self.pending = True  # reserved (counts toward the cap) but not filled


class StateSyncService:
    # Concurrent pinned serializations; each holds one payload-sized buffer.
    MAX_SESSIONS = 2
    SESSION_TTL = 180.0
    # Sanity bound for adopted values: trained params live in O(1); 1e4
    # already means something is deeply wrong (guards garbage providers).
    MAX_ABS_VALUE = 1e4

    def __init__(
        self,
        transport: Transport,
        dht: DHTNode,
        peer_id: str,
        namespace: str,
        announce_ttl: float = 30.0,
        fetch_timeout: float = 60.0,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        wire: str = "f32",
    ):
        # Wire codec for SERVED state (this side's provider role): bf16
        # halves and q8 quarters the rejoin transfer, at the same tolerance
        # the averaging wire already accepts. The puller decodes whatever
        # the provider's fetch meta declares, so mixed-wire swarms still
        # sync. (topk is grads-only and meaningless for a params snapshot.)
        if wire not in ("f32", "bf16", "q8"):
            raise ValueError(f"unknown state-sync wire {wire!r}")
        self.transport = transport
        self.dht = dht
        self.peer_id = peer_id
        self.namespace = namespace
        self.announce_ttl = announce_ttl
        self.fetch_timeout = fetch_timeout
        self.chunk_bytes = int(chunk_bytes)
        self.wire = wire
        self._provider: Optional[StateProvider] = None
        self._sessions: Dict[str, _Session] = {}
        # Extra fields merged into every announce record (zone-sharded
        # volunteers ride their shard assignment here, so a rejoiner can
        # tell full-tree providers from shard-holders before dialing one
        # that only serves 1/K of what it needs).
        self.extra_announce: Optional[Callable[[], dict]] = None
        transport.register("state.fetch", self._rpc_fetch)

    @property
    def key(self) -> str:
        return f"state/{self.namespace}"

    def set_provider(self, provider: StateProvider) -> None:
        self._provider = provider

    # -- provider side -----------------------------------------------------

    async def announce(self) -> None:
        """Publish (addr, step) under the state key; call periodically."""
        if self._provider is None:
            return
        step, _ = self._provider()
        rec = {"addr": list(self.transport.addr), "step": int(step)}
        if self.extra_announce is not None:
            try:
                rec.update(self.extra_announce() or {})
            except Exception as e:  # noqa: BLE001 — announce must not die on a gauge
                log.debug("extra_announce failed: %s", errstr(e))
        await self.dht.store(
            self.key,
            rec,
            subkey=self.peer_id,
            ttl=self.announce_ttl,
        )

    def _sweep_sessions(self) -> None:
        now = time.monotonic()
        for sid in [s for s, st in self._sessions.items() if now - st.t0 > self.SESSION_TTL]:
            del self._sessions[sid]

    async def _rpc_fetch(self, args: dict, payload: bytes):
        """Chunked fetch. args: {session, offset, length}. offset 0 (or a
        new session id) serializes and PINS the provider's current tree, so
        later chunks come from the same snapshot; the final chunk (or an
        unconditional expiry timer) releases it."""
        if self._provider is None:
            raise RPCError("no state to serve yet")
        self._sweep_sessions()
        session = str(args.get("session", "")) or uuid.uuid4().hex
        offset = int(args.get("offset", 0))
        length = int(args.get("length", 0)) or self.chunk_bytes
        st = self._sessions.get(session)
        if st is not None and st.pending:
            # Another connection's open is mid-serialization; this session id
            # is not usable by anyone else.
            raise RPCError("state session still opening")
        if st is None:
            if offset != 0:
                raise RPCError("unknown state session (expired or never opened)")
            if len(self._sessions) >= self.MAX_SESSIONS:
                raise RPCError("state session cap reached; retry shortly")
            # Reserve BEFORE the await: concurrent opens each hold a slot, so
            # N simultaneous rejoiners can never pin more than MAX_SESSIONS
            # payload-sized buffers (the cap-check-then-insert race).
            st = self._sessions[session] = _Session()
            try:
                step, tree = self._provider()

                def _serialize() -> bytes:
                    buf, _, _ = flatten_to_buffer(tree)
                    if self.wire == "bf16":
                        return native.f32_to_bf16(buf).tobytes()
                    if self.wire == "q8":
                        return native.q8_encode(buf)
                    return buf.tobytes()

                # Param-sized flatten+copy off the event loop: serving state
                # must not stall heartbeats/averaging RPCs for a big memcpy.
                st.buf = await asyncio.to_thread(_serialize)
                st.step = int(step)
                st.pending = False
            except BaseException:
                self._sessions.pop(session, None)
                raise
            # Unconditional expiry: a puller that dies after chunk 0 must not
            # pin this buffer until the NEXT fetch RPC happens to sweep — two
            # such aborts would block all state serving for SESSION_TTL.
            asyncio.get_running_loop().call_later(
                self.SESSION_TTL, self._sessions.pop, session, None
            )
        chunk = st.buf[offset : offset + length]
        done = offset + len(chunk) >= len(st.buf)
        if done:
            self._sessions.pop(session, None)
        return (
            {
                "step": st.step,
                "session": session,
                "total": len(st.buf),
                "offset": offset,
                "done": done,
                "wire": self.wire,
            },
            chunk,
        )

    # -- puller side -------------------------------------------------------

    async def _candidates(self, min_step: int) -> List[Tuple[int, str, Addr]]:
        records = await self.dht.get(self.key)
        out = []
        for pid, rec in records.items():
            if pid == self.peer_id or not isinstance(rec, dict):
                continue
            try:
                step = int(rec["step"])
                host, port = rec["addr"]
                addr = (str(host), int(port))
            except (KeyError, TypeError, ValueError):
                continue
            if step > min_step:
                out.append((step, pid, addr))
        out.sort(reverse=True)  # freshest first
        return out

    @staticmethod
    def _expected_bytes(wire: str, n_elems: int) -> int:
        """Exact coded size of an n_elems f32 tree under each wire. Raises
        on unknown wires — silently treating a foreign codec as raw f32
        would let same-sized garbage through the size check."""
        if wire == "bf16":
            return 2 * n_elems
        if wire == "q8":
            return native.q8_coded_size(n_elems)
        if wire == "f32":
            return 4 * n_elems
        raise RPCError(f"provider declared unknown wire {wire!r}")

    async def _fetch_all(self, addr: Addr, n_elems: int) -> Tuple[int, str, bytearray]:
        """Pull the full buffer from one provider in chunks; returns
        (provider_step, wire, payload). Raises on any failure — caller
        moves on. The provider's first response declares its wire codec;
        the total must match that codec's exact size for our schema.
        Chunks write straight into one preallocated buffer: collecting
        parts and joining would hold ~2x the payload at the join."""
        out: Optional[bytearray] = None
        wire = "f32"
        session = ""
        offset = 0
        while True:
            # Every session chunk rides ONE pooled connection (the transport
            # chunk-frames each 64 MB RPC payload into wire chunks with
            # per-chunk CRCs); the dial is bounded separately so a dead
            # provider costs seconds, not the 60 s transfer budget.
            ret, chunk = await self.transport.call(
                addr,
                "state.fetch",
                {"peer": self.peer_id, "session": session, "offset": offset,
                 "length": self.chunk_bytes},
                timeout=self.fetch_timeout,
                connect_timeout=5.0,
                # Bulk transfer: must not poison the control-plane latency
                # EWMA the failure detector suspects on.
                record_latency=False,
            )
            total = int(ret["total"])
            if out is None:  # first response: wire + size validation
                wire = str(ret.get("wire", "f32"))
                expect_bytes = self._expected_bytes(wire, n_elems)
                if total != expect_bytes:
                    raise RPCError(
                        f"provider buffer {total}B != local schema "
                        f"{expect_bytes}B (wire={wire})"
                    )
                out = bytearray(total)
            elif total != len(out):
                raise RPCError("provider total changed mid-session")
            if int(ret["offset"]) != offset or not chunk or offset + len(chunk) > total:
                raise RPCError("chunk sequencing error")
            out[offset : offset + len(chunk)] = chunk
            offset += len(chunk)
            session = str(ret["session"])
            if ret.get("done"):
                if offset != total:
                    raise RPCError("provider finished short of its own total")
                break
        return int(ret["step"]), wire, out

    def _sane(self, buf: np.ndarray) -> bool:
        """Finite and magnitude-bounded, allocation-free: NaN propagates
        through min/max and fails both comparisons; +/-Inf fails the bound.
        (np.isfinite().all() + np.abs() would allocate ~1.25x the payload on
        the memory-tight rejoin path.)"""
        if buf.size == 0:
            return True
        lo = float(np.min(buf))
        hi = float(np.max(buf))
        return -self.MAX_ABS_VALUE < lo <= hi < self.MAX_ABS_VALUE

    async def pull(
        self, local_tree: Any, local_step: int, min_lead: int = 1
    ) -> Optional[Tuple[int, Any]]:
        """Fetch the sync subtree from the freshest peer at least
        ``min_lead`` steps ahead; returns (step, tree) or None (nobody
        ahead / all fetches failed — both normal, the caller trains on)."""
        # Schema only — no param-sized buffer materialized on the pull side.
        specs, treedef = tree_specs(local_tree)
        expect = int(sum(s.size for s in specs))
        for step, pid, addr in await self._candidates(local_step + min_lead - 1):
            try:
                got_step, wire, payload = await self._fetch_all(addr, expect)
                if wire == "bf16":
                    buf = native.bf16_to_f32(np.frombuffer(payload, np.uint16))
                elif wire == "q8":
                    buf = native.q8_decode(payload)  # accepts the bytearray; no copy
                else:
                    buf = np.frombuffer(payload, np.float32)
                if buf.size != expect:
                    raise RPCError(f"decoded {buf.size} elems != schema {expect}")
                if not self._sane(buf):
                    log.warning(
                        "state pull from %s failed the sanity guard "
                        "(non-finite or absurd values); trying next", pid,
                    )
                    continue
                log.info(
                    "pulled state at step %d from %s (%d bytes, %d-byte chunks)",
                    got_step, pid, len(payload), self.chunk_bytes,
                )
                # No defensive copy: unflatten's astype copies each chunk out
                # of the read-only frombuffer view.
                return got_step, unflatten_from_buffer(buf, specs, treedef, device=None)
            except (RPCError, OSError, asyncio.TimeoutError, ValueError) as e:
                log.info("state pull from %s failed (%s); trying next", pid, errstr(e))
        return None
