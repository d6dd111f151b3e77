"""The port's copies of the JAX package's host modules stay copies.

Each module below is the reference's text with the import root rewritten
(``distributedvolunteercomputing_tpu`` -> ``distributedvolunteercomputing_tpu_torch``
where it names the package, on a word boundary). Any other difference is
listed in ``ALLOWED`` with its reason: the reference's text of the change is
replaced with the port's, each exactly once, and then the two must be equal.
A drift in either package fails here, so a fix made in one is carried to the
other on purpose.
"""

import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "distributedvolunteercomputing_tpu"
PORT = REPO / "distributedvolunteercomputing_tpu_torch"
ROOT = re.compile(r"\bdistributedvolunteercomputing_tpu(?=[.\s])")

COPIED = [
    "native/__init__.py",
    "native/dvc_native.cpp",
    "ops/robust.py",
    "swarm/telemetry.py",
    "swarm/health.py",
    "swarm/watchdog.py",
    "swarm/transport.py",
    "swarm/dht.py",
    "swarm/membership.py",
    "swarm/matchmaking.py",
    "swarm/agg_stream.py",
    "swarm/averager.py",
    "utils/asyncio_debug.py",
    "swarm/controller.py",
    "swarm/control_plane.py",
    "swarm/coordinator.py",
    "swarm/state_sync.py",
    "swarm/failure_detector.py",
    "swarm/resilience.py",
    "swarm/clocksync.py",
    "swarm/chaos.py",
    "swarm/powersgd.py",
    "swarm/sharding.py",
]

# module -> [(reason, reference text, port text)]
ALLOWED = {
    "swarm/transport.py": [
        (
            "close fix: on Python 3.12 Server.wait_closed() waits for every inbound "
            "connection, which only the force-close further down ends, so the "
            "reference's close() hangs while a peer's pooled connection is open. "
            "The port closes the listener first and awaits it last.",
            """        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
""",
            """        server, self._server = self._server, None
        if server is not None:
            # Stop accepting now; wait_closed() comes last: on Python 3.12
            # it waits for every inbound connection, which only the
            # force-close below ends.
            server.close()
""",
        ),
        (
            "close fix (second half): the listener's wait_closed() after the "
            "inbound writers are closed and the tasks gathered",
            """        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    # -- counters""",
            """        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        if server is not None:
            await server.wait_closed()

    # -- counters""",
        ),
    ],
    "swarm/averager.py": [
        (
            "feed race fix (1/5): a contribute handler that folds an inline push "
            "into the armed stream on a worker thread marks the key as feeding; "
            "without it the leader can count the key, freeze the stream and "
            "refuse the feed, dropping an on-time contribution (seen as a "
            "'round skipped by leader (too few contributions)' in ~1 of 30 "
            "two-volunteer rounds)",
            """        self.hedges_issued = 0
        self.t0 = time.monotonic()
""",
            """        self.hedges_issued = 0
        self.t0 = time.monotonic()
        # (peer, token) keys whose dense buffer a contribute handler is still
        # folding into ``stream`` on a worker thread. They do not count
        # toward ``full``: a commit that froze the stream first would refuse
        # the feed and drop an on-time contribution as late.
        self.feeding: set = set()
""",
        ),
        (
            "feed race fix (2/5): the handler's feed marks its key",
            """                fed = await asyncio.to_thread(st.stream.add_dense, key[0], w, buf)
""",
            """                st.feeding.add(key)
                try:
                    fed = await asyncio.to_thread(st.stream.add_dense, key[0], w, buf)
                finally:
                    st.feeding.discard(key)
""",
        ),
        (
            "feed race fix (3/5): the stream-done path counts settled keys only",
            """            if st.expected and {
                p for p, t in st.contribs
                if st.tokens is None or st.tokens.get(p) == t
            } >= st.expected:""",
            """            if st.expected and {
                p for p, t in st.contribs
                if (st.tokens is None or st.tokens.get(p) == t) and (p, t) not in st.feeding
            } >= st.expected:""",
        ),
        (
            "feed race fix (4/5): the handler's own check counts settled keys only",
            """            valid = {
                p for p, t in st.contribs
                if st.tokens is None or st.tokens.get(p) == t
            }""",
            """            valid = {
                p for p, t in st.contribs
                if (st.tokens is None or st.tokens.get(p) == t) and (p, t) not in st.feeding
            }""",
        ),
        (
            "feed race fix (5/5): the leader's check after its own feed counts "
            "settled keys only",
            """        if {p for p, _ in st.contribs} >= st.expected:
""",
            """        if {p for p, t in st.contribs if (p, t) not in st.feeding} >= st.expected:
""",
        ),
        (
            "recovery fetch fix (1/2): a sync.fetch that reaches a recovery "
            "successor before it arms finds the followers' parked round state "
            "at generation 0 and was refused as stale, so those followers "
            "failed a round the successor committed (the port's chaos soak: "
            "0.0-0.6 of kill rounds recovered on the bf16 wire against the "
            "95% bar). An unarmed round skips the fence, as the contribute "
            "handler's already does",
            """        if self._fence_of(args) != st.gen:
            # Epoch fencing, BEFORE parking on result_ready: a revived
            # ex-leader (this node, if it was partitioned and healed) must
            # refuse to serve its stale generation-(st.gen) result to a
            # member that has moved on — and refuse fast, not after the
            # gather-deadline wait below.
            self._note_fence_rejected("sync.fetch", args, have_gen=st.gen)
""",
            """        if st.tokens is not None and self._fence_of(args) != st.gen:
            # Epoch fencing, BEFORE parking on result_ready: a revived
            # ex-leader (this node, if it was partitioned and healed) must
            # refuse to serve its stale generation-(st.gen) result to a
            # member that has moved on — and refuse fast, not after the
            # gather-deadline wait below. Unarmed (parked) rounds skip the
            # check, as in the contribute handler: a recovery successor
            # parks its followers' pushes and fetches before it arms at
            # their generation.
            self._note_fence_rejected("sync.fetch", args, have_gen=st.gen)
""",
        ),
        (
            "recovery fetch fix (2/2): the fence is checked again once the "
            "parked round has armed and its result is ready",
            """            timeout=self.gather_timeout + self.AGGREGATION_HEADROOM,
        )
        if st.result is None:
            raise RPCError("round skipped by leader (too few contributions)")
""",
            """            timeout=self.gather_timeout + self.AGGREGATION_HEADROOM,
        )
        if self._fence_of(args) != st.gen:
            # A fetch parked on an unarmed round: its generation is known now.
            self._note_fence_rejected("sync.fetch", args, have_gen=st.gen)
            raise RPCError(
                f"fencing mismatch: round epoch is at generation {st.gen}, "
                f"fetch asks for {self._fence_of(args)} (leader deposed?)"
            )
        if st.result is None:
            raise RPCError("round skipped by leader (too few contributions)")
""",
        ),
        (
            "re-encode fix: a contributor's refetched ranges, redundancy "
            "shares and XOR sidecars were encoded by the host's "
            "native.f32_to_bf16 while its push on a device codec is K4's: the "
            "two differ on NaN payload bits, so a hedged range was not the "
            "bytes the push carried, and the refetch bypassed K4. On a device "
            "codec the re-encode is the codec's own",
            """        encoder (agg_stream.encode_wire_elems) guards that invariant.\"\"\"
        return encode_wire_elems(self.wire, buf[e0:e1])
""",
            """        encoder (agg_stream.encode_wire_elems) guards that invariant.\"\"\"
        if self.wire == "bf16" and self.mesh_codec.active:
            # The push's own encoder: a device codec's pushes are K4's bits
            # (canonical NaNs), which the host encoder does not reproduce.
            return self.mesh_codec.encode_bf16(np.ascontiguousarray(buf[e0:e1], np.float32)).tobytes()
        return encode_wire_elems(self.wire, buf[e0:e1])
""",
        ),
        (
            "the AveragerFn contract is host numpy; the port's unflatten returns "
            "tensors unless asked for the host",
            "        return unflatten_from_buffer(buf, self._specs, self._treedef)\n",
            "        return unflatten_from_buffer(buf, self._specs, self._treedef, device=None)\n",
        ),
    ],
    "swarm/state_sync.py": [
        (
            "a pull returns host numpy leaves, as the reference's does; the "
            "port's unflatten returns tensors unless asked for the host",
            "                return got_step, unflatten_from_buffer(buf, specs, treedef)\n",
            "                return got_step, unflatten_from_buffer(buf, specs, treedef, device=None)\n",
        ),
    ],
}


def _apply(module: str, ref: str, port: str):
    for reason, old, new in ALLOWED.get(module, []):
        assert ref.count(old) == 1, f"{module}: allowed difference no longer applies: {reason}"
        ref = ref.replace(old, new)
    return ref, port


@pytest.mark.parametrize("module", COPIED)
def test_copy_matches_reference(module):
    ref = ROOT.sub("distributedvolunteercomputing_tpu_torch", (REF / module).read_text())
    port = (PORT / module).read_text()
    ref, port = _apply(module, ref, port)
    if ref != port:
        ref_lines, port_lines = ref.splitlines(), port.splitlines()
        first = next(
            (i for i, (a, b) in enumerate(zip(ref_lines, port_lines)) if a != b),
            min(len(ref_lines), len(port_lines)),
        )
        ctx = lambda lines: "\n".join(lines[max(0, first - 2) : first + 3])  # noqa: E731
        pytest.fail(
            f"{module} drifted from the reference at line {first + 1}:\n"
            f"--- reference\n{ctx(ref_lines)}\n--- port\n{ctx(port_lines)}"
        )


def test_rewrite_is_the_import_root_only():
    # The rewrite leaves the port's own name alone and catches both import forms.
    src = (
        "from distributedvolunteercomputing_tpu import native\n"
        "from distributedvolunteercomputing_tpu.ops import robust\n"
        "import distributedvolunteercomputing_tpu_torch.x\n"
    )
    assert ROOT.sub("distributedvolunteercomputing_tpu_torch", src) == (
        "from distributedvolunteercomputing_tpu_torch import native\n"
        "from distributedvolunteercomputing_tpu_torch.ops import robust\n"
        "import distributedvolunteercomputing_tpu_torch.x\n"
    )
