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
            "module doc: what this slice of the port carries",
            '''"""GradientAverager family: the four WAN averaging modes of the reference.
''',
            '''"""GradientAverager family: the four WAN averaging modes of the reference.

Ported: the four modes on the f32 and bf16 wires, with the resilience,
failure-detector and controller collaborators; the other wires and the shard
manager raise at construction until their slices arrive.
''',
        ),
        (
            "construction guard: wires other than f32/bf16 and the shard "
            "manager (zone sharding) raise instead of being accepted and ignored",
            """        if wire not in ("f32", "bf16", "q8", "topk", "powersgd", "sign"):
""",
            """        # Not ported yet: the other wires and zone sharding. Accepting one
        # and ignoring it would change the round silently.
        if wire not in ("f32", "bf16"):
            raise NotImplementedError(f"wire {wire!r} is not ported yet; ported: f32, bf16")
        if shard_manager is not None:
            raise NotImplementedError("shard_manager (zone sharding) is not ported yet: pass None")
        if wire not in ("f32", "bf16", "q8", "topk", "powersgd", "sign"):
""",
        ),
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
