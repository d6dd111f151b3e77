"""The port's resilience layer, clock sync and wall-clock cadence against the
reference's own cases.

- ``tests/test_failure_detector.py`` and ``tests/test_resilience.py`` run
  unchanged on the port's copies: their text with the import root rewritten
  to the port (``tests/test_torch_swarm_drift.py``'s rewrite), executed in a
  namespace of its own, every test method a case here.
- From ``tests/test_interval_cadence.py``: ``TestAvgDue``,
  ``TestIntervalRounds``, ``TestMethodKw`` and ``TestClockSync`` on the
  port's trainer (the tiny gpt2 on the CPU), volunteer config and
  ``ClockSync`` over localhost TCP.
- ``test_leader_preexcludes_suspected_straggler_from_formation``
  (``tests/test_averaging.py``) on port averagers: a leader whose policy
  flags a straggler forms its round without it.
"""

import asyncio
import re
import time
from pathlib import Path

import numpy as np
import pytest

from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
from distributedvolunteercomputing_tpu_torch.swarm import failure_detector as fd_mod
from distributedvolunteercomputing_tpu_torch.swarm import resilience as res_mod
from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager
from distributedvolunteercomputing_tpu_torch.swarm.clocksync import ClockSync
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport
from distributedvolunteercomputing_tpu_torch.swarm.volunteer import VolunteerConfig
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
ROOT = re.compile(r"\bdistributedvolunteercomputing_tpu(?=[.\s])")  # the drift test's import-root rewrite
TINY = dict(n_layers=1, d_model=32, n_heads=2, d_ff=64, vocab=64, max_len=16, xent_chunk=8, remat=False)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


# -- the reference's detector and policy cases on the port's copies ------------


def _ported_namespace(test_file: str) -> dict:
    src = ROOT.sub("distributedvolunteercomputing_tpu_torch", (REPO / "tests" / test_file).read_text())
    ns = {"__name__": f"ported_{Path(test_file).stem}"}
    exec(compile(src, str(REPO / "tests" / test_file), "exec"), ns)
    return ns


REFERENCE_CASES = {
    name: _ported_namespace(name) for name in ("test_failure_detector.py", "test_resilience.py")
}


def _cases():
    out = []
    for file, ns in REFERENCE_CASES.items():
        for cls_name, cls in ns.items():
            if cls_name.startswith("Test") and isinstance(cls, type):
                out += [(file, cls_name, m) for m in vars(cls) if m.startswith("test_")]
    return out


def test_reference_cases_bind_the_port():
    assert REFERENCE_CASES["test_failure_detector.py"]["PhiAccrualDetector"] is fd_mod.PhiAccrualDetector
    assert REFERENCE_CASES["test_resilience.py"]["ResiliencePolicy"] is res_mod.ResiliencePolicy
    assert len([c for c in _cases() if c[0] == "test_failure_detector.py"]) == 12
    assert len([c for c in _cases() if c[0] == "test_resilience.py"]) == 20


@pytest.mark.parametrize("file,cls,method", _cases(), ids=lambda v: v.removesuffix(".py"))
def test_reference_case_on_the_port(file, cls, method):
    getattr(REFERENCE_CASES[file][cls](), method)()


# -- the wall-clock cadence on the port's trainer -----------------------------


def make_trainer(**kw):
    base = dict(batch_size=2, lr=1e-2, optimizer="adam", seed=0, device="cpu")
    base.update(kw)
    return Trainer(get_model("gpt2_small", **TINY), **base)


class TestAvgDue:
    def test_step_cadence_unchanged(self):
        t = make_trainer(average_every=3)
        assert [t._avg_due(s) for s in (1, 2, 3, 6)] == [False, False, True, True]

    def test_interval_first_call_arms_only(self):
        t = make_trainer(average_interval_s=3600.0)
        assert not t._avg_due(1)  # arms the next hour boundary
        assert not t._avg_due(2)

    def test_interval_fires_once_per_boundary(self):
        clock = {"t": 100.01}
        t = make_trainer(average_interval_s=0.15, wall_clock=lambda: clock["t"])
        assert not t._avg_due(1)  # arm
        clock["t"] += 0.16
        assert t._avg_due(2)  # crossed one boundary
        assert not t._avg_due(3)  # same window
        clock["t"] += 0.16
        assert t._avg_due(4)

    def test_interval_boundaries_are_absolute(self):
        t1 = make_trainer(average_interval_s=500.0)
        t2 = make_trainer(average_interval_s=500.0)
        t1._avg_due(1)
        time.sleep(0.05)
        t2._avg_due(1)
        assert t1._next_avg_t == t2._next_avg_t

    def test_slow_step_skipping_boundaries_yields_one_round(self):
        clock = {"t": 10.01}
        t = make_trainer(average_interval_s=0.05, wall_clock=lambda: clock["t"])
        t._avg_due(1)
        clock["t"] += 0.22  # several boundaries pass
        assert t._avg_due(2)
        assert not t._avg_due(3)

    def test_negative_interval_rejected(self):
        with pytest.raises(ValueError, match="average_interval_s"):
            make_trainer(average_interval_s=-1.0)


class TestIntervalRounds:
    def test_rounds_fire_on_wall_clock_not_steps(self):
        calls = []
        clock = {"t": 1000.0}

        def averager(tree, step):
            calls.append((step, t.steps_since_merge))
            return tree

        # Each step advances the clock 0.025 s over 0.1 s boundaries: a round
        # every four steps, where the step cadence would fire every step.
        t = make_trainer(average_interval_s=0.1, averager=averager, average_every=1,
                         wall_clock=lambda: clock["t"])
        t.on_step = lambda tr, s: clock.__setitem__("t", clock["t"] + 0.025)
        t.run(steps=16, log_every=0)
        assert 3 <= len(calls) <= 5
        # Each contribution weighs by the steps of its window.
        assert all(3 <= w <= 5 for _, w in calls[1:]), calls

    def test_huge_interval_never_fires(self):
        calls = []
        t = make_trainer(average_interval_s=3600.0, averager=lambda tree, step: calls.append(step) or tree,
                         average_every=1)
        t.run(steps=6, log_every=0)
        assert calls == []


class TestMethodKw:
    def test_unknown_keys_rejected_at_config_time(self):
        with pytest.raises(ValueError, match="method-kw"):
            VolunteerConfig(coordinator="x:1", averaging="byzantine", method="trimmed_mean",
                            method_kw={"n_byzantine": 1})
        cfg = VolunteerConfig(coordinator="x:1", averaging="byzantine", method="krum", method_kw={"n_byzantine": 2})
        assert cfg.method_kw == {"n_byzantine": 2}

    def test_unknown_method_name_rejected_at_config_time(self):
        with pytest.raises(ValueError, match="unknown --method"):
            VolunteerConfig(coordinator="x:1", averaging="byzantine", method="trimed_mean")
        with pytest.raises(ValueError, match="unknown --method"):
            VolunteerConfig(coordinator="x:1", averaging="gossip", method="nope")


class TestClockSync:
    """Skewed clocks over localhost: ClockSync's corrected clocks converge."""

    @staticmethod
    async def _stacks(skews):
        stacks, boot = [], None
        for pid, skew in skews:
            t = Transport()
            dht = DHTNode(t)
            await dht.start(bootstrap=[boot] if boot else None)
            boot = boot or t.addr
            mem = SwarmMembership(dht, pid, ttl=10.0)
            await mem.join()
            stacks.append((t, mem, ClockSync(t, mem, clock=(lambda s=skew: time.time() + s), samples_per_peer=2)))
        return stacks

    @staticmethod
    async def _close(stacks):
        for t, mem, _ in stacks:
            try:
                await asyncio.wait_for(mem.leave(), 5)
            except Exception:
                pass
            await asyncio.wait_for(t.close(), 5)

    def test_two_nodes_meet_in_the_middle(self):
        async def main():
            stacks = await self._stacks((("a", +6.0), ("b", 0.0)))
            try:
                for _ in range(4):
                    await asyncio.gather(*(cs.estimate() for _, _, cs in stacks))
                return [cs.now() for _, _, cs in stacks], time.time()
            finally:
                await self._close(stacks)

        times, now = run(main())
        assert abs(times[0] - times[1]) < 0.5, times
        assert abs(times[0] - (now + 3.0)) < 1.5  # the midpoint, not one node's clock

    def test_skewed_minority_pinned_to_majority(self):
        async def main():
            stacks = await self._stacks((("a", -7.0), ("b", 0.0), ("c", 0.0), ("d", 0.0)))
            try:
                for _ in range(3):
                    await asyncio.gather(*(cs.estimate() for _, _, cs in stacks))
                return [cs.now() for _, _, cs in stacks], time.time()
            finally:
                await self._close(stacks)

        times, now = run(main())
        for ct in times:
            assert abs(ct - now) < 1.0, times

    def test_trainer_boundary_uses_corrected_clock(self):
        offset = {"v": 100.0}
        tr = make_trainer(average_interval_s=10.0, wall_clock=lambda: 1000.0 + offset["v"],
                          averager=lambda tree, step: None)
        assert tr._avg_due(1) is False  # the first call arms
        assert tr._next_avg_t == 1110.0  # on the corrected clock
        offset["v"] = 111.0
        assert tr._avg_due(2) is True


# -- pre-exclusion at formation ----------------------------------------------


def test_leader_preexcludes_suspected_straggler_from_formation():
    """The leader's policy flags vol2 (three rounds absent): the matchmaker
    drops it before the member list freezes, and the two kept members
    average without it; vol2's own round forms nothing."""
    assert native.ensure_built()

    def tree(v):
        return {"w": np.full((4, 3), v, np.float32), "b": {"x": np.full((5,), 2 * v, np.float32)}}

    async def main():
        vols, boot = [], None
        for i in range(3):
            t = Transport()
            dht = DHTNode(t)
            await dht.start(bootstrap=[boot] if boot else None)
            boot = boot or t.addr
            mem = SwarmMembership(dht, f"vol{i}", ttl=10.0)
            await mem.join()
            vols.append((t, mem, SyncAverager(t, dht, mem, min_group=2, max_group=3, gather_timeout=8.0,
                                              join_timeout=2.0, mesh_codec=mc.MeshCodec(device="cpu", backend="device"))))
        policy = res_mod.ResiliencePolicy(max_deadline_s=8.0, preexclude_misses=3)
        for _ in range(3):
            policy.record_round(duration_s=1.0, ok=True, absent=["vol2"])
        leader = vols[0][2]
        leader.resilience = policy
        leader.matchmaker.exclude = policy.should_preexclude
        async def timed(avg, x):
            t0 = time.monotonic()
            return await avg.average(tree(x), 1), time.monotonic() - t0

        try:
            results = await asyncio.gather(*(timed(v[2], x) for v, x in zip(vols, (0.0, 2.0, 9.0))))
            return [r for r, _ in results], leader.matchmaker.last_preexcluded, [s for _, s in results]
        finally:
            for t, mem, _ in vols:
                try:
                    await asyncio.wait_for(mem.leave(), 5)
                except Exception:
                    pass
                await asyncio.wait_for(t.close(), 5)

    (ra, rb, rc), preexcluded, seconds = run(main())
    for r in (ra, rb):
        assert r is not None
        np.testing.assert_allclose(r["w"], 1.0, rtol=1e-5)
    assert rc is None
    assert preexcluded == ["vol2"]
    # The kept pair did not wait for the straggler's gather deadline.
    assert max(seconds[:2]) < 8.0, seconds
