"""The reference's leader-failover cases on the port's copies.

``tests/test_failover.py`` runs on the port (``tests/torch_reference_cases.py``):
the kill-at-phase matrix over ``SyncAverager.LEADER_PHASES``, epoch fencing,
the dead leader's fast fail, successor election, the chaos transport's
partition helpers and the aggregator's fence, on port averagers over
``ChaosTransport``s with the device codec on CPU tensors.

Every case runs as is, ``test_ef_residual_bitwise_across_recovered_round``
on the topk wire included. ``test_bf16_recovered_round_refolds_the_retained_pushes``
adds the bf16 wire's counterpart: a leader killed mid-stream, and the
successor's result is the fold of the survivors' retained bf16
contributions, which its member fetches as exactly that result's bf16
rounding.
"""

import numpy as np
from torch_reference_cases import count_cases, device_codec, port_cases  # noqa: F401

from distributedvolunteercomputing_tpu_torch import native

REFERENCE = port_cases("test_failover.py", globals())


def test_reference_cases_bind_the_port():
    from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager
    from distributedvolunteercomputing_tpu_torch.swarm.chaos import ChaosTransport

    assert REFERENCE["SyncAverager"] is SyncAverager and REFERENCE["ChaosTransport"] is ChaosTransport
    assert count_cases(REFERENCE) == 13


def test_bf16_recovered_round_refolds_the_retained_pushes():
    """The leader dies mid-stream on the bf16 wire. The successor (vol1)
    re-leads over the survivors' retained contributions: its result is the
    mean of the two bf16-rounded pushes to within an f32 rounding of the
    fold, and the member's fetched result is that result's bf16 rounding,
    bit for bit (K4 on the leader, decoded on the member)."""
    spawn, install_kill, kill_round, teardown, run = (
        REFERENCE[n] for n in ("spawn", "install_kill", "kill_round", "teardown", "run"))
    rng = np.random.default_rng(5)
    trees = [{"w": rng.standard_normal(64).astype(np.float32)} for _ in range(3)]

    async def main():
        vols = await spawn(3, wire="bf16")
        install_kill(vols[0], "mid_stream")
        try:
            results = await kill_round(vols, trees=trees)
        finally:
            await teardown(vols)
        return vols, results

    vols, results = run(main())
    assert isinstance(results[0], RuntimeError)
    assert all(v["avg"].rounds_recovered == 1 for v in vols[1:])
    pushed = [native.bf16_to_f32(native.f32_to_bf16(trees[i]["w"])).astype(np.float64) for i in (1, 2)]
    lead, member = (np.asarray(results[i]["w"]) for i in (1, 2))
    want = (pushed[0] + pushed[1]) / 2.0
    assert np.all(np.abs(lead - want) <= 2.0**-23 * np.maximum(np.abs(pushed[0]), np.abs(pushed[1])))
    assert member.tobytes() == native.bf16_to_f32(native.f32_to_bf16(lead)).astype(np.float32).tobytes()


def test_follower_fetch_before_the_successor_arms_is_served():
    """A recovery follower's fetch that reaches the successor before it arms
    (here the successor is slowed by 0.5 s between its recovery begin and
    its round) parks on the round and gets the recovered result: an unarmed
    round is not fenced (ROADMAP Queue 3, the recovery fetch fix; the
    reference refuses the fetch as stale and the follower fails the round)."""
    import asyncio

    spawn, install_kill, kill_round, teardown, run = (
        REFERENCE[n] for n in ("spawn", "install_kill", "kill_round", "teardown", "run"))

    async def main():
        vols = await spawn(3)
        install_kill(vols[0], "mid_stream")
        successor = vols[1]["avg"]
        lead_round = successor._lead_round

        async def slow_lead_round(*a, **kw):
            await asyncio.sleep(0.5)
            return await lead_round(*a, **kw)

        successor._lead_round = slow_lead_round
        try:
            results = await kill_round(vols)
        finally:
            await teardown(vols)
        return vols, results

    vols, results = run(main())
    assert isinstance(results[0], RuntimeError)
    for i in (1, 2):
        assert results[i] is not None and not isinstance(results[i], BaseException), f"vol{i}: {results[i]!r}"
        np.testing.assert_allclose(results[i]["w"], 1.5, rtol=1e-6)
        assert vols[i]["avg"].rounds_recovered == 1
