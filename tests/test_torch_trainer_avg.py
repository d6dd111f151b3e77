"""The port's averaging boundary in the trainer, against the JAX package's,
and two port volunteers averaging over localhost on the CPU.

Both trainers start from the same params (the reference's init copied into
the port) and train the tiny gpt2 of ``tests/test_torch_train_step.py`` on
the same batches with clipped AdamW, averaging every 2 steps through one
scripted callback that records the payload and returns a fixed host tree.
Blocking rounds replace the params with it; overlapped rounds merge
``averaged + (current - snapshot)`` a step later. Every payload (the params
at a round) and the final params are compared with the tolerances of
``tests/test_torch_train_step.py``: atol 5e-6, the key bias (whose gradient
is rounding noise that Adam normalizes) to lr / 20.
"""

import asyncio
import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu.training.trainer import Trainer as JaxTrainer
from distributedvolunteercomputing_tpu.utils.pytree import flatten_to_buffer as jax_flatten
from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.swarm.volunteer import Volunteer, VolunteerConfig
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer, tree_leaves

TINY = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=256, max_len=32, xent_chunk=16, remat=False)
LR = 1e-2
STEPS = 5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_flat_close(x, y, specs, msg):
    """Flat param buffers, the key-bias slice of qkv.b held to lr / 20."""
    x, y = x.copy(), y.copy()
    off = 0
    for leaf_name, spec in zip(_LEAF_NAMES, specs):
        if leaf_name == "blocks/qkv/b":
            kb = np.zeros(spec.shape, bool)
            kb[:, TINY["d_model"] : 2 * TINY["d_model"]] = True
            seg = slice(off, off + spec.size)
            np.testing.assert_allclose(x[seg][kb.ravel()], y[seg][kb.ravel()], atol=LR / 20, rtol=0,
                                       err_msg=f"{msg} key bias")
            x[seg][kb.ravel()] = y[seg][kb.ravel()] = 0.0
        off += spec.size
    np.testing.assert_allclose(x, y, atol=5e-6, rtol=0, err_msg=msg)


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


_LEAF_NAMES = []


@pytest.mark.parametrize("overlap", [False, True], ids=["blocking", "overlap"])
def test_merges_match_reference(overlap):
    jb = jax_get_model("gpt2_small", **TINY)
    batches = [_np(jb.make_batch(jax.random.PRNGKey(10 + i), 2)) for i in range(STEPS)]

    def scripted(record, flatten):
        def cb(payload, step):
            record.append((step, flatten(payload)[0]))
            return jax.tree_util.tree_map(np.copy, fixed)

        return cb

    def gated(feed, holder):
        # An overlapped round merges at the first step after it completes;
        # the round must complete before the next batch is drawn, so both
        # trainers merge at the same step (the reference dispatches its
        # step asynchronously and would otherwise race the pool thread).
        for b in feed:
            inflight = holder[0]._inflight if holder else None
            if inflight is not None:
                concurrent.futures.wait([inflight[2]])
            yield b

    jrec, trec, jhold, thold = [], [], [], []
    jt = JaxTrainer(
        jb, batch_size=2, optimizer="adamw", lr=LR, total_steps=STEPS, data=gated(batches, jhold),
        averager=scripted(jrec, jax_flatten), average_every=2, overlap=overlap,
    )
    # The reference trainer's own init (init_seed 0) is the shared start; the
    # fixed tree every round "returns" is that init plus seeded noise.
    params0 = jax.tree_util.tree_map(np.array, jt.state.params)
    rng = np.random.default_rng(5)
    fixed = jax.tree_util.tree_map(lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params0)
    _LEAF_NAMES[:] = _leaf_names(params0)
    tbatches = [{k: torch.from_numpy(np.array(v)).long() for k, v in b.items()} for b in batches]
    tt = Trainer(
        get_model("gpt2_small", **TINY), batch_size=2, optimizer="adamw", lr=LR, total_steps=STEPS,
        data=gated(tbatches, thold),
        averager=scripted(trec, flatten_to_buffer), average_every=2, overlap=overlap, device="cpu",
    )
    jhold.append(jt)
    thold.append(tt)
    with torch.no_grad():
        for p, v in zip(tree_leaves(tt.state.params), jax.tree_util.tree_leaves(params0)):
            p.copy_(torch.from_numpy(np.array(v)))
    jt.run(steps=STEPS, log_every=0)
    tt.run(steps=STEPS, log_every=0)

    assert [s for s, _ in trec] == [s for s, _ in jrec] == [2, 4]
    _, specs, _ = jax_flatten(params0)
    for (step, got), (_, want) in zip(trec, jrec):
        _assert_flat_close(got, want, specs, f"payload at step {step}")
    final, _, _ = flatten_to_buffer(tt.state.params)
    jfinal, _, _ = jax_flatten(_np(jt.state.params))
    _assert_flat_close(final, jfinal, specs, "final params")
    # The merge happened: the final params sit near the fixed tree, not the
    # locally trained ones.
    fixed_flat, _, _ = jax_flatten(fixed)
    assert np.abs(final - fixed_flat).max() < 0.1 < np.abs(final - jax_flatten(params0)[0]).max()
    assert tt.steps_since_merge == jt.steps_since_merge


def test_trainer_refuses_what_is_not_ported():
    bundle = get_model("gpt2_small", **TINY)
    # fsdp is ported, with the reference's check; sequence parallelism and
    # the pipeline are not.
    with pytest.raises(ValueError, match="require a mesh"):
        Trainer(bundle, batch_size=2, device="cpu", fsdp=True)
    with pytest.raises(TypeError):
        Trainer(bundle, batch_size=2, device="cpu", seq_sharded=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        VolunteerConfig(averaging="sync", seq_sharded=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        VolunteerConfig(averaging="sync", mesh="dp=1,pp=2")


def test_two_port_volunteers_train_and_average():
    assert native.ensure_built()
    base = dict(
        model="gpt2_small", model_overrides=TINY, batch_size=2, averaging="sync", wire="bf16",
        average_every=2, overlap=False, steps=4, device="cpu", join_timeout=5.0, gather_timeout=5.0,
    )

    async def main():
        # vol1 bootstraps off vol0, so vol0 must be up first; both leave only
        # after both have trained (a leader that leaves at once would strand
        # the member's last fetch).
        v0 = Volunteer(VolunteerConfig(peer_id="v0", seed=1, **base))
        await v0.start()
        v1 = Volunteer(VolunteerConfig(peer_id="v1", seed=2, coordinator="%s:%d" % v0.transport.addr, **base))
        try:
            await v1.start()
            return await asyncio.gather(v0.train(), v1.train())
        finally:
            await asyncio.gather(v0.stop(), v1.stop())

    summaries = asyncio.run(asyncio.wait_for(main(), timeout=60))
    for s in summaries:
        assert s["rounds_ok"] >= 1 and np.isfinite(s["final_loss"]) and s["steps"] == 4
        assert s["wan_bytes_sent"] > 0
