"""The port's train step, flat-buffer serde and trainer against the JAX package.

Three steps of clipped AdamW with the warmup-cosine schedule
(``make_optimizer("adamw", lr, total_steps=3)``: rate 0, lr, lr/2) from the
same params on the same batches, params compared after every step; with the
default ``grad_clip=1.0`` the tiny model's grad norm (~2.5) is clipped, with
100 it is not. f32 on the CPU; params agree to atol 5e-6 (updates are ~lr =
1e-2 in size; the worst leaf differs by ~9e-7 after three steps).

One slice is held looser: the key bias. Its gradient is exactly zero in exact
arithmetic (softmax ignores a per-row shift, and q . b_k is one), so in both
frameworks it is rounding noise that Adam normalizes to an update of up to
~lr; it is checked to atol lr / 20.
"""

import math

import jax
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu.training.optim import make_optimizer as jax_make_optimizer
from distributedvolunteercomputing_tpu.training.steps import TrainState as JaxTrainState
from distributedvolunteercomputing_tpu.training.steps import make_train_step as jax_make_train_step
from distributedvolunteercomputing_tpu.utils.pytree import flatten_to_buffer as jax_flatten
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.models.convert import params_from_jax
from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
from distributedvolunteercomputing_tpu_torch.training.steps import TrainState, make_eval_step, make_train_step
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
from distributedvolunteercomputing_tpu_torch.utils.pytree import (
    flatten_to_buffer,
    tree_leaves,
    unflatten_from_buffer,
)

TINY = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=256, max_len=32, xent_chunk=16, remat=False)
LR = 1e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params_close(params, jparams, msg):
    key_bias = slice(TINY["d_model"], 2 * TINY["d_model"])
    qkv_b = params["blocks"]["qkv"]["b"]
    for a, b in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        x, y = a.numpy().copy(), np.array(b)
        if a is qkv_b:
            np.testing.assert_allclose(
                x[:, key_bias], y[:, key_bias], atol=LR / 20, rtol=0, err_msg=f"{msg} key bias"
            )
            x[:, key_bias] = y[:, key_bias] = 0.0
        np.testing.assert_allclose(x, y, atol=5e-6, rtol=0, err_msg=msg)


@pytest.mark.parametrize("grad_clip,clips", [(100.0, False), (1.0, True)])
def test_three_steps_match_jax(grad_clip, clips):
    jb = jax_get_model("gpt2_small", **TINY)
    params0 = _np(jb.init(jax.random.PRNGKey(0)))
    batches = [_np(jb.make_batch(jax.random.PRNGKey(10 + i), 2)) for i in range(3)]

    jtx = jax_make_optimizer("adamw", lr=LR, total_steps=3, grad_clip=grad_clip)
    jstep = jax_make_train_step(jb.loss_fn, jtx)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jax.numpy.asarray, params0), jtx, jax.random.PRNGKey(1))

    bundle = get_model("gpt2_small", **TINY)
    tx = make_optimizer("adamw", lr=LR, total_steps=3, grad_clip=grad_clip)
    state = TrainState.create(params_from_jax(params0, "cpu"), tx, torch.Generator())
    step = make_train_step(bundle.loss_fn, tx)

    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        assert (float(m["grad_norm"]) > grad_clip) == clips
        _assert_params_close(state.params, jstate.params, f"step {i}")
    assert state.step == 3 == int(jstate.step)


@pytest.mark.parametrize(
    "name,kw",
    [("adamw", dict(weight_decay=0.1, grad_clip=0.5)), ("adam", dict(warmup_steps=2)), ("sgd", dict(momentum=0.9))],
)
def test_optimizer_matches_optax(name, kw):
    # The update rules alone, on random params and grads: three updates of
    # the port's Optimizer against the optax chain make_optimizer builds.
    import optax

    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()} for _ in range(3)]
    jtx = jax_make_optimizer(name, lr=0.1, total_steps=None, **kw)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jstate = jtx.init(jp)
    tx = make_optimizer(name, lr=0.1, **kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(tp)
    for g in grads:
        upd, jstate = jtx.update(jax.tree_util.tree_map(jax.numpy.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tx.apply(tp, [torch.from_numpy(g[k]) for k in sorted(g)], state)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6, err_msg=f"{name} {k}")


def test_schedule_is_optax_warmup_cosine():
    import optax

    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 1, 10)
    sched = make_optimizer("adamw", lr=3e-4, total_steps=10).schedule
    for c in range(12):
        assert math.isclose(sched(c), float(ref(c)), rel_tol=1e-6, abs_tol=1e-12)
    lin = optax.linear_schedule(0.0, 3e-4, 4)
    sched = make_optimizer("adam", lr=3e-4, warmup_steps=4).schedule
    for c in range(6):
        assert math.isclose(sched(c), float(lin(c)), rel_tol=1e-6, abs_tol=1e-12)


def test_flat_buffer_matches_reference():
    jb = jax_get_model("gpt2_small", **TINY)
    params_np = _np(jb.init(jax.random.PRNGKey(0)))
    ref_buf, ref_specs, _ = jax_flatten(params_np)
    params = params_from_jax(params_np, "cpu")
    buf, specs, treedef = flatten_to_buffer(params)
    np.testing.assert_array_equal(buf, ref_buf)
    assert [(s.shape, s.dtype) for s in specs] == [(tuple(s.shape), s.dtype) for s in ref_specs]
    back = unflatten_from_buffer(buf, specs, treedef)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
    # bf16 leaves keep their dtype name through the round trip.
    half = {"w": torch.ones(3, dtype=torch.bfloat16)}
    _, hspecs, _ = flatten_to_buffer(half)
    assert hspecs[0].dtype == "bfloat16"


def test_trainer_runs_on_the_cpu():
    bundle = get_model("gpt2_small", **TINY)
    summary = Trainer(bundle, batch_size=2, total_steps=3, device="cpu").run(steps=3)
    assert set(summary) == {"final_loss", "steps", "wall_time_s", "samples_per_sec"}
    assert summary["steps"] == 3 and all(math.isfinite(v) for v in summary.values())
    # bf16 params: every floating leaf (and so every moment) is cast.
    t16 = Trainer(bundle, batch_size=2, param_dtype="bfloat16", device="cpu")
    assert math.isfinite(t16.run(steps=2)["final_loss"])
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(t16.state.params) + t16.state.opt_state["mu"])
    trainer = Trainer(bundle, batch_size=2, accum_steps=2, device="cpu")
    summary = trainer.run(steps=2, target_loss=100.0, target_mode="record")
    assert summary["target_crossed_step"] == 1
    assert {"target_loss", "target_crossed_step", "target_crossed_s"} <= set(summary)
    # The eval step reports the loss without touching the params.
    batch = bundle.make_batch(torch.Generator().manual_seed(5), 2)
    before = [p.clone() for p in tree_leaves(trainer.state.params)]
    metrics = make_eval_step(bundle.loss_fn)(trainer.state.params, batch, torch.Generator())
    loss, _ = bundle.loss_fn(trainer.state.params, batch, torch.Generator())
    assert metrics["loss"].item() == loss.item() and not metrics["loss"].requires_grad
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(trainer.state.params)))
