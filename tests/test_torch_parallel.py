"""The port's local mesh and data-parallel step (``parallel/``) against the
JAX package's.

``make_mesh`` and ``parse_mesh_spec`` are held to the reference's shapes,
axis names and error messages; the port's ranks are CPU devices, named as
many times as the reference has virtual CPU devices (8, ``tests/conftest.py``).
The DP step at dp=2 and dp=4 takes three clipped AdamW steps of the tiny
gpt2 of ``tests/test_torch_train_step.py`` from the same params (the port's
init from a seed) on the same batches (numpy, from a seed), against the
reference's ``make_sharded_train_step`` on ``make_mesh(dp=...)`` and
against the port's one-rank step: losses to rtol
1e-5, params to atol 5e-6 after every step, the key bias (whose gradient is
rounding noise that Adam normalizes) to lr / 20 — the tolerances of
``tests/test_torch_train_step.py``. f32 on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu.parallel import mesh as jax_mesh
from distributedvolunteercomputing_tpu.parallel import train_step as jax_ts
from distributedvolunteercomputing_tpu.training.optim import make_optimizer as jax_make_optimizer
from distributedvolunteercomputing_tpu.training.steps import TrainState as JaxTrainState
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.models.convert import params_from_jax
from distributedvolunteercomputing_tpu_torch.parallel import mesh as pmesh
from distributedvolunteercomputing_tpu_torch.parallel import train_step as pts
from distributedvolunteercomputing_tpu_torch.parallel.sharding import ShardedTensor
from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
from distributedvolunteercomputing_tpu_torch.training.steps import TrainState, make_train_step
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves, tree_map

TINY = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=256, max_len=32, xent_chunk=16, remat=False)
LR = 1e-2
BATCH = 4
CPU8 = ["cpu"] * 8


def _assert_params_close(params, other, msg):
    """``other``: a port tree or the reference's (jax arrays)."""
    key_bias = slice(TINY["d_model"], 2 * TINY["d_model"])
    qkv_b = params["blocks"]["qkv"]["b"]
    others = tree_leaves(other) if isinstance(other["wte"], torch.Tensor) else jax.tree_util.tree_leaves(other)
    for a, b in zip(tree_leaves(params), others):
        x = (a.full() if isinstance(a, ShardedTensor) else a).numpy().copy()
        y = b.numpy().copy() if isinstance(b, torch.Tensor) else np.array(b)
        if a is qkv_b:
            np.testing.assert_allclose(x[:, key_bias], y[:, key_bias], atol=LR / 20, rtol=0, err_msg=f"{msg} key bias")
            x[:, key_bias] = y[:, key_bias] = 0.0
        np.testing.assert_allclose(x, y, atol=5e-6, rtol=0, err_msg=msg)


@pytest.mark.parametrize(
    "axes", [dict(dp=2), dict(dp=8), dict(dp=2, tp=2), dict(dp=2, sp=2, pp=2), dict(ep=4), dict()]
)
def test_make_mesh_matches_reference(axes):
    ref = jax_mesh.make_mesh(**axes)
    mesh = pmesh.make_mesh(**axes, devices=CPU8)
    assert mesh.axis_names == tuple(ref.axis_names) == pmesh.AXES
    assert mesh.devices.shape == ref.devices.shape
    assert pmesh.mesh_shape(mesh) == jax_mesh.mesh_shape(ref)
    assert all(d == torch.device("cpu") for d in mesh.flat()) and len(mesh.flat()) == ref.devices.size


def test_make_mesh_errors_match_reference():
    with pytest.raises(ValueError) as ref:
        jax_mesh.make_mesh(dp=4, tp=4)
    with pytest.raises(ValueError) as got:
        pmesh.make_mesh(dp=4, tp=4, devices=CPU8)
    assert str(got.value) == str(ref.value)
    # Without devices the port takes the visible cards: none here.
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 devices, have 0"):
            pmesh.make_mesh(dp=2)
    # A card named twice is two ranks.
    mesh = pmesh.make_mesh(dp=2, devices=["cuda:0", "cuda:0"])
    assert mesh.flat() == [torch.device("cuda", 0)] * 2


@pytest.mark.parametrize(
    "spec", ["dp=2", "dp=2,tp=2", " dp = 4 ,", "sp=2,pp=3,ep=1", "dp=0", "dp=2,xx=2", "dp", "", ",", "tp=-1", "dp=two"]
)
def test_parse_mesh_spec_matches_reference(spec):
    try:
        want = jax_mesh.parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    assert pmesh.parse_mesh_spec(spec) == want


@pytest.fixture(scope="module")
def inputs():
    """Params (the port's init, as numpy) and three batches, from seeds."""
    bundle = get_model("gpt2_small", **TINY)
    params = tree_map(lambda t: t.numpy(), bundle.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(20)
    batches = []
    for _ in range(3):
        seq = rng.integers(0, TINY["vocab"], (BATCH, TINY["max_len"] + 1))
        batches.append({"tokens": seq[:, :-1].astype(np.int32), "targets": seq[:, 1:].astype(np.int32)})
    return params, batches


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_step_matches_reference_sharded_step(dp, inputs):
    jb = jax_get_model("gpt2_small", **TINY)
    params0, batches = inputs

    jmesh = jax_mesh.make_mesh(dp=dp)
    jtx = jax_make_optimizer("adamw", lr=LR, total_steps=3)
    jstate, _ = jax_ts.shard_train_state(
        JaxTrainState.create(jax.tree_util.tree_map(jax.numpy.asarray, params0), jtx, jax.random.PRNGKey(1)), jmesh
    )
    jstep = jax_ts.make_sharded_train_step(jb.loss_fn, jtx, jmesh, donate=False)

    bundle = get_model("gpt2_small", **TINY)
    mesh = pmesh.make_mesh(dp=dp, devices=CPU8)
    tx = make_optimizer("adamw", lr=LR, total_steps=3)
    state, _ = pts.shard_train_state(TrainState.create(params_from_jax(params0, "cpu"), tx, torch.Generator()), mesh)
    step = pts.make_sharded_train_step(bundle.loss_fn, tx, mesh)
    # The one-rank port step from the same params on the same batches.
    one_tx = make_optimizer("adamw", lr=LR, total_steps=3)
    one = TrainState.create(params_from_jax(params0, "cpu"), one_tx, torch.Generator())
    one_step = make_train_step(bundle.loss_fn, one_tx)

    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, jax_ts.put_batch(batch, jmesh))
        tb = {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}
        shares = pts.put_batch(tb, mesh)
        assert [s["tokens"].shape[0] for s in shares] == [BATCH // dp] * dp
        state, m = step(state, shares)
        one, m1 = one_step(one, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]), rtol=1e-5)
        _assert_params_close(state.params, jstate.params, f"dp={dp} step {i} vs reference")
        _assert_params_close(state.params, one.params, f"dp={dp} step {i} vs one rank")
        for leaf in state.leaves():  # one update on identical grads: identical replicas
            assert all(torch.equal(s, leaf.shards[0]) for s in leaf.shards[1:])
    assert state.step == 3 == int(jstate.step)


def test_dp_only_and_batch_split():
    # dp, tp and ep are ported (tests/test_torch_mesh_step.py); sequence
    # parallelism and the pipeline still refuse.
    bundle = get_model("gpt2_small", **TINY)
    tx = make_optimizer("adamw", lr=LR)
    for axes in (dict(dp=2, sp=2), dict(dp=2, pp=2)):
        with pytest.raises(NotImplementedError, match="not ported"):
            pts.make_sharded_train_step(bundle.loss_fn, tx, pmesh.make_mesh(**axes, devices=CPU8))
    mesh = pmesh.make_mesh(dp=2, devices=CPU8)
    for kw in (dict(seq_sharded_batch=True), dict(sp_impl="ulysses")):
        with pytest.raises(NotImplementedError, match="not ported"):
            pts.make_sharded_train_step(bundle.loss_fn, tx, mesh, **kw)
    with pytest.raises(ValueError, match="does not split"):
        pts.put_batch({"tokens": torch.zeros(3, 4)}, mesh)


def test_trainer_on_a_mesh_merges_into_every_replica():
    """A blocking round's result lands in every dp replica, and the averager
    reads rank 0's params."""
    bundle = get_model("gpt2_small", **TINY)
    seen = []

    def averager(payload, step):
        seen.append(payload)
        return jax.tree_util.tree_map(lambda x: np.full_like(x, 0.25), payload)

    mesh = pmesh.make_mesh(dp=2, devices=["cpu", "cpu"])
    trainer = Trainer(bundle, batch_size=BATCH, device="cpu", mesh=mesh, averager=averager, average_every=2)
    summary = trainer.run(steps=3)
    assert summary["steps"] == 3 and np.isfinite(summary["final_loss"]) and len(seen) == 1
    for leaf in trainer.state.leaves():
        assert all(torch.allclose(s, leaf.shards[0]) for s in leaf.shards[1:])
    assert trainer.state.step == 3 and trainer.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not split"):
        Trainer(bundle, batch_size=3, device="cpu", mesh=mesh).run(steps=1)
