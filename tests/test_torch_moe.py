"""The port's ``models/moe.py`` (gpt2_moe) against the JAX package's, and the
reference's own ``tests/test_moe.py`` on the port.

- ``moe_ffn`` on shared params and inputs, top-1 and top-2, with ample and
  with binding capacity: the routing (each token's experts, and which of its
  choices keep a capacity slot) is identical to the reference's, y within
  1e-6 and the aux loss within 1e-6.
- A dp2ep2tp2 step (experts over ep, their hidden dim over tp, the batch
  over dp) in which capacity binds, against the reference: the capacity, the
  queue order and the aux loss are over the whole batch, as GSPMD keeps
  them, so each dp group's queue starts after the groups before it. Each
  gradient leaf within 1e-5 relative l2 of the reference's gradient of the
  whole batch's loss; loss, lm_loss, aux_loss and grad_norm within 1e-5 of
  the reference's sharded step, and each leaf's update within 1e-3 relative
  l2 of its (``PARITY_TOL["dp"]["update_l2"]`` of ``chip_smoke.py``: Adam's
  first update normalizes each element's gradient, so rounding noise in a
  small gradient becomes up to ~lr; the reference's own sharded step is
  4.7e-5 from its one-device step on ``moe_out`` here). A per-group capacity
  drops different tokens and fails this test.
- The reference's ``tests/test_moe.py`` on the port
  (``tests/torch_reference_cases.py``), with the shims of
  ``tests/test_torch_mesh_step.py`` and ``jax.nn.gelu`` of a torch tensor the
  port's (the same tanh form). Replaced: ``test_gpt2_moe_grads_reach_experts_and_router``
  differentiates the port's loss with ``jax.value_and_grad``; its
  counterpart takes torch's gradients.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mesh_step import bind_shims, cpu_trainer, jax_array_surface  # noqa: F401
from torch_reference_cases import count_cases, port_cases

from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu.models import moe as jax_moe
from distributedvolunteercomputing_tpu.parallel import mesh as jax_mesh
from distributedvolunteercomputing_tpu.parallel import train_step as jax_ts
from distributedvolunteercomputing_tpu.training.optim import make_optimizer as jax_make_optimizer
from distributedvolunteercomputing_tpu.training.steps import TrainState as JaxTrainState
from distributedvolunteercomputing_tpu_torch.models import common, get_model, moe
from distributedvolunteercomputing_tpu_torch.models.convert import params_from_jax
from distributedvolunteercomputing_tpu_torch.parallel import mesh as pmesh
from distributedvolunteercomputing_tpu_torch.parallel import train_step as pts
from distributedvolunteercomputing_tpu_torch.parallel.sharding import leaf_paths
from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
from distributedvolunteercomputing_tpu_torch.training.steps import TrainState
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves, tree_map

TINY = dict(vocab=128, max_len=16, d_model=32, n_heads=2, n_layers=2, d_ff=64, n_experts=4, remat=False)
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference_routing(p, x, cfg):
    """The reference's routing decisions (``models/moe.py:80-110``, the same
    jnp ops): (top_idx [S, K], kept [S, K])."""
    s = x.shape[0] * x.shape[1]
    cap = max(math.ceil(cfg.capacity_factor * cfg.router_top_k * s / cfg.n_experts), 1)
    xs = x.reshape(s, -1)
    gates = jax.nn.softmax(jnp.einsum("sd,de->se", xs.astype(jnp.float32), p["router"]), axis=-1)
    _, top_idx = jax.lax.top_k(gates, cfg.router_top_k)
    count_prev = jnp.zeros((cfg.n_experts,), jnp.float32)
    kept = []
    for i in range(cfg.router_top_k):
        oh = jax.nn.one_hot(top_idx[:, i], cfg.n_experts, dtype=jnp.float32)
        pos = (jnp.cumsum(oh, axis=0) + count_prev[None, :]) * oh - 1.0
        kept.append(jnp.any((pos >= 0) & (pos < cap), axis=-1))
        count_prev = count_prev + jnp.sum(oh, axis=0)
    return np.asarray(top_idx), np.stack([np.asarray(k) for k in kept], -1)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.3], ids=["ample", "binding"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_reference(top_k, capacity_factor):
    over = dict(TINY, router_top_k=top_k, capacity_factor=capacity_factor)
    jcfg, cfg = jax_moe.GPT2MoEConfig(**over), moe.GPT2MoEConfig(**over)
    jp = jax_moe.moe_init(jax.random.PRNGKey(0), jcfg)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 16, cfg.d_model)))
    jy, jaux = jax_moe.moe_ffn(jp, jnp.asarray(x), jcfg)
    want_idx, want_kept = _reference_routing(jp, jnp.asarray(x), jcfg)
    with moe.routing_log() as log:
        y, aux = moe.moe_ffn(params_from_jax(jp, "cpu"), torch.from_numpy(x.copy()), cfg)
    assert np.array_equal(log[0]["top_idx"].numpy(), want_idx)
    assert np.array_equal(log[0]["kept"].numpy(), want_kept)
    if capacity_factor < 1:
        assert not want_kept.all()  # the case binds
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)


def test_top_k_breaks_ties_to_the_lower_index():
    gates = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    _, idx = moe._top_k(gates, 2)
    _, want = jax.lax.top_k(jnp.asarray(gates.numpy()), 2)
    assert idx.tolist() == np.asarray(want).tolist() == [[0, 1], [1, 2]]


@pytest.mark.parametrize("top_k", [1, 2])
def test_dp2ep2tp2_step_with_binding_capacity_matches_reference(top_k):
    over = dict(TINY, router_top_k=top_k, capacity_factor=0.5, remat=True)
    bundle, jb = get_model("gpt2_moe", **over), jax_get_model("gpt2_moe", **over)
    params0 = tree_map(lambda t: t.numpy(), bundle.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(5)
    seq = rng.integers(0, over["vocab"], (8, over["max_len"] + 1))
    batch = {"tokens": seq[:, :-1].astype(np.int32), "targets": seq[:, 1:].astype(np.int32)}

    jmesh = jax_mesh.make_mesh(dp=2, ep=2, tp=2)
    jtx = jax_make_optimizer("adamw", lr=LR)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), params0), jtx,
                                  jax.random.PRNGKey(1))
    jstate, _ = jax_ts.shard_train_state(jstate, jmesh, jtx)
    jstate, jm = jax_ts.make_sharded_train_step(jb.loss_fn, jtx, jmesh, donate=False)(
        jstate, jax_ts.put_batch(batch, jmesh))
    want = [np.array(x, copy=True) for x in jax.tree_util.tree_leaves(jstate.params)]

    mesh = pmesh.make_mesh(dp=2, ep=2, tp=2, devices=["cpu"] * 8)
    tx = make_optimizer("adamw", lr=LR)
    state, _ = pts.shard_train_state(TrainState.create(params_from_jax(params0, "cpu"), tx, torch.Generator()), mesh)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    # The whole batch's routing, as the one-device forward makes it: the
    # capacity binds on it.
    with moe.routing_log() as log, torch.no_grad():
        bundle.loss_fn(params_from_jax(params0, "cpu"), tb, torch.Generator())
    assert not all(bool(r["kept"].all()) for r in log)
    jgrads = jax.jit(jax.grad(lambda p: jb.loss_fn(p, batch, None)[0]))(jax.tree_util.tree_map(jnp.asarray, params0))
    grads, _ = pts.dp_grad_half(bundle.loss_fn, state, pts.put_batch(tb, mesh))
    names = leaf_paths(params0)
    for name, got, w in zip(names, grads, jax.tree_util.tree_leaves(jgrads)):
        w = np.asarray(w)
        rel = np.linalg.norm(got.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-5, (name, rel)
    state, m = pts.make_sharded_train_step(bundle.loss_fn, tx, mesh)(state, pts.put_batch(tb, mesh))
    for key in ("loss", "lm_loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    d = over["d_model"]
    for name, got, w, init in zip(names, tree_leaves(state.params), want, tree_leaves(params0)):
        got = got.full().numpy()
        w = w.copy()
        if name == "blocks/qkv/b":  # the key bias: Adam-normalized rounding noise
            kb = slice(d, 2 * d)
            np.testing.assert_allclose(got[:, kb], w[:, kb], atol=LR / 20, rtol=0)
            got[:, kb] = w[:, kb] = init[:, kb]
        rel = np.linalg.norm((got - init) - (w - init)) / max(np.linalg.norm(w - init), 1e-30)
        assert rel <= 1e-3, (name, rel)
    # The expert stacks on each rank: 1/(ep * tp) of their bytes.
    for name, leaf in zip(leaf_paths(params0), state.leaves()):
        if name.endswith(("moe_in", "moe_out")):
            assert leaf.nbytes_per_rank() == [math.prod(leaf.shape) * 4 // 4] * 8


def test_gpt2_moe_grads_reach_experts_and_router_torch():
    """Counterpart of ``test_gpt2_moe_grads_reach_experts_and_router``."""
    bundle = get_model("gpt2_moe", **TINY)
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = bundle.make_batch(torch.Generator().manual_seed(1), 4)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = bundle.loss_fn(params, batch, torch.Generator())
    grads = dict(zip(leaf_paths(params), torch.autograd.grad(loss, leaves)))
    assert np.isfinite(float(loss.detach())) and float(metrics["aux_loss"].detach()) >= 0.99
    for leaf in ("router", "moe_in", "moe_out"):
        assert float(grads[f"blocks/moe/{leaf}"].abs().sum()) > 0, leaf


def test_loss_is_coupled_over_dp_groups():
    bundle = get_model("gpt2_moe", **TINY)
    assert getattr(bundle.loss_fn, "dp_coupled", False) and isinstance(bundle.loss_fn, common.CoupledLoss)
    assert not getattr(get_model("gpt2_small").loss_fn, "dp_coupled", False)


# -- the reference's test_moe.py on the port -----------------------------------


def _gelu(x):
    return common.gelu(x) if isinstance(x, torch.Tensor) else jax.nn.gelu(x)


REPLACED = {
    "test_gpt2_moe_grads_reach_experts_and_router":
        "jax.value_and_grad of a torch loss; see test_gpt2_moe_grads_reach_experts_and_router_torch",
}
REFERENCE = port_cases("test_moe.py", globals(), drop=REPLACED)
bind_shims(REFERENCE)
REFERENCE["jax"].nn = types.SimpleNamespace(gelu=_gelu, softmax=jax.nn.softmax, one_hot=jax.nn.one_hot)


def test_reference_cases_bind_the_port():
    assert count_cases(REFERENCE) + len(REPLACED) == 9
    assert REFERENCE["moe_ffn"] is moe.moe_ffn
