"""The port's sharded steps (``parallel/train_step.py``) against the JAX
package's, and the reference's own ``tests/test_parallel.py`` on the port.

From the same params (the port's init, as numpy) on the same batches (numpy,
from a seed), three clipped AdamW steps of the port's sharded step and of the
reference's ``make_sharded_train_step`` on the same mesh (the reference's
eight virtual CPU devices; the port's ranks are ``cpu`` named eight times):

- dp-only ZeRO-1 and FSDP: losses within 1e-5, params within 5e-6 after
  every step;
- tp (gpt2, llama with LoRA, llama with a kv head count tp does not divide)
  and FSDP and ZeRO-1 on a tp mesh: the same, and each leaf's first update
  within 1e-5 relative l2 of the reference's (later updates of a leaf whose
  gradient starts at 0, as LoRA's ``a`` behind ``b = 0``, are Adam-normalized
  rounding noise: held by the params' 5e-6);
- the key bias of the fused qkv is held loosely (lr / 20), as
  ``tests/test_torch_parallel.py`` does: its exact gradient is 0, and Adam
  turns rounding noise into updates of up to ~lr.

The moments stay on their dp slices under ZeRO-1 and FSDP, and FSDP's params
too. The reference's ``tests/test_parallel.py`` cases then run on the port
(``tests/torch_reference_cases.py``'s import-root rewrite) with ``jax`` in
their namespace a shim (``random.PRNGKey`` a seeded ``torch.Generator``,
``device_get`` the assembled numpy values; ``jnp.stack`` of torch tensors
is torch's, for the port's batches), ``make_mesh`` on eight CPU ranks and
``Trainer`` bound to the CPU. Replaced cases, each with its
counterpart below:

- ``TestZero1.test_moments_are_dp_sharded_and_numerics_match`` and
  ``TestZero1.test_second_step_and_donation`` find the moments by walking
  optax's named tuples for a ``mu`` attribute; the port's optimizer state is
  ``{"count", "mu", "nu"}`` with one slot per leaf (``training/optim.py``).
- ``TestLlama7BScale.test_7b_preset_shapes_and_fsdp_fit`` and
  ``test_7b_lora_payload_is_small`` trace the 7B init abstractly with
  ``jax.eval_shape``, which cannot trace a torch init; their counterparts
  take the shapes from the reference's abstract tree.
"""

import inspect
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_reference_cases import port_cases

from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu.parallel import mesh as jax_mesh
from distributedvolunteercomputing_tpu.parallel import train_step as jax_ts
from distributedvolunteercomputing_tpu.training.optim import make_optimizer as jax_make_optimizer
from distributedvolunteercomputing_tpu.training.steps import TrainState as JaxTrainState
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.models.convert import params_from_jax
from distributedvolunteercomputing_tpu_torch.parallel import mesh as pmesh
from distributedvolunteercomputing_tpu_torch.parallel import sharding as psharding
from distributedvolunteercomputing_tpu_torch.parallel import train_step as pts
from distributedvolunteercomputing_tpu_torch.parallel.sharding import P, ShardedTensor, leaf_paths
from distributedvolunteercomputing_tpu_torch.training import trainer as trainer_mod
from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
from distributedvolunteercomputing_tpu_torch.training.steps import TrainState, make_train_step
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves, tree_map

CPU8 = ["cpu"] * 8
LR = 1e-2
STEPS = 3
BATCH = 8
# remat on: FSDP gathers each layer inside its checkpointed body.
GPT2 = dict(vocab=128, max_len=32, d_model=64, n_heads=4, n_layers=2, d_ff=128, xent_chunk=16, remat=True)
LLAMA = dict(vocab=128, max_len=32, d_model=64, n_heads=4, n_kv_heads=4, n_layers=2, d_ff=128, lora_rank=4,
             remat=False)
# case -> (model, overrides, mesh axes, zero1, fsdp, how params are held)
CASES = {
    "dp2_zero1": ("gpt2_small", GPT2, dict(dp=2), True, False, "atol"),
    "dp2_fsdp": ("gpt2_small", GPT2, dict(dp=2), False, True, "atol"),
    "dp2tp2": ("gpt2_small", GPT2, dict(dp=2, tp=2), False, False, "update"),
    "dp2tp4_zero1": ("gpt2_small", GPT2, dict(dp=2, tp=4), True, False, "update"),
    "dp2tp2_fsdp": ("gpt2_small", GPT2, dict(dp=2, tp=2), False, True, "update"),
    "llama_lora_dp2tp2": ("llama_lora", LLAMA, dict(dp=2, tp=2), False, False, "update"),
    "llama_kv2_tp4": ("llama_lora", dict(LLAMA, n_kv_heads=2, lora_rank=0), dict(tp=4), False, False, "update"),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tiny models' CPU ops run several times faster on one intra-op
    thread; restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches(model, over):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        seq = rng.integers(0, over["vocab"], (BATCH, over["max_len"] + 1))
        out.append({"tokens": seq[:, :-1].astype(np.int32), "targets": seq[:, 1:].astype(np.int32)})
    return out


def _reference_run(model, over, axes, zero1, fsdp, params0, batches):
    """The reference's sharded step, compiled once per case: (losses,
    grad norms, params after each step as numpy)."""
    jb = jax_get_model(model, **over)
    jmesh = jax_mesh.make_mesh(**axes)
    jtx = jax_make_optimizer("adamw", lr=LR, total_steps=STEPS)
    state = JaxTrainState.create(jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), params0), jtx,
                                 jax.random.PRNGKey(1))
    state, _ = jax_ts.shard_train_state(state, jmesh, jtx, zero1=zero1, fsdp=fsdp)
    step = jax_ts.make_sharded_train_step(jb.loss_fn, jtx, jmesh, donate=False, zero1=zero1, fsdp=fsdp)
    losses, norms, params = [], [], []
    for b in batches:
        state, m = step(state, jax_ts.put_batch(b, jmesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        params.append([np.array(x, copy=True) for x in jax.tree_util.tree_leaves(state.params)])
    return losses, norms, params


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_reference(case):
    model, over, axes, zero1, fsdp, hold = CASES[case]
    bundle = get_model(model, **over)
    params0 = tree_map(lambda t: t.numpy(), bundle.init(torch.Generator().manual_seed(0)))
    batches = _batches(model, over)
    want_loss, want_norm, want_params = _reference_run(model, over, axes, zero1, fsdp, params0, batches)

    mesh = pmesh.make_mesh(**axes, devices=CPU8)
    tx = make_optimizer("adamw", lr=LR, total_steps=STEPS)
    state, shardings = pts.shard_train_state(
        TrainState.create(params_from_jax(params0, "cpu"), tx, torch.Generator()), mesh, zero1=zero1, fsdp=fsdp)
    step = pts.make_sharded_train_step(bundle.loss_fn, tx, mesh, zero1=zero1, fsdp=fsdp)
    names = leaf_paths(params0)
    p0 = tree_leaves(params0)
    d = over["d_model"]
    for i, b in enumerate(batches):
        tb = {k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}
        state, m = step(state, pts.put_batch(tb, mesh))
        np.testing.assert_allclose(float(m["loss"]), want_loss[i], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), want_norm[i], rtol=1e-5)
        for name, got, want, init in zip(names, tree_leaves(state.params), want_params[i], p0):
            got = got.full().numpy()
            want = want.copy()
            if name == "blocks/qkv/b":
                kb = slice(d, 2 * d)
                np.testing.assert_allclose(got[:, kb], want[:, kb], atol=LR / 20, rtol=0, err_msg=f"{case} key bias")
                got[:, kb] = want[:, kb] = init[:, kb]
            np.testing.assert_allclose(got, want, atol=5e-6, rtol=0, err_msg=f"{case} step {i} {name}")
            if hold == "update" and i == 0:
                u_got, u_want = got - init, want - init
                rel = np.linalg.norm(u_got - u_want) / max(np.linalg.norm(u_want), 1e-30)
                assert rel <= 1e-5, (case, name, rel)
    # Placement after the steps: FSDP's params and the moments on their dp slices.
    leaves = state.leaves()
    zero1_specs = tree_leaves(psharding.make_zero1_opt_shardings(mesh, params0))
    for leaf, sh, mu in zip(leaves, tree_leaves(shardings), state.opt_state["mu"]):
        assert leaf.sharding.spec == sh.spec
        if mu is not None and (zero1 or fsdp):
            assert mu.sharding.spec in [s.spec for s in zero1_specs]
    assert state.step == STEPS and state.opt_state["count"] == STEPS


def test_zero1_moments_are_dp_sharded_and_numerics_match():
    """The port's counterpart of ``TestZero1.test_moments_are_dp_sharded_and_numerics_match``
    and ``test_second_step_and_donation``: the qkv moment of a dp2tp4 ZeRO-1
    state is ("dp", None, "tp") at 1/8 of the leaf per rank, on dp4tp2 the
    layer axis does not divide and dp falls to d_in, and one step matches the
    one-device step."""
    bundle = get_model("gpt2_small", **GPT2)
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v).long() for k, v in _batches("gpt2_small", GPT2)[0].items()}
    tx = make_optimizer("adam", lr=1e-3)
    one = TrainState.create(tree_map(torch.clone, params), tx, torch.Generator())
    one, m1 = make_train_step(bundle.loss_fn, tx)(one, batch)
    qkv = leaf_paths(params).index("blocks/qkv/w")
    for axes, spec in ((dict(dp=2, tp=4), P("dp", None, "tp")), (dict(dp=4, tp=2), P(None, "dp", "tp"))):
        mesh = pmesh.make_mesh(**axes, devices=CPU8)
        tx2 = make_optimizer("adam", lr=1e-3)
        state, _ = pts.shard_train_state(TrainState.create(tree_map(torch.clone, params), tx2, torch.Generator()),
                                         mesh, zero1=True)
        step = pts.make_sharded_train_step(bundle.loss_fn, tx2, mesh, zero1=True)
        state, m = step(state, pts.put_batch(batch, mesh))
        mu = state.opt_state["mu"][qkv]
        assert mu.sharding.spec == spec and mu.shards[0].numel() == math.prod(mu.shape) // 8
        np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]), rtol=2e-4)
        np.testing.assert_allclose(mu.full().numpy(), one.opt_state["mu"][qkv].numpy(), rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(state.params["blocks"]["qkv"]["w"].full().numpy(),
                                   one.params["blocks"]["qkv"]["w"].numpy(), rtol=1e-3, atol=1e-5)
        state, m2 = step(state, pts.put_batch(batch, mesh))
        assert np.isfinite(float(m2["loss"])) and state.opt_state["mu"][qkv].sharding.spec == spec
        # Each rank's moment bytes: the leaf's over the ranks' distinct slices.
        per_rank = state.bytes_per_rank()
        assert max(per_rank["moments"]) < 2 * sum(x.numel() for x in tree_leaves(params)) * 4 // 2


def test_llama_7b_fsdp_specs_fit_on_the_reference_shapes():
    """Counterpart of the reference's ``TestLlama7BScale``: the port's FSDP
    specs on the 7B tree's shapes (the reference's ``jax.eval_shape``) put
    params and AdamW moments under 16 GB per rank of dp=8, and the LoRA
    payload the port's bundle selects is orders of magnitude smaller."""
    import dataclasses

    from distributedvolunteercomputing_tpu.models import llama as jax_llama

    cfg = jax_llama.LlamaConfig.llama2_7b()
    abstract = jax.eval_shape(lambda: jax_llama.init(jax.random.PRNGKey(0), cfg))
    mesh = pmesh.make_mesh(dp=8, devices=CPU8)
    sizes = pmesh.mesh_shape(mesh)
    total = per_rank = 0
    for leaf, sh in zip(jax.tree_util.tree_leaves(abstract), tree_leaves(psharding.make_fsdp_param_shardings(mesh, abstract))):
        n = int(np.prod(leaf.shape))
        denom = int(np.prod([sizes[a] for a in sh.spec if a is not None]))
        total += n
        per_rank += n // denom
    assert 6.5e9 < total < 7.2e9
    assert per_rank * 4 * 3 < 16e9 < total * 4
    bundle = get_model("llama_lora", **dataclasses.asdict(cfg))
    lora_abstract = jax.eval_shape(lambda: jax_get_model("llama_lora", **dataclasses.asdict(cfg)).init(
        jax.random.PRNGKey(0)))
    n_adapter = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(bundle.avg_select(lora_abstract)))
    n_all = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(lora_abstract))
    assert n_adapter < n_all / 500


# -- the reference's test_parallel.py on the port ------------------------------


def _host(x):
    """A tensor or a port leaf (assembled) as host numpy, bf16 as f32."""
    t = (x.full("cpu") if isinstance(x, ShardedTensor) else x).detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _device_get(tree):
    if isinstance(tree, dict):
        return {k: _device_get(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_device_get(v) for v in tree)
    if isinstance(tree, (ShardedTensor, torch.Tensor)):
        return _host(tree)
    return tree


def numpy_shim():
    """``numpy`` as the reference's cases see it: ``asarray`` and ``array``
    of a port leaf read its assembled value (a jax array's ``__array__``)."""
    shim = types.ModuleType("numpy")
    shim.__dict__.update(vars(np))
    shim.asarray = lambda a, *args, **kw: np.asarray(_host(a) if isinstance(a, ShardedTensor) else a, *args, **kw)
    shim.array = lambda a, *args, **kw: np.array(_host(a) if isinstance(a, ShardedTensor) else a, *args, **kw)
    return shim


@pytest.fixture(autouse=True)
def jax_array_surface(monkeypatch):
    """The rest of the jax array surface the reference's cases read off a
    port leaf, for one case: ``size`` and ``addressable_shards``."""
    monkeypatch.setattr(ShardedTensor, "size", property(lambda self: math.prod(self.shape)), raising=False)
    monkeypatch.setattr(ShardedTensor, "addressable_shards", property(
        lambda self: [types.SimpleNamespace(data=_host(s), device=s.device) for s in self.shards]), raising=False)


def jax_shim():
    """``jax`` as the reference's cases see it on the port."""
    shim = types.ModuleType("jax")
    shim.__dict__.update(vars(jax))
    shim.random = types.SimpleNamespace(
        PRNGKey=lambda seed: torch.Generator().manual_seed(int(seed)),
        normal=lambda gen, shape: torch.randn(shape, generator=gen),
    )
    shim.device_get = _device_get
    return shim


class CpuTrainer(trainer_mod.Trainer):
    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


def port_make_mesh(**axes):
    return pmesh.make_mesh(**axes, devices=CPU8)


def bind_shims(ns: dict) -> None:
    ns["jax"] = jax_shim()
    ns["np"] = numpy_shim()
    # jnp.stack stacks the port's batches as torch does.
    jnp_shim = types.ModuleType("jax.numpy")
    jnp_shim.__dict__.update(vars(jnp))
    jnp_shim.stack = lambda xs, *a, **k: torch.stack(xs) if isinstance(xs[0], torch.Tensor) else jnp.stack(xs, *a, **k)
    ns["jnp"] = jnp_shim
    ns["P"] = P
    if "make_mesh" in ns:
        ns["make_mesh"] = port_make_mesh


REPLACED = {
    "TestZero1.test_moments_are_dp_sharded_and_numerics_match":
        "walks optax's named tuples for mu; see test_zero1_moments_are_dp_sharded_and_numerics_match",
    "TestZero1.test_second_step_and_donation": "the same walk; the same counterpart",
    "TestLlama7BScale.test_7b_preset_shapes_and_fsdp_fit":
        "jax.eval_shape of a torch init; see test_llama_7b_fsdp_specs_fit_on_the_reference_shapes",
    "TestLlama7BScale.test_7b_lora_payload_is_small": "the same; the same counterpart",
}
REFERENCE = port_cases("test_parallel.py", globals(), drop=REPLACED)
bind_shims(REFERENCE)


@pytest.fixture(autouse=True)
def cpu_trainer(monkeypatch):
    """Cases that import Trainer in their body get the CPU-bound one."""
    monkeypatch.setattr(trainer_mod, "Trainer", CpuTrainer)


def test_reference_cases_bind_the_port():
    from torch_reference_cases import count_cases

    assert count_cases(REFERENCE) + len(REPLACED) == 23
    assert REFERENCE["shard_train_state"] is pts.shard_train_state
    assert inspect.getmodule(REFERENCE["make_sharded_train_step"]) is pts


# -- the entry script's mesh forms -----------------------------------------------

SCRIPT_FORMS = {
    "dp2tp2": (["--mesh", "dp=2,tp=2"], "gpt2_small", dict(dp=2, tp=2), False),
    "ep2tp2_moe": (["--mesh", "ep=2,tp=2"], "gpt2_moe", dict(ep=2, tp=2), False),
    "dp2_fsdp": (["--mesh", "dp=2", "--fsdp"], "gpt2_small", dict(dp=2), True),
}


@pytest.mark.parametrize("form", list(SCRIPT_FORMS))
def test_script_runs_the_mesh_forms(form, monkeypatch):
    """``run_volunteer_torch.py`` with ``--mesh`` over dp, tp and ep,
    ``--fsdp`` and ``--model gpt2_moe``: the volunteer's trainer holds the
    sharded state and steps (``run_volunteer`` replaced by a start, one step
    and a stop)."""
    import asyncio
    import json
    import runpy
    import sys
    from pathlib import Path

    from distributedvolunteercomputing_tpu_torch.swarm import volunteer as vol_mod

    argv, model, axes, fsdp = SCRIPT_FORMS[form]
    tiny = dict(n_layers=1, d_model=32, n_heads=2, d_ff=64, vocab=64, max_len=16)
    seen = []

    def run(cfg):
        async def main():
            vol = vol_mod.Volunteer(cfg)
            try:
                await vol.start()
                t = vol.trainer
                seen.append((pmesh.mesh_shape(t.mesh), t.fsdp, type(t.state).__name__,
                             t.run(steps=1, log_every=0)["final_loss"]))
            finally:
                await vol.stop()

        asyncio.run(asyncio.wait_for(main(), timeout=60))
        return {}

    monkeypatch.setattr(vol_mod, "run_volunteer", run)
    main = runpy.run_path(str(Path(__file__).resolve().parent.parent / "run_volunteer_torch.py"))["main"]
    monkeypatch.setattr(sys, "argv", [
        "run_volunteer_torch.py", "--model", model, "--batch-size", "4", "--device", "cpu", "--averaging", "none",
        *[a for k, v in tiny.items() for a in ("--model-override", f"{k}={json.dumps(v)}")], *argv,
    ])
    main()
    shape, got_fsdp, kind, loss = seen[0]
    assert {k: v for k, v in shape.items() if v > 1} == axes
    assert got_fsdp == fsdp and kind == "ShardedTrainState" and np.isfinite(loss)
