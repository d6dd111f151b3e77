"""The port's model zoo against the JAX package's, in f32 on the CPU.

mnist_mlp, cifar10_resnet18, cifar10_vit and bert_mlm at small widths: the
JAX params (``bundle.init``) go through ``models.convert.params_from_jax``
and both packages see the reference's batch. Per model: the loss and every
gradient leaf, then the params after three AdamW steps
(``make_optimizer("adamw", lr, total_steps=3)``: rates 0, lr, lr/2) on three
reference batches. The attention models run the port's plain core and its
flash path (the kernels' plain versions on the CPU).

Tolerances, as for gpt2: loss rtol 1e-5; each gradient leaf within 1e-5 of
the reference's in relative l2; params atol 5e-6 after three steps. The key
bias of a fused qkv projection is held to atol lr / 20 there: its exact
gradient is 0 (softmax ignores a per-row shift), so both sides hold rounding
noise that Adam turns into updates of up to ~lr (tests/test_torch_train_step.py).

ResNet runs on the 32x32 images of its task and on 9x9 and 10x10 images:
stride-2 convs on odd and even sizes, where XLA's SAME padding is
asymmetric (0 before, 1 after on an even size), and a stride-2 block
without a projection (its subsampling branch).

Also here: the image prototypes committed in the port equal the reference's,
the port's batches have the reference's shapes and task, and the entry
script runs its default model (mnist_mlp) on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu.training import data as jax_data
from distributedvolunteercomputing_tpu.training.optim import make_optimizer as jax_make_optimizer
from distributedvolunteercomputing_tpu.training.steps import TrainState as JaxTrainState
from distributedvolunteercomputing_tpu.training.steps import make_train_step as jax_make_train_step
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.models.convert import params_from_jax
from distributedvolunteercomputing_tpu_torch.ops.attention import set_attention_impl
from distributedvolunteercomputing_tpu_torch.training import data
from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
from distributedvolunteercomputing_tpu_torch.training.steps import TrainState, _value_and_grad, make_train_step
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_flatten, tree_leaves

REPO = Path(__file__).resolve().parent.parent
LR = 1e-2
BATCH = 2
TINY = {
    "mnist_mlp": dict(d_hidden=32),
    "cifar10_resnet18": dict(stage_sizes=(1, 1, 1), widths=(8, 16, 16), stem_width=8, groups=2),
    "cifar10_vit": dict(image_size=8, patch_size=4, d_model=32, n_heads=2, n_layers=2, d_ff=64),
    # max_len 256: the chunked loss walks two chunks of 128.
    "bert_mlm": dict(vocab=128, max_len=256, d_model=32, n_heads=2, n_layers=2, d_ff=64),
}
ATTENTION = ("cifar10_vit", "bert_mlm")


def _np(tree):
    """Host copies: on the CPU ``np.asarray`` of a jax array may alias its
    buffer, which the jitted step's donation then frees or overwrites."""
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _jax_copy(tree):
    """Device arrays that own their memory: the jitted step donates its
    state, and an array aliasing a numpy leaf would be written in place."""
    return jax.tree_util.tree_map(lambda x: jax.numpy.array(x, copy=True), tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def assert_grads_close(grads, ref, names, rel=1e-5):
    """Each leaf within ``rel`` of the reference's in relative l2."""
    assert len(grads) == len(ref)
    for name, g, r in zip(names, grads, ref):
        r = np.asarray(r, np.float64)
        assert g is not None and tuple(g.shape) == r.shape, name
        diff = np.linalg.norm(g.detach().double().numpy() - r)
        assert diff <= rel * np.linalg.norm(r) + 1e-12, f"{name}: |d| {diff:.3g} vs |g| {np.linalg.norm(r):.3g}"


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def assert_params_close(params, jparams, d_model=None, msg=""):
    """atol 5e-6; the qkv key bias (``d_model``) atol lr / 20 (module doc)."""
    names = leaf_names(params)
    for name, a, b in zip(names, tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        x, y = a.detach().numpy().copy(), np.array(b)
        if d_model and name.endswith("qkv/b"):
            kb = slice(d_model, 2 * d_model)
            np.testing.assert_allclose(x[:, kb], y[:, kb], atol=LR / 20, rtol=0, err_msg=f"{msg} {name} key bias")
            x[:, kb] = y[:, kb] = 0.0
        np.testing.assert_allclose(x, y, atol=5e-6, rtol=0, err_msg=f"{msg} {name}")


def reference_run(name, overrides, extra_batches=()):
    """The JAX side: params, batches, loss and grads on the first batch, and
    the params after each of three AdamW steps."""
    jb = jax_get_model(name, **overrides)
    params = _np(jax.jit(jb.init)(jax.random.PRNGKey(0)))
    make_batch = jax.jit(jb.make_batch, static_argnums=1)
    batches = [_np(make_batch(jax.random.PRNGKey(10 + i), BATCH)) for i in range(3)]
    rng = jax.random.PRNGKey(2)
    grad_fn = jax.jit(jax.value_and_grad(jb.loss_fn, has_aux=True))
    evals = []
    for batch in [batches[0], *extra_batches]:
        (loss, _), grads = grad_fn(_jax_copy(params), batch, rng)
        evals.append((float(loss), _np(grads)))
    jtx = jax_make_optimizer("adamw", lr=LR, total_steps=3)
    jstep = jax_make_train_step(jb.loss_fn, jtx)
    jstate = JaxTrainState.create(_jax_copy(params), jtx, rng)
    stepped = []
    for batch in batches:
        jstate, jm = jstep(jstate, batch)
        stepped.append((float(jm["loss"]), _np(jstate.params)))
    return {"params": params, "batches": batches, "extra": list(extra_batches), "evals": evals, "stepped": stepped}


def _odd_even_images():
    rng = np.random.default_rng(3)
    return [
        {"x": rng.standard_normal((BATCH, side, side, 3)).astype(np.float32),
         "y": rng.integers(0, 10, BATCH).astype(np.int32)}
        for side in (9, 10)
    ]


class _References(dict):
    """name -> ``reference_run``, made at first use (JAX compiles are slow)."""

    def __missing__(self, name):
        extra = _odd_even_images() if name == "cifar10_resnet18" else ()
        self[name] = reference_run(name, TINY[name], extra)
        return self[name]


@pytest.fixture(scope="module")
def references():
    return _References()


CASES = [(n, impl) for n in TINY for impl in (("xla", "flash") if n in ATTENTION else ("xla",))]


@pytest.mark.parametrize("name,impl", CASES)
def test_loss_and_grads_match_jax(references, name, impl):
    ref = references[name]
    bundle = get_model(name, **TINY[name])
    params = params_from_jax(ref["params"], "cpu")
    names = leaf_names(params)
    try:
        set_attention_impl(impl)
        for batch, (loss_ref, grads_ref) in zip([ref["batches"][0], *ref["extra"]], ref["evals"]):
            grads, metrics = _value_and_grad(bundle.loss_fn, params, _torch_batch(batch), torch.Generator())
            np.testing.assert_allclose(metrics["loss"].item(), loss_ref, rtol=1e-5)
            ref_leaves, ref_def = tree_flatten(grads_ref)
            assert ref_def == tree_flatten(params)[1]
            assert_grads_close(grads, ref_leaves, names)
    finally:
        set_attention_impl("auto")


@pytest.mark.parametrize("name,impl", CASES)
def test_three_adamw_steps_match_jax(references, name, impl):
    ref = references[name]
    bundle = get_model(name, **TINY[name])
    tx = make_optimizer("adamw", lr=LR, total_steps=3)
    state = TrainState.create(params_from_jax(ref["params"], "cpu"), tx, torch.Generator())
    step = make_train_step(bundle.loss_fn, tx)
    d_model = TINY[name].get("d_model") if name in ATTENTION else None
    try:
        set_attention_impl(impl)
        for i, (batch, (loss_ref, params_ref)) in enumerate(zip(ref["batches"], ref["stepped"])):
            state, m = step(state, _torch_batch(batch))
            np.testing.assert_allclose(float(m["loss"]), loss_ref, rtol=1e-5)
            assert_params_close(state.params, params_ref, d_model, f"step {i}")
    finally:
        set_attention_impl("auto")


def test_resnet_pads_as_xla_same():
    from distributedvolunteercomputing_tpu_torch.models.resnet import _same_pad

    # 3x3 stride 2: even sizes pad (0, 1), odd sizes (1, 1); stride 1 (1, 1);
    # a 1x1 stride-2 projection pads nothing.
    assert [_same_pad(n, 3, 2) for n in (32, 16, 10, 9, 5)] == [(0, 1), (0, 1), (0, 1), (1, 1), (1, 1)]
    assert _same_pad(32, 3, 1) == (1, 1) and _same_pad(32, 1, 2) == (0, 0) and _same_pad(9, 1, 2) == (0, 0)


@pytest.mark.parametrize("shape", [(28, 28, 1), (32, 32, 3)])
def test_committed_prototypes_equal_the_reference(shape):
    ref = np.asarray(jax_data._image_prototypes(shape, 10))
    got = data.image_prototypes(shape, 10)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", list(TINY))
def test_batches_have_the_reference_schema(name):
    jb = jax_get_model(name, **TINY[name])
    want = _np(jb.make_batch(jax.random.PRNGKey(0), 4))
    got = get_model(name, **TINY[name]).make_batch(torch.Generator().manual_seed(0), 4)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].is_floating_point() == np.issubdtype(want[k].dtype, np.floating), k
    if "y" in got:
        # The same task: each image is its class prototype plus noise 0.3.
        protos = data.image_prototypes(tuple(got["x"].shape[1:]), 10)
        resid = got["x"] - protos.index_select(0, got["y"])
        assert 0.2 < resid.std().item() < 0.4
    if "mask" in got:
        masked = got["mask"].bool()
        assert torch.equal(got["tokens"][masked], torch.full_like(got["tokens"][masked], 103))
        assert torch.equal(got["tokens"][~masked], got["targets"][~masked])


def test_init_casts_each_leaf_as_made():
    # The same bits as an f32 init cast afterwards, and no f32 leaf left.
    bundle = get_model("bert_mlm", **TINY["bert_mlm"])
    f32 = bundle.init(torch.Generator().manual_seed(0))
    half = bundle.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    for a, b in zip(tree_leaves(f32), tree_leaves(half)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b)


def test_entry_script_default_model_runs_on_the_cpu(tmp_path):
    # No --model: the reference's default, mnist_mlp.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, str(REPO / "run_volunteer_torch.py"), "--device", "cpu", "--averaging", "none",
         "--steps", "2", "--metrics", str(tmp_path / "m.jsonl")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("VOLUNTEER_DONE ")]
    summary = json.loads(done[-1].split(" ", 1)[1])
    assert summary["steps"] == 2
    assert "mnist_mlp" in subprocess.run(
        [sys.executable, str(REPO / "run_volunteer_torch.py"), "--list-models"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120, check=True,
    ).stdout.split()


ENTRY_OVERRIDES = {
    "mnist_mlp": {"d_hidden": 16},
    "cifar10_resnet18": {"widths": [8, 16, 16, 16], "stem_width": 8, "groups": 2},
    "cifar10_vit": {"n_layers": 1, "d_model": 16, "n_heads": 2, "d_ff": 32},
    "bert_mlm": {"n_layers": 1, "d_model": 16, "n_heads": 2, "d_ff": 32, "vocab": 128, "max_len": 16},
    "llama_lora": {"n_layers": 1, "d_model": 16, "n_heads": 2, "n_kv_heads": 1, "d_ff": 32, "vocab": 64,
                   "max_len": 16, "lora_rank": 2},
}


@pytest.mark.parametrize("name", sorted(ENTRY_OVERRIDES))
def test_entry_script_flags_reach_every_bundle(name, monkeypatch):
    """``--model``, ``--model-override`` and ``--param-dtype`` of
    ``run_volunteer_torch.py`` reach the volunteer's config, and the trainer
    built from it has those widths in bf16."""
    import runpy

    from distributedvolunteercomputing_tpu_torch.swarm import volunteer
    from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer

    seen = []
    monkeypatch.setattr(volunteer, "run_volunteer", lambda cfg: seen.append(cfg) or {})
    argv = ["run_volunteer_torch.py", "--model", name, "--param-dtype", "bfloat16", "--device", "cpu"]
    for k, v in ENTRY_OVERRIDES[name].items():
        argv += ["--model-override", f"{k}={json.dumps(v)}"]
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_path(str(REPO / "run_volunteer_torch.py"), run_name="__main__")
    (cfg,) = seen
    assert cfg.model == name and cfg.param_dtype == "bfloat16"
    bundle = get_model(cfg.model, **cfg.model_overrides)
    for k, v in ENTRY_OVERRIDES[name].items():
        got = getattr(bundle.config, k)
        assert (list(got) if isinstance(got, tuple) else got) == v, k
    trainer = Trainer(bundle, batch_size=2, param_dtype=cfg.param_dtype, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(trainer.state.params))
    assert np.isfinite(trainer.run(steps=1, log_every=0)["final_loss"])
