"""gpt2 in the port against the JAX package on carried-over params, in f32.

The JAX params (``gpt2.init``) go through ``models.convert.params_from_jax``;
both packages see the same batch. ``xent_chunk=16`` at T=64 makes the
chunked loss walk four chunks. The JAX side uses its XLA attention core (its
``auto`` on the CPU); the port runs both its plain core and its flash path
(the kernels' plain versions on the CPU), with remat on and off.

Tolerances: loss rtol 1e-5; every gradient atol 1e-5, rtol 1e-4 (f32, sums
taken in another order than XLA's).
"""

import jax
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.models.convert import params_from_jax
from distributedvolunteercomputing_tpu_torch.ops.attention import set_attention_impl
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_flatten

TINY = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=256, max_len=64, xent_chunk=16)


@pytest.fixture(scope="module")
def reference():
    bundle = jax_get_model("gpt2_small", **TINY, remat=False)
    params = bundle.init(jax.random.PRNGKey(0))
    batch = bundle.make_batch(jax.random.PRNGKey(1), 2)
    rng = jax.random.PRNGKey(2)
    (loss, _), grads = jax.jit(jax.value_and_grad(bundle.loss_fn, has_aux=True))(params, batch, rng)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(batch), float(loss), to_np(grads)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(reference, remat, impl):
    params_np, batch_np, loss_ref, grads_ref = reference
    bundle = get_model("gpt2_small", **TINY, remat=remat)
    params = params_from_jax(params_np, "cpu")
    leaves, treedef = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(np.array(v)).long() for k, v in batch_np.items()}
    try:
        set_attention_impl(impl)
        loss, metrics = bundle.loss_fn(params, batch, torch.Generator())
        grads = torch.autograd.grad(loss, leaves)
    finally:
        set_attention_impl("auto")
    assert metrics["loss"] is loss and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=1e-5)
    ref_leaves, ref_def = tree_flatten(grads_ref)
    assert ref_def == treedef
    for i, (g, r) in enumerate(zip(grads, ref_leaves)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=1e-4, err_msg=f"leaf {i}")


def test_full_logits_give_the_chunked_loss(reference):
    # forward() builds the [B, T, V] f32 logits the chunked loss never does.
    from distributedvolunteercomputing_tpu_torch.models import common, gpt2

    params_np, batch_np, loss_ref, _ = reference
    bundle = get_model("gpt2_small", **TINY)
    params = params_from_jax(params_np, "cpu")
    tokens = torch.from_numpy(np.array(batch_np["tokens"])).long()
    logits = gpt2.forward(params, tokens, bundle.config)
    assert logits.shape == (2, TINY["max_len"], TINY["vocab"]) and logits.dtype == torch.float32
    loss = common.softmax_xent(logits, torch.from_numpy(np.array(batch_np["targets"])).long())
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=1e-5)


def test_params_carry_over_leaf_for_leaf(reference):
    params_np = reference[0]
    params = params_from_jax(params_np, "cpu")
    ref_leaves, ref_def = tree_flatten(params_np)
    leaves, treedef = tree_flatten(params)
    assert treedef == ref_def
    for a, b in zip(leaves, ref_leaves):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    # bf16 leaves (ml_dtypes on the JAX side) carry over bit for bit.
    half = params_from_jax({"w": params_np["wpe"].astype(jax.numpy.bfloat16)}, "cpu")["w"]
    assert half.dtype == torch.bfloat16
    np.testing.assert_array_equal(half.float().numpy(), params_np["wpe"].astype(jax.numpy.bfloat16).astype(np.float32))
    # The port's own init builds the same tree (keys, shapes, dtypes).
    own = get_model("gpt2_small", **TINY).init(torch.Generator().manual_seed(0))
    own_leaves, own_def = tree_flatten(own)
    assert own_def == treedef
    assert [tuple(x.shape) for x in own_leaves] == [tuple(x.shape) for x in leaves]


def test_compute_dtype_as_scopes_the_override():
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import compute_dtype, compute_dtype_as

    cpu = torch.device("cpu")
    assert compute_dtype(cpu) == torch.float32
    with compute_dtype_as(torch.bfloat16):
        assert compute_dtype(cpu) == torch.bfloat16
        with pytest.raises(RuntimeError):
            with compute_dtype_as(torch.float32):
                assert compute_dtype(cpu) == torch.float32
                raise RuntimeError
        assert compute_dtype(cpu) == torch.bfloat16
    assert compute_dtype(cpu) == torch.float32
