"""The port's partition rules and placements (``parallel/sharding.py``)
against the JAX package's.

For every leaf of the tiny gpt2, bert, vit, llama+LoRA and gpt2_moe trees,
on the meshes dp2tp4, dp4tp2, dp2ep2tp2 and dp2pp2tp2 (the reference's
eight virtual CPU devices; the port's ranks are ``cpu`` named eight times),
the port's param, ZeRO-1 and FSDP specs equal the reference's, fallbacks
included (GPT-2's 50257-row head, the tied ``wte`` dp-sharded on its
feature dim, a ``[63]`` leaf that nothing divides). The leaves' paths and
shapes are the reference's too. ``Sharded.shard`` / ``assemble`` go between
a full leaf and its per-rank slices bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu.parallel import mesh as jax_mesh
from distributedvolunteercomputing_tpu.parallel import sharding as jax_sharding
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.parallel import mesh as pmesh
from distributedvolunteercomputing_tpu_torch.parallel import sharding as psharding
from distributedvolunteercomputing_tpu_torch.parallel.sharding import P, Sharded, ShardedTensor, leaf_paths
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves

MODELS = {
    "gpt2_small": dict(vocab=128, max_len=32, d_model=64, n_heads=4, n_layers=2, d_ff=128),
    "bert_mlm": dict(vocab=128, max_len=32, d_model=64, n_heads=4, n_layers=2, d_ff=128),
    "cifar10_vit": dict(d_model=64, n_heads=4, n_layers=2, d_ff=128),
    "llama_lora": dict(vocab=256, max_len=32, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128, lora_rank=4),
    "gpt2_moe": dict(vocab=128, max_len=16, d_model=32, n_heads=2, n_layers=2, d_ff=64, n_experts=4),
}
MESHES = {
    "dp2tp4": dict(dp=2, tp=4),
    "dp4tp2": dict(dp=4, tp=2),
    "dp2ep2tp2": dict(dp=2, ep=2, tp=2),
    "dp2pp2tp2": dict(dp=2, pp=2, tp=2),
}
KINDS = {
    "param": (jax_sharding.make_param_shardings, psharding.make_param_shardings),
    "zero1": (jax_sharding.make_zero1_opt_shardings, psharding.make_zero1_opt_shardings),
    "fsdp": (jax_sharding.make_fsdp_param_shardings, psharding.make_fsdp_param_shardings),
}
CPU8 = ["cpu"] * 8


class _Shape:
    def __init__(self, *shape):
        self.shape = shape


# The reference's fallback cases: a prime vocab on both embedding layouts
# and a leaf no mesh axis divides.
FALLBACK = {"wte": (50257, 64), "lm_head": (64, 50257), "ln_f": {"g": (63,)}}


def _jax_paths(tree):
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path))
    return out


def _port_tree(model):
    return get_model(model, **MODELS[model]).init(torch.Generator().manual_seed(0))


def _jax_tree(model):
    bundle = jax_get_model(model, **MODELS[model])
    return jax.eval_shape(lambda: bundle.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("model", list(MODELS) + ["fallback"])
def test_specs_match_reference(model, mesh_name):
    jmesh = jax_mesh.make_mesh(**MESHES[mesh_name])
    mesh = pmesh.make_mesh(**MESHES[mesh_name], devices=CPU8)
    if model == "fallback":
        jtree = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), FALLBACK,
                                       is_leaf=lambda x: isinstance(x, tuple))
        tree = {"wte": _Shape(*FALLBACK["wte"]), "lm_head": _Shape(*FALLBACK["lm_head"]),
                "ln_f": {"g": _Shape(*FALLBACK["ln_f"]["g"])}}
    else:
        jtree, tree = _jax_tree(model), _port_tree(model)
    paths = leaf_paths(tree)
    assert paths == _jax_paths(jtree)
    assert [tuple(x.shape) for x in tree_leaves(tree)] == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jtree)]
    for kind, (jfn, pfn) in KINDS.items():
        want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(jfn(jmesh, jtree))]
        got = [tuple(s.spec) for s in tree_leaves(pfn(mesh, tree))]
        assert got == want, {p: (g, w) for p, g, w in zip(paths, got, want) if g != w}
        for path, x in zip(paths, tree_leaves(tree)):
            assert tuple(psharding.partition_spec_for_path(path, tuple(x.shape), mesh)) == tuple(
                jax_sharding.partition_spec_for_path(path, tuple(x.shape), jmesh))


def test_fallback_specs_spelled_out():
    mesh = pmesh.make_mesh(dp=2, tp=4, devices=CPU8)
    tree = {"wte": _Shape(50257, 64), "lm_head": _Shape(64, 50257), "ln_f": {"g": _Shape(63)}}
    param = psharding.make_param_shardings(mesh, tree)
    zero1 = psharding.make_zero1_opt_shardings(mesh, tree)
    assert param["lm_head"].spec == P(None, None) and param["wte"].spec == P()
    assert zero1["wte"].spec == P(None, "dp") and zero1["lm_head"].spec == P("dp")
    assert zero1["ln_f"]["g"].spec == P()
    # The port's spec is a tuple that equals the reference's.
    assert P(None, "tp") == jax.sharding.PartitionSpec(None, "tp") and P(None) != P()


@pytest.mark.parametrize("kind", ["param", "fsdp"])
@pytest.mark.parametrize("mesh_name", ["dp2tp4", "dp2ep2tp2"])
def test_shard_and_assemble_are_bit_exact(mesh_name, kind):
    mesh = pmesh.make_mesh(**MESHES[mesh_name], devices=CPU8)
    tree = _port_tree("gpt2_moe")
    shardings = KINDS[kind][1](mesh, tree)
    for x, sh, path in zip(tree_leaves(tree), tree_leaves(shardings), leaf_paths(tree)):
        for full in (x, x.to(torch.bfloat16), x.numpy()):
            slices = sh.shard(full)
            assert all(tuple(s.shape) == sh.local_shape() for s in slices), path
            back = sh.assemble(slices)
            want = torch.as_tensor(full)
            assert back.dtype == want.dtype and torch.equal(back, want), path
        # Replicated over an axis: every rank of it holds the same copy.
        for holders in sh.holders().values():
            first = slices[holders[0]]
            assert all(np.array_equal(slices[r], first) for r in holders), path
        held = ShardedTensor.place(sh, x)
        n_distinct = len(sh.holders())
        assert sum(held.nbytes_per_rank()) == x.numel() * 4 * len(CPU8) // n_distinct, path
        np.testing.assert_array_equal(held.full().numpy(), x.numpy())


def test_sharded_tensor_reads_as_its_whole_value():
    """``full()`` is the whole value; torch and numpy refuse the leaf, so
    code that forgets the placement fails instead of assembling it."""
    mesh = pmesh.make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    x = torch.arange(24.0).reshape(2, 3, 4)
    held = ShardedTensor.place(Sharded(mesh, P("dp", None, "tp"), x.shape), x)
    assert [tuple(s.shape) for s in held.shards] == [(1, 3, 2)] * 4
    assert torch.equal(held.full(), x) and held.shape == x.shape and held.dtype == x.dtype
    assert held.nbytes_per_rank() == [6 * 4] * 4
    assert held.sharding.spec == P("dp", None, "tp")
    with pytest.raises(TypeError):
        torch.allclose(held, x)
    with pytest.raises(TypeError):
        torch.zeros_like(held)
    with pytest.raises(TypeError):
        np.asarray(held, np.float32)
    y = x + 1.0
    held.write(y.numpy())
    assert torch.equal(held.full(), y)
    with pytest.raises(ValueError, match="shape"):
        held.write(np.zeros((3, 3)))
