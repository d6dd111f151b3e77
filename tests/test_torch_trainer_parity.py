"""The trainer's gradient mode, multi-step calls, evaluation, outer optimizer
and ``.npz`` data against the JAX package's, on the same params and batches.

The tiny gpt2 of ``tests/test_torch_train_step.py`` with clipped AdamW: both
trainers start from the reference trainer's init (copied into the port) and
draw the same batches (made with the JAX package, exported as numpy). Params
are held to atol 5e-6 after 3 steps, the key bias (whose gradient is rounding
noise that Adam normalizes) to lr / 20. The outer optimizer's Nesterov step,
its checkpoint sidecar and the ``.npz`` batches are host numpy on both sides
and are held bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu.training import checkpoint as jax_ckpt
from distributedvolunteercomputing_tpu.training.data import npz_batch_iter as jax_npz_batch_iter
from distributedvolunteercomputing_tpu.training.trainer import Trainer as JaxTrainer
from distributedvolunteercomputing_tpu.utils.pytree import flatten_to_buffer as jax_flatten
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh
from distributedvolunteercomputing_tpu_torch.parallel.sharding import ShardedTensor, assemble_tree
from distributedvolunteercomputing_tpu_torch.training import checkpoint as ckpt
from distributedvolunteercomputing_tpu_torch.training.data import npz_batch_iter
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer, tree_leaves

TINY = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=256, max_len=32, xent_chunk=16, remat=False)
LR = 1e-2
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tiny models' CPU ops run several times faster on one intra-op
    thread than spread over many cores; restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def shared():
    """The reference's init (init_seed 0) and batches, as numpy; the key-bias
    mask of the flat buffer."""
    jb = jax_get_model("gpt2_small", **TINY)
    params0 = _np(jb.init(jax.random.PRNGKey(0)))
    make_batch = jax.jit(jb.make_batch, static_argnums=1)
    batches = [_np(make_batch(jax.random.PRNGKey(10 + i), 2)) for i in range(8)]
    buf, specs, _ = jax_flatten(params0)
    key_bias = np.zeros(buf.size, bool)
    off = 0
    for name, spec in zip(_leaf_names(params0), specs):
        if name == "blocks/qkv/b":
            kb = np.zeros(spec.shape, bool)
            kb[:, TINY["d_model"] : 2 * TINY["d_model"]] = True
            key_bias[off : off + spec.size] = kb.ravel()
        off += spec.size
    return {"jb": jb, "params0": params0, "batches": batches, "key_bias": key_bias}


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _torch_batches(batches):
    return [{k: torch.from_numpy(np.array(v)).long() for k, v in b.items()} for b in batches]


def _port_trainer(shared, **kw):
    t = Trainer(get_model("gpt2_small", **TINY), batch_size=2, optimizer="adamw", lr=LR, total_steps=STEPS,
                device="cpu", **kw)
    with torch.no_grad():
        for p, v in zip(tree_leaves(t.state.params), jax.tree_util.tree_leaves(shared["params0"])):
            v = torch.from_numpy(np.array(v))
            if isinstance(p, ShardedTensor):
                p.write(v)  # every rank's slice
            else:
                p.copy_(v)
    return t


def _jax_trainer(shared, **kw):
    t = JaxTrainer(shared["jb"], batch_size=2, optimizer="adamw", lr=LR, total_steps=STEPS, **kw)
    # The reference trainer's init is params0 already (init_seed 0).
    assert np.array_equal(jax_flatten(_np(t.state.params))[0], jax_flatten(shared["params0"])[0])
    return t


def _assert_close(got, want, key_bias, msg):
    got, want = got.copy(), want.copy()
    np.testing.assert_allclose(got[key_bias], want[key_bias], atol=LR / 20, rtol=0, err_msg=f"{msg} key bias")
    got[key_bias] = want[key_bias] = 0.0
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0, err_msg=msg)


def _flat(trainer, jax_side=False):
    if jax_side:
        return jax_flatten(_np(trainer.state.params))[0]
    return flatten_to_buffer(assemble_tree(trainer.state.params))[0]


def _averager(kind, other, record):
    """identity, or the mean with a fixed second member's gradients."""

    def cb(grads, step):
        record.append(step)
        if kind == "identity":
            return grads
        return jax.tree_util.tree_map(lambda g, o: (np.asarray(g, np.float32) + o) / np.float32(2), grads, other)

    return cb


def _other_member(shared):
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda p: (0.05 * rng.standard_normal(p.shape)).astype(np.float32), shared["params0"]
    )


@pytest.mark.parametrize("kind", ["identity", "mean"])
def test_grads_mode_matches_reference(shared, kind):
    other = _other_member(shared)
    jrec, trec = [], []
    jt = _jax_trainer(shared, data=iter(shared["batches"][:STEPS]), averager=_averager(kind, other, jrec),
                      average_what="grads", average_every=1)
    tt = _port_trainer(shared, data=iter(_torch_batches(shared["batches"][:STEPS])),
                       averager=_averager(kind, other, trec), average_what="grads", average_every=1)
    jt.run(steps=STEPS, log_every=0)
    tt.run(steps=STEPS, log_every=0)
    assert trec == jrec == [1, 2, 3] and tt.state.step == STEPS
    _assert_close(_flat(tt), _flat(jt, True), shared["key_bias"], f"params after {STEPS} grads-mode steps")


def test_grads_mode_on_a_dp_mesh_matches_one_rank(shared):
    """dp=2 (both ranks on the CPU): the ranks' mean gradients go through
    the round, every replica applies the result."""
    other = _other_member(shared)
    payloads = {}

    def recording(key):
        inner = _averager("mean", other, [])

        def cb(grads, step):
            payloads.setdefault(key, []).append(flatten_to_buffer(grads)[0])
            return inner(grads, step)

        return cb

    one = _port_trainer(shared, data=iter(_torch_batches(shared["batches"][:STEPS])),
                        averager=recording("one"), average_what="grads", average_every=1)
    dp = _port_trainer(shared, data=iter(_torch_batches(shared["batches"][:STEPS])),
                       averager=recording("dp"), average_what="grads", average_every=1,
                       mesh=make_mesh(dp=2, devices=["cpu", "cpu"]))
    one.run(steps=STEPS, log_every=0)
    dp.run(steps=STEPS, log_every=0)
    for a, b in zip(payloads["dp"], payloads["one"]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
    _assert_close(_flat(dp), _flat(one), shared["key_bias"], "dp=2 vs one rank")
    assert all(torch.equal(*leaf.shards) for leaf in dp.state.leaves())


def test_multi_step_matches_single_steps_and_reference(shared):
    n = 6  # chunks of 4 and 2 at steps_per_call=4
    batches = shared["batches"][:n]
    single = _port_trainer(shared, data=iter(_torch_batches(batches)))
    multi = _port_trainer(shared, data=iter(_torch_batches(batches)), steps_per_call=4)
    jt = _jax_trainer(shared, data=iter(batches), steps_per_call=4)
    single.run(steps=n, log_every=0)
    multi.run(steps=n, log_every=0)
    jt.run(steps=n, log_every=0)
    assert multi.state.step == n
    assert np.array_equal(_flat(multi).view(np.uint32), _flat(single).view(np.uint32))
    _assert_close(_flat(multi), _flat(jt, True), shared["key_bias"], "steps_per_call=4 vs the reference")


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_evaluate_matches_reference(shared, accum_steps):
    eval_batches = shared["batches"][5:8]
    jt = _jax_trainer(shared, accum_steps=accum_steps, eval_data=list(eval_batches))
    tt = _port_trainer(shared, accum_steps=accum_steps, eval_data=_torch_batches(eval_batches))
    got, want = tt.evaluate(3), jt.evaluate(3)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # Params untouched.
    assert np.array_equal(_flat(tt), jax_flatten(shared["params0"])[0])


def _mlp_pair(**kw):
    jt = JaxTrainer(jax_get_model("mnist_mlp", d_hidden=16), batch_size=4, **kw)
    tt = Trainer(get_model("mnist_mlp", d_hidden=16), batch_size=4, device="cpu", **kw)
    return jt, tt


def _rounds(payload, n, seed=4):
    rng = np.random.default_rng(seed)
    return [
        jax.tree_util.tree_map(lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape)).astype(np.float32),
                               payload)
        for _ in range(n)
    ]


def _bits_equal(a, b):
    fa, fb = jax_flatten(_np(a))[0], jax_flatten(_np(b))[0]
    return np.array_equal(fa.view(np.uint32), fb.view(np.uint32))


def test_outer_transform_matches_reference_bit_for_bit():
    kw = dict(outer_optimizer="nesterov", averager=lambda p, s: None)
    jt, tt = _mlp_pair(**kw)
    _, payload = tt.host_snapshot()
    for i, avg in enumerate(_rounds(payload, 4)):
        got = tt._outer_transform(jax.tree_util.tree_map(np.copy, avg))
        want = jt._outer_transform(jax.tree_util.tree_map(np.copy, avg))
        assert _bits_equal(got, want), f"round {i + 1}"
        if i == 0:
            assert _bits_equal(got, avg)  # round 1 adopts the plain average
    assert _bits_equal(tt._outer_m, jt._outer_m)
    # An adoption re-seeds the outer state on both.
    tt.adopt_params(payload)
    jt.adopt_params(jt.state.params)
    assert tt._outer_anchor is tt._outer_m is jt._outer_anchor is jt._outer_m is None
    # lr 1, momentum 0 is plain averaging, up to the rounding of a - (a - v).
    plain = Trainer(get_model("mnist_mlp", d_hidden=16), batch_size=4, device="cpu", outer_optimizer="nesterov",
                    outer_lr=1.0, outer_momentum=0.0)
    rounds = _rounds(payload, 3, seed=5)
    for avg in rounds:
        out = plain._outer_transform(avg)
    np.testing.assert_allclose(jax_flatten(out)[0], jax_flatten(rounds[-1])[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_outer_sidecar_is_compatible_both_ways(tmp_path, writer):
    kw = dict(outer_optimizer="nesterov", averager=lambda p, s: None)
    jt, tt = _mlp_pair(**kw)
    _, payload = tt.host_snapshot()
    for avg in _rounds(payload, 3):
        tt._outer_transform(jax.tree_util.tree_map(np.copy, avg))
        jt._outer_transform(jax.tree_util.tree_map(np.copy, avg))
    snap = str(tmp_path / "step_3")
    src, dst = (tt, jt) if writer == "port" else (jt, tt)
    (ckpt if writer == "port" else jax_ckpt)._save_outer_state(src, snap)
    anchor, m = src._outer_anchor, src._outer_m
    with np.load(snap + ".outer.npz") as d:
        assert sorted(d.files) == ["anchor", "m"] and d["anchor"].dtype == d["m"].dtype == np.float32
        assert np.array_equal(d["anchor"], jax_flatten(_np(anchor))[0])
    dst._outer_anchor = dst._outer_m = None
    (jax_ckpt if writer == "port" else ckpt)._maybe_restore_outer_state(dst, snap)
    assert _bits_equal(dst._outer_anchor, anchor) and _bits_equal(dst._outer_m, m)


def test_outer_state_round_trips_through_a_checkpoint(tmp_path):
    t = Trainer(get_model("mnist_mlp", d_hidden=16), batch_size=4, device="cpu", outer_optimizer="nesterov",
                averager=lambda p, s: None)
    _, payload = t.host_snapshot()
    for avg in _rounds(payload, 2):
        t._outer_transform(avg)
    anchor, m = t._outer_anchor, t._outer_m
    path = ckpt.save(t, str(tmp_path))
    t._outer_anchor = t._outer_m = None
    assert ckpt.maybe_restore(t, str(tmp_path)) and (tmp_path / "step_0.outer.npz").exists()
    assert path.endswith("step_0")
    assert _bits_equal(t._outer_anchor, anchor) and _bits_equal(t._outer_m, m)


def test_npz_batches_are_byte_equal_to_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "d.npz")
    np.savez(path, x=rng.standard_normal((40, 28, 28, 1)).astype(np.float32), y=rng.integers(0, 10, 40))
    ours, ref = npz_batch_iter(path, 8, seed=7), jax_npz_batch_iter(path, 8, seed=7)
    for _ in range(12):  # two and a half passes: the reshuffles too
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes()
