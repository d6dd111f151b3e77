"""llama_lora in the port against the JAX package, in f32 on the CPU.

A small Llama with grouped kv heads (``n_kv_heads < n_heads``, so
``_repeat_kv`` repeats each kv head consecutively), RoPE on interleaved lane
pairs, SwiGLU and LoRA adapters on q and v. The adapters' ``b`` start at 0
in the init; here they are set to small random values so every adapter leaf
has a gradient. Tolerances as in ``test_torch_models.py``: loss rtol 1e-5,
gradient leaves 1e-5 relative l2, params atol 5e-6 after three AdamW steps.

Also here: the frozen base (no gradient buffer, no optimizer moments, bit-
unchanged after training, and ``weight_decay > 0`` refused on it); the
payload the port ships (flatten order, bytes and averaging schema hash equal
to the reference's); a trainer that moves only the adapters in rounds,
snapshots, merges and pulls; an init that never holds the whole model in f32;
and one Byzantine round of one port and two reference averagers on f32
adapters.
"""

import asyncio
import types
import weakref

import jax
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu.ops import attention as jax_attention
from distributedvolunteercomputing_tpu.ops import mesh_codec as jax_mc
from distributedvolunteercomputing_tpu.swarm import averager as jax_avg
from distributedvolunteercomputing_tpu.swarm.dht import DHTNode as JaxDHTNode
from distributedvolunteercomputing_tpu.swarm.membership import SwarmMembership as JaxMembership
from distributedvolunteercomputing_tpu.swarm.transport import Transport as JaxTransport
from distributedvolunteercomputing_tpu.training.optim import make_optimizer as jax_make_optimizer
from distributedvolunteercomputing_tpu.training.steps import TrainState as JaxTrainState
from distributedvolunteercomputing_tpu.training.steps import make_train_step as jax_make_train_step
from distributedvolunteercomputing_tpu.utils.pytree import flatten_to_buffer as jax_flatten
from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.models import common, get_model
from distributedvolunteercomputing_tpu_torch.models.convert import params_from_jax
from distributedvolunteercomputing_tpu_torch.ops import attention
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
from distributedvolunteercomputing_tpu_torch.swarm import averager as port_avg
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.membership import SwarmMembership
from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport
from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
from distributedvolunteercomputing_tpu_torch.training.steps import TrainState, _value_and_grad, make_train_step
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer, tree_flatten, tree_leaves

LR = 1e-2
BATCH = 2
# max_len 256: the chunked loss walks two chunks of 128.
TINY = dict(vocab=128, max_len=256, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64, lora_rank=4)


def _np(tree):
    """Host copies (``np.asarray`` of a jax array may alias a donated buffer)."""
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _jax_copy(tree):
    return jax.tree_util.tree_map(lambda x: jax.numpy.array(x, copy=True), tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


@pytest.fixture(scope="module")
def reference():
    jb = jax_get_model("llama_lora", **TINY)
    params = _np(jax.jit(jb.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for ad in params["lora"]["blocks"].values():
        ad["b"] = (0.05 * rng.standard_normal(ad["b"].shape)).astype(np.float32)
    make_batch = jax.jit(jb.make_batch, static_argnums=1)
    batches = [_np(make_batch(jax.random.PRNGKey(10 + i), BATCH)) for i in range(3)]
    key = jax.random.PRNGKey(2)
    (loss, _), grads = jax.jit(jax.value_and_grad(jb.loss_fn, has_aux=True))(_jax_copy(params), batches[0], key)
    jtx = jax_make_optimizer("adamw", lr=LR, total_steps=3)
    jstep = jax_make_train_step(jb.loss_fn, jtx)
    jstate = JaxTrainState.create(_jax_copy(params), jtx, key)
    stepped = []
    for batch in batches:
        jstate, jm = jstep(jstate, batch)
        stepped.append((float(jm["loss"]), _np(jstate.params)))
    return {"bundle": jb, "params": params, "batches": batches, "loss": float(loss), "grads": _np(grads),
            "stepped": stepped}


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_and_adapter_grads_match_jax(reference, impl):
    bundle = get_model("llama_lora", **TINY)
    params = params_from_jax(reference["params"], "cpu")
    names = leaf_names(params)
    try:
        attention.set_attention_impl(impl)
        grads, metrics = _value_and_grad(bundle.loss_fn, params, _torch_batch(reference["batches"][0]),
                                         torch.Generator())
    finally:
        attention.set_attention_impl("auto")
    np.testing.assert_allclose(metrics["loss"].item(), reference["loss"], rtol=1e-5)
    ref_leaves, ref_def = tree_flatten(reference["grads"])
    assert ref_def == tree_flatten(params)[1]
    for name, g, r in zip(names, grads, ref_leaves):
        if name.startswith("base/"):
            # The reference's stop_gradient: zeros; the port: no buffer.
            assert g is None and not np.any(r), name
        else:
            diff = np.linalg.norm(g.double().numpy() - r)
            assert diff <= 1e-5 * np.linalg.norm(r) and np.linalg.norm(r) > 0, name


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_three_adamw_steps_match_jax_and_keep_the_base(reference, impl):
    bundle = get_model("llama_lora", **TINY)
    tx = make_optimizer("adamw", lr=LR, total_steps=3)
    state = TrainState.create(params_from_jax(reference["params"], "cpu"), tx, torch.Generator())
    base0 = [t.clone() for t in tree_leaves(state.params["base"])]
    step = make_train_step(bundle.loss_fn, tx)
    try:
        attention.set_attention_impl(impl)
        for i, (batch, (loss_ref, params_ref)) in enumerate(zip(reference["batches"], reference["stepped"])):
            state, m = step(state, _torch_batch(batch))
            np.testing.assert_allclose(float(m["loss"]), loss_ref, rtol=1e-5)
            for name, a, b in zip(leaf_names(state.params), tree_leaves(state.params),
                                  jax.tree_util.tree_leaves(params_ref)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-6, rtol=0, err_msg=f"step {i} {name}")
    finally:
        attention.set_attention_impl("auto")
    # The base is bit-unchanged (as the reference's: optax's zero update).
    for a, b, r in zip(tree_leaves(state.params["base"]), base0,
                       jax.tree_util.tree_leaves(reference["stepped"][-1][1]["base"])):
        assert torch.equal(a, b) and np.array_equal(a.numpy(), r)
    # Moments exist for the adapters only.
    names = leaf_names(state.params)
    for key in ("mu", "nu"):
        slots = state.opt_state[key]
        assert [s is None for s in slots] == [n.startswith("base/") for n in names]


def test_weight_decay_on_a_frozen_leaf_raises(reference):
    bundle = get_model("llama_lora", **TINY)
    params = params_from_jax(reference["params"], "cpu")
    tx = make_optimizer("adamw", lr=LR, weight_decay=0.1)
    step = make_train_step(bundle.loss_fn, tx)
    state = TrainState.create(params, tx, torch.Generator())
    before = [t.clone() for t in tree_leaves(params)]
    with pytest.raises(ValueError, match="weight_decay"):
        step(state, _torch_batch(reference["batches"][0]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), before))
    # Without a frozen leaf, weight decay is fine (optax's adamw).
    w = {"w": torch.ones(3)}
    tx.apply(w, [torch.ones(3)], tx.init(w))


def test_rope_pairs_interleaved_lanes():
    x = np.random.default_rng(0).standard_normal((2, 3, 7, 8)).astype(np.float32)
    got = attention.rope(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_attention.rope(jax.numpy.asarray(x))), rtol=1e-5, atol=1e-6)
    # Position 0 is the identity; lanes 0 and 1 rotate together.
    np.testing.assert_array_equal(got[:, :, 0], x[:, :, 0])
    pos = np.arange(7, dtype=np.float32)[:, None]
    np.testing.assert_allclose(got[..., 0], x[..., 0] * np.cos(pos[:, 0]) - x[..., 1] * np.sin(pos[:, 0]),
                               rtol=1e-5, atol=1e-6)


def test_repeat_kv_repeats_each_head_consecutively():
    from distributedvolunteercomputing_tpu.models import llama as jax_llama
    from distributedvolunteercomputing_tpu_torch.models import llama

    x = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(2, 3, 4, 2)
    got = llama._repeat_kv(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_llama._repeat_kv(jax.numpy.asarray(x), 2)))
    np.testing.assert_array_equal(got[:, 0], got[:, 1])


def test_payload_order_bytes_and_schema_equal_the_reference(reference):
    jb, params_np = reference["bundle"], reference["params"]
    bundle = get_model("llama_lora", **TINY)
    payload = Trainer._host_tree(bundle.avg_select(params_from_jax(params_np, "cpu")))
    buf, specs, _ = flatten_to_buffer(payload)
    ref_buf, ref_specs, _ = jax_flatten(jb.avg_select(params_np))
    assert buf.tobytes() == ref_buf.tobytes()
    assert [(s.shape, s.dtype) for s in specs] == [(tuple(s.shape), s.dtype) for s in ref_specs]
    assert leaf_names(payload) == [f"blocks/{a}/{b}" for a in ("q", "v") for b in ("a", "b")]
    for wire in ("f32", "bf16"):
        ns = "llama_lora/params"
        port = port_avg.SyncAverager._compute_schema(types.SimpleNamespace(_specs=specs, wire=wire, namespace=ns))
        ref = jax_avg.SyncAverager._compute_schema(types.SimpleNamespace(_specs=ref_specs, wire=wire, namespace=ns))
        assert port == ref


def test_trainer_moves_only_the_adapters(reference):
    """Rounds, snapshots, merges and pulls carry the ``avg_select`` subtree,
    the merge lands in the live adapter tensors, the base stays put, and the
    snapshot serves the bytes the reference's state sync would."""
    jb = reference["bundle"]
    seen = []

    def averager(payload, step):
        seen.append(payload)
        return jax.tree_util.tree_map(lambda x: np.asarray(x) + 1.0, payload)

    t = Trainer(get_model("llama_lora", **TINY), batch_size=BATCH, lr=LR, device="cpu", averager=averager,
                average_every=2)
    base_ids = [id(x) for x in tree_leaves(t.state.params["base"])]
    base0 = [x.clone() for x in tree_leaves(t.state.params["base"])]
    lora_ids = [id(x) for x in tree_leaves(t.state.params["lora"])]
    step0, snap0 = t.host_snapshot()
    assert step0 == 0 and leaf_names(snap0) == leaf_names(t.state.params["lora"])
    t.run(steps=2, log_every=0)
    assert len(seen) == 1 and leaf_names(seen[0]) == leaf_names(t.state.params["lora"])
    after = tree_leaves(t.state.params["lora"])
    assert [id(x) for x in after] == lora_ids and [id(x) for x in tree_leaves(t.state.params["base"])] == base_ids
    for got, sent in zip(after, tree_leaves(seen[0])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(sent) + 1.0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(t.state.params["base"]), base0))
    step, snap = t.host_snapshot()
    assert step == 2 and flatten_to_buffer(snap)[0].tobytes() == flatten_to_buffer(t.state.params["lora"])[0].tobytes()
    # The state-sync provider serves the snapshot: the bytes of the
    # reference's avg_select of its whole-tree snapshot of the same params.
    full_np = jax.tree_util.tree_map(lambda x: x.numpy().copy(), t.state.params)
    assert flatten_to_buffer(snap)[0].tobytes() == jax_flatten(jb.avg_select(full_np))[0].tobytes()
    # A pull adopts the subtree only.
    pulled = jax.tree_util.tree_map(lambda x: np.full(x.shape, 0.5, np.float32), snap)
    t.adopt_params(pulled, step=9)
    assert t.state.step == 9 and all(np.all(x.numpy() == 0.5) for x in tree_leaves(t.state.params["lora"]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(t.state.params["base"]), base0))
    with pytest.raises(ValueError, match="subtree"):
        t.adopt_params({"blocks": {"q": pulled["blocks"]["q"]}})


def test_init_never_holds_the_model_in_f32(monkeypatch):
    """With ``dtype``, every leaf is cast as it is made: the f32 tensors
    alive at once never exceed one stacked layer plus one top-level leaf."""
    alive, peak = weakref.WeakSet(), [0]
    normal = common._normal

    def tracked(gen, shape, scale):
        out = normal(gen, shape, scale)
        alive.add(out)
        peak[0] = max(peak[0], sum(x.numel() for x in alive if x.dtype == torch.float32))
        return out

    monkeypatch.setattr(common, "_normal", tracked)
    cfg = dict(TINY, n_layers=6)
    params = get_model("llama_lora", **cfg).init(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(params))
    d, f, v = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    d_kv = cfg["n_kv_heads"] * d // cfg["n_heads"]
    layer = 2 * d * d + 2 * d * d_kv + 3 * d * f
    assert peak[0] <= layer + v * d
    assert common.count_params(params) > 3 * (layer + v * d)


def test_dp_step_and_checkpoint_keep_frozen_leaves_empty(tmp_path):
    """The dp=2 step (two ranks on the CPU) makes no gradient or moments for
    the base either and matches the one-rank step; a checkpoint saves and
    restores the moments' None slots, into a fresh trainer too."""
    from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh
    from distributedvolunteercomputing_tpu_torch.training import checkpoint as ckpt

    def trainer(**kw):
        return Trainer(get_model("llama_lora", **TINY), batch_size=BATCH, lr=LR, device="cpu", seed=3, **kw)

    one, dp = trainer(), trainer(mesh=make_mesh(dp=2, devices=["cpu", "cpu"]))
    base0 = [x.clone() for x in tree_leaves(one.state.params["base"])]
    one.run(steps=2, log_every=0)
    dp.run(steps=2, log_every=0)
    names = leaf_names(one.state.params)
    assert [m is None for m in dp.state.opt_state["mu"]] == [n.startswith("base/") for n in names]
    for a, b in zip(tree_leaves(dp.state.params["base"]), base0):
        assert all(torch.equal(s, b) for s in a.shards)  # every rank's copy
    for a, b in zip(tree_leaves(dp.state.params["lora"]), tree_leaves(one.state.params["lora"])):
        np.testing.assert_allclose(a.full().numpy(), b.numpy(), atol=5e-6, rtol=0)
    ckpt.save(one, str(tmp_path))
    fresh = trainer()
    assert all(m is None for m in fresh.state.opt_state["mu"])
    assert ckpt.maybe_restore(fresh, str(tmp_path))
    for got, want in zip(fresh.state.opt_state["mu"] + fresh.state.opt_state["nu"],
                         one.state.opt_state["mu"] + one.state.opt_state["nu"]):
        assert (got is None and want is None) or (got is not want and torch.equal(got, want))
    assert fresh.state.step == 2


def test_volunteer_state_pull_moves_only_the_adapters(tmp_path):
    """A joining volunteer pulls the provider's snapshot: the adapters (and
    the step), in about the adapters' bytes; its base stays its own init,
    which every volunteer of the task shares (``init_seed``)."""
    import json

    from distributedvolunteercomputing_tpu_torch.swarm.volunteer import Volunteer, VolunteerConfig

    def cfg(pid, **kw):
        return VolunteerConfig(model="llama_lora", model_overrides=TINY, batch_size=BATCH, device="cpu",
                               wire="f32", averaging="sync", heartbeat_ttl=3.0, join_timeout=1.0,
                               gather_timeout=2.0, peer_id=pid, metrics_path=str(tmp_path / f"{pid}.jsonl"), **kw)

    async def main():
        a, b = Volunteer(cfg("provider")), Volunteer(cfg("joiner"))
        try:
            await a.start()
            _, snap = a.trainer.host_snapshot()
            a.trainer.adopt_params(jax.tree_util.tree_map(lambda x: np.full(x.shape, 0.25, np.float32), snap), step=5)
            await a.state_sync.announce()  # the provider's record now says step 5
            b.cfg.coordinator = "%s:%d" % a.transport.addr
            await b.start()
            return ([x.clone() for x in tree_leaves(a.trainer.state.params)],
                    int(b.trainer.state.step), b.trainer.state.params)
        finally:
            await asyncio.gather(a.stop(), b.stop())

    a_params, b_step, b_params = asyncio.run(asyncio.wait_for(main(), 60))
    assert b_step == 5 and all(np.all(x.numpy() == 0.25) for x in tree_leaves(b_params["lora"]))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(b_params), a_params))
    pulls = [json.loads(ln) for ln in (tmp_path / "joiner.jsonl").read_text().splitlines()]
    pull = [r for r in pulls if r.get("event") == "state_pull"][-1]
    adapter_bytes = 4 * common.count_params(b_params["lora"])
    assert pull["pulled"] and adapter_bytes <= pull["bytes"] < 2 * adapter_bytes + (64 << 10)
    assert 4 * common.count_params(b_params["base"]) > 10 * adapter_bytes


# -- one Byzantine round, port and reference, on f32 adapters ------------------


async def _byzantine_trio():
    vols, boot = [], None
    for i, kind in enumerate(("port", "ref", "ref")):
        if kind == "port":
            t = Transport()
            dht, mem_cls, cls, cdc = DHTNode(t), SwarmMembership, port_avg.ByzantineAverager, \
                mc.MeshCodec(device="cpu", backend="device")
        else:
            t = JaxTransport()
            dht, mem_cls, cls, cdc = JaxDHTNode(t), JaxMembership, jax_avg.ByzantineAverager, \
                jax_mc.MeshCodec(backend="host")
        await dht.start(bootstrap=[boot] if boot else None)
        boot = boot or t.addr
        mem = mem_cls(dht, f"vol{i}-{kind}", ttl=10.0)
        await mem.join()
        vols.append((t, dht, mem, cls(t, dht, mem, wire="f32", mesh_codec=cdc, join_timeout=6.0,
                                      gather_timeout=8.0, min_group=3, namespace="llama_lora/params")))
    return vols


async def _teardown(vols):
    # Port transport first; the two reference nodes drop their pools before
    # closing, or each close waits for the other (test_torch_protocols.py).
    from distributedvolunteercomputing_tpu.swarm.transport import _Conn

    for t, *_ in vols[1:]:
        for entry in list(t._conns.values()):
            entry.close() if isinstance(entry, _Conn) else entry.cancel()
        t._conns.clear()
    await asyncio.sleep(0.05)
    for t, _, mem, _ in vols:
        try:
            await asyncio.wait_for(mem.leave(), 5)
        except Exception:
            pass
        await asyncio.wait_for(t.close(), 5)


def test_mixed_byzantine_round_on_adapters(reference):
    """One port and two reference volunteers' adapters (the port's through
    its trainer's host payload, the references' through the reference
    bundle's ``avg_select``), trimmed mean on the f32 wire: every result is
    the coordinate median of the three payloads, bit for bit."""
    assert native.ensure_built()
    jb, params_np = reference["bundle"], reference["params"]
    rng = np.random.default_rng(11)
    full = [jax.tree_util.tree_map(lambda x: x + 0.01 * rng.standard_normal(x.shape).astype(np.float32),
                                   params_np) for _ in range(3)]
    bundle = get_model("llama_lora", **TINY)
    payloads = [Trainer._host_tree(bundle.avg_select(params_from_jax(full[0], "cpu")))]
    payloads += [jb.avg_select(p) for p in full[1:]]

    async def main():
        vols = await _byzantine_trio()
        try:
            return await asyncio.wait_for(
                asyncio.gather(*(v[3].average(payloads[i], 1) for i, v in enumerate(vols))), 60)
        finally:
            await _teardown(vols)

    results = asyncio.run(main())
    got = [flatten_to_buffer(r)[0] for r in results]
    want = np.median(np.stack([jax_flatten(p)[0] for p in payloads]), axis=0).astype(np.float32)
    assert all(g.tobytes() == want.tobytes() for g in got)
