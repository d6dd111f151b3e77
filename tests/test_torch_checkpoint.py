"""The port's checkpoints (``training/checkpoint.py``, on ``torch.save``)
against the reference's semantics (``distributedvolunteercomputing_tpu/
training/checkpoint.py``, on orbax).

A save then a restore gives back the train state bit for bit: params, AdamW
moments and count, step and the step generator's state, on one device and
into both replicas of a dp=2 mesh trainer. The directory keeps the
reference's ``step_N`` layout and keep-last-N collection: the port's
``_gc`` is held to the reference's on the same listings, a stale higher
step is never deleted, and a snapshot is renamed into place whole. Also:
``save_async`` copies the state (a later in-place step does not reach the
file), skips while its write runs, and ``wait_pending_saves`` drains it or
gives up at its cap; a restore re-applies the trainer's ``param_dtype``;
the volunteer's final save is skipped only when the last periodic save
holds the current state. The tiny gpt2 of
``tests/test_torch_train_step.py`` on the CPU.
"""

import asyncio
import os
import threading

import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu.training import checkpoint as jax_ckpt
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh
from distributedvolunteercomputing_tpu_torch.swarm.volunteer import Volunteer, VolunteerConfig
from distributedvolunteercomputing_tpu_torch.training import checkpoint as ckpt
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves

TINY = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=256, max_len=32, xent_chunk=16, remat=False)


def _trainer(seed=1, **kw):
    kw.setdefault("device", "cpu")
    return Trainer(get_model("gpt2_small", **TINY), batch_size=2, optimizer="adamw", lr=1e-2, seed=seed, **kw)


def _state_tensors(trainer, rank=0):
    """Every tensor of the train state in a fixed order, and the plain values:
    the state's own, or one rank's slices of a mesh trainer's."""
    st = trainer.state
    if trainer.mesh is None:
        tensors = tree_leaves(st.params) + list(st.opt_state["mu"]) + list(st.opt_state["nu"])
        return tensors, (st.opt_state["count"], st.step, st.rng.get_state())
    leaves = st.leaves() + list(st.opt_state["mu"]) + list(st.opt_state["nu"])
    return [x.shards[rank] for x in leaves], (st.opt_state["count"], st.step, st.rngs[rank].get_state())


def _assert_state_equal(a, b, rank_b=0):
    ta, (ca, sa, ra) = _state_tensors(a)
    tb, (cb, sb, rb) = _state_tensors(b, rank_b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y.to(x.device))
    assert (ca, sa) == (cb, sb)
    assert torch.equal(ra, rb)


def test_save_then_restore_is_bit_equal(tmp_path):
    t1 = _trainer()
    t1.run(steps=3, log_every=0)
    path = ckpt.save(t1, str(tmp_path))
    assert os.path.basename(path) == "step_3" and os.path.isfile(os.path.join(path, ckpt.STATE_FILE))
    t2 = _trainer(seed=7)  # another data seed and step generator: all of it comes from the file
    assert ckpt.maybe_restore(t2, str(tmp_path))
    _assert_state_equal(t1, t2)
    # The snapshot serves the restored step and params.
    step, snap = t2.host_snapshot()
    assert step == 3
    for x, y in zip(tree_leaves(snap), tree_leaves(t1.state.params)):
        np.testing.assert_array_equal(x, y.numpy())
    # An empty directory restores nothing.
    assert not ckpt.maybe_restore(_trainer(), str(tmp_path / "none"))


def _gc_listing(root, steps, fn, just_saved, keep):
    root.mkdir()
    for s in steps:
        (root / f"step_{s}").mkdir()
        (root / f"step_{s}" / "x").write_text("")
        (root / f"step_{s}.wire.npz").write_text("")
    (root / "notes").mkdir()  # a foreign name is never touched
    fn(str(root), just_saved=just_saved, keep=keep)
    return sorted(os.listdir(root))


@pytest.mark.parametrize(
    "steps,just_saved,keep",
    [([1, 2, 3, 4, 5], 5, 3), ([2, 4, 100], 4, 2), ([5, 6], 6, 3), ([3, 7, 9, 12], 9, 1)],
    ids=["keep3", "stale_higher_step", "under_keep", "keep1_stale"],
)
def test_gc_matches_reference(tmp_path, steps, just_saved, keep):
    got = _gc_listing(tmp_path / "port", steps, ckpt._gc, just_saved, keep)
    want = _gc_listing(tmp_path / "ref", steps, jax_ckpt._gc, just_saved, keep)
    assert got == want
    # Never a step at or above the one just saved.
    assert all(f"step_{s}" in got for s in steps if s >= just_saved)


def test_keep_last_collects_on_save_and_spares_a_stale_higher_step(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "KEEP_LAST", 2)
    (tmp_path / "step_100").mkdir()  # left by another run
    t = _trainer()
    for _ in range(4):
        t.run(steps=1, log_every=0)
        ckpt.save(t, str(tmp_path))
    # The stale step counts toward the two kept, as in the reference.
    assert sorted(os.listdir(tmp_path)) == ["step_100", "step_4"]
    assert ckpt.latest_step(str(tmp_path)) == 100


def test_a_snapshot_lands_whole(tmp_path):
    t = _trainer()
    t.run(steps=2, log_every=0)
    (tmp_path / ".step_9.1.2.tmp").mkdir()  # a write cut short
    ckpt.save(t, str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == 2
    first = torch.load(tmp_path / "step_2" / ckpt.STATE_FILE, weights_only=True)
    with torch.no_grad():
        tree_leaves(t.state.params)[0].add_(1.0)
    ckpt.save(t, str(tmp_path))  # replaces step_2 in place
    again = torch.load(tmp_path / "step_2" / ckpt.STATE_FILE, weights_only=True)
    assert not torch.equal(tree_leaves(first["params"])[0], tree_leaves(again["params"])[0])
    assert sorted(n for n in os.listdir(tmp_path) if not n.startswith(".step_9")) == ["step_2"]


def _blocked_writer(monkeypatch):
    gate, entered = threading.Event(), threading.Event()
    write = ckpt._write_snapshot

    def slow(*a, **k):
        entered.set()
        gate.wait(10)
        return write(*a, **k)

    monkeypatch.setattr(ckpt, "_write_snapshot", slow)
    return gate, entered


def test_save_async_copies_skips_while_writing_and_drains(tmp_path, monkeypatch):
    gate, entered = _blocked_writer(monkeypatch)
    t = _trainer()
    t.run(steps=2, log_every=0)
    want = [p.clone() for p in tree_leaves(t.state.params)]
    assert ckpt.save_async(t, str(tmp_path))
    assert entered.wait(10)
    assert not ckpt.save_async(t, str(tmp_path))  # one write in flight per trainer
    assert not ckpt.wait_pending_saves(t, hard_cap=0.2)  # still writing: gives up at the cap
    t.run(steps=1, log_every=0)  # updates the params in place while the writer waits
    gate.set()
    assert ckpt.wait_pending_saves(t)
    assert ckpt.latest_step(str(tmp_path)) == 2 and t._ckpt_snapshot_id == (2, t.mutation_counter)
    saved = torch.load(tmp_path / "step_2" / ckpt.STATE_FILE, weights_only=True)
    for x, y in zip(tree_leaves(saved["params"]), want):
        assert torch.equal(x, y)  # the state at the save point, not after the next step
    assert ckpt.save_async(t, str(tmp_path))  # the writer is free again
    assert ckpt.wait_pending_saves(t) and ckpt.latest_step(str(tmp_path)) == 3


def test_restore_reapplies_param_dtype(tmp_path):
    t1 = _trainer()
    t1.run(steps=2, log_every=0)
    ckpt.save(t1, str(tmp_path))
    t2 = _trainer(param_dtype="bfloat16")
    assert ckpt.maybe_restore(t2, str(tmp_path))
    for got, want in zip(tree_leaves(t2.state.params), tree_leaves(t1.state.params)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    for got, want in zip(t2.state.opt_state["mu"], t1.state.opt_state["mu"]):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    assert t2.state.step == 2


def test_dp2_mesh_trainer_restores_into_both_replicas(tmp_path):
    mesh = lambda: make_mesh(dp=2, devices=["cpu", "cpu"])  # noqa: E731
    t1 = _trainer(mesh=mesh())
    t1.run(steps=2, log_every=0)
    ckpt.save(t1, str(tmp_path))
    t2 = _trainer(seed=5, mesh=mesh())
    assert ckpt.maybe_restore(t2, str(tmp_path))
    assert len(t2.mesh.flat()) == 2
    for rank in range(2):
        _assert_state_equal(t1, t2, rank_b=rank)
    # Both replicas step on from the same state.
    t1.run(steps=1, log_every=0)
    t2.run(steps=1, log_every=0)
    for leaf in t2.state.leaves():
        assert torch.equal(leaf.shards[0], leaf.shards[1])


@pytest.mark.parametrize("steps,every,final", [(4, 2, False), (3, 2, True)], ids=["already_saved", "final_save"])
def test_volunteer_final_save_only_when_needed(tmp_path, monkeypatch, steps, every, final):
    calls = []
    save = ckpt.save
    monkeypatch.setattr(ckpt, "save", lambda trainer, d: calls.append(trainer.state.step) or save(trainer, d))
    cfg = VolunteerConfig(
        model="gpt2_small", model_overrides=TINY, batch_size=2, steps=steps, device="cpu",
        checkpoint_dir=str(tmp_path), checkpoint_every=every,
    )

    async def main():
        vol = Volunteer(cfg)
        try:
            await vol.start()
            return await vol.train()
        finally:
            await vol.stop()

    summary = asyncio.run(asyncio.wait_for(main(), 60))
    assert summary["steps"] == steps
    assert calls == ([steps] if final else [])
    assert ckpt.latest_step(str(tmp_path)) == steps
