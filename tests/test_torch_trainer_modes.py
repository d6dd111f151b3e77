"""The trainer's gradient mode, multi-step calls, evaluation and ``.npz`` data
on the port, by the reference's own cases, and the volunteer's and the entry
script's wiring of them.

- ``tests/test_grad_averaging.py`` (6), ``tests/test_multi_step.py`` (9),
  ``tests/test_interval_cadence.py::TestValidation`` (3) and the five
  ``npz_batch_iter`` / trainer cases of ``tests/test_data.py`` run on the
  port: their text with the import root rewritten
  (``tests/test_torch_swarm_drift.py``'s rewrite), executed in a namespace of
  its own. The port's ``Trainer`` is bound with ``device="cpu"`` there (also
  for the imports inside a test's body), and ``jax.random.PRNGKey(n)`` in
  that namespace is a ``torch.Generator`` seeded with n: the port's models
  draw their init and batches from one.
- The options the volunteer and ``run_volunteer_torch.py`` now carry reach
  the trainer, the averager and the data streams, and the config checks
  raise what the reference's raise.
- Two port volunteers average gradients over localhost TCP.
"""

import asyncio
import inspect
import json
import re
import sys
import types
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.swarm import volunteer as vol_mod
from distributedvolunteercomputing_tpu_torch.swarm.volunteer import Volunteer, VolunteerConfig
from distributedvolunteercomputing_tpu_torch.training import checkpoint as ckpt
from distributedvolunteercomputing_tpu_torch.training import trainer as trainer_mod
from distributedvolunteercomputing_tpu_torch.training.data import npz_batch_iter

REPO = Path(__file__).resolve().parent.parent
ROOT = re.compile(r"\bdistributedvolunteercomputing_tpu(?=[.\s])")  # the drift test's import-root rewrite
TINY = dict(n_layers=1, d_model=32, n_heads=2, d_ff=64, vocab=64, max_len=16, xent_chunk=8, remat=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tiny models' CPU ops run several times faster on one intra-op
    thread than spread over many cores; restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class CpuTrainer(trainer_mod.Trainer):
    """The port's trainer with the CPU asked for."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


# ``jax`` as the reference's cases see it: its tree utilities, and PRNGKey as
# a seeded torch generator.
JAX_SHIM = types.SimpleNamespace(
    tree_util=jax.tree_util,
    random=types.SimpleNamespace(PRNGKey=lambda seed: torch.Generator().manual_seed(int(seed))),
)


def _ported_namespace(test_file: str) -> dict:
    src = ROOT.sub("distributedvolunteercomputing_tpu_torch", (REPO / "tests" / test_file).read_text())
    ns = {"__name__": f"ported_{Path(test_file).stem}"}
    exec(compile(src, str(REPO / "tests" / test_file), "exec"), ns)
    if "Trainer" in ns:
        ns["Trainer"] = CpuTrainer
    ns["jax"] = JAX_SHIM
    return ns


REFERENCE = {
    name: _ported_namespace(name)
    for name in ("test_grad_averaging.py", "test_multi_step.py", "test_interval_cadence.py", "test_data.py")
}
# The cases of each file that run on the port: None = every case of the file.
SELECTED = {
    "test_grad_averaging.py": None,
    "test_multi_step.py": None,
    "test_interval_cadence.py": {"TestValidation"},
    "test_data.py": {
        "test_batches_cover_epoch_shuffled", "test_partial_batch_dropped", "test_validation_errors",
        "test_trainer_runs_on_npz", "test_eval_stream_does_not_perturb_training",
    },
}


def _cases():
    out = []
    for file, ns in REFERENCE.items():
        keep = SELECTED[file]
        for name, obj in ns.items():
            if name.startswith("Test") and isinstance(obj, type) and (keep is None or name in keep):
                out += [(file, name, m) for m in vars(obj) if m.startswith("test_")]
            elif name.startswith("test_") and callable(obj) and (keep is None or name in keep):
                out.append((file, None, name))
    return out


def test_reference_cases_bind_the_port():
    counts = {f: len([c for c in _cases() if c[0] == f]) for f in REFERENCE}
    assert counts == {"test_grad_averaging.py": 6, "test_multi_step.py": 9,
                      "test_interval_cadence.py": 3, "test_data.py": 5}
    assert REFERENCE["test_data.py"]["npz_batch_iter"] is npz_batch_iter
    assert REFERENCE["test_multi_step.py"]["Trainer"] is CpuTrainer


@pytest.mark.parametrize("file,cls,name", _cases(), ids=lambda v: str(v).removesuffix(".py"))
def test_reference_case_on_the_port(file, cls, name, tmp_path, monkeypatch):
    # A case that imports Trainer in its body gets the CPU-bound one too.
    monkeypatch.setattr(trainer_mod, "Trainer", CpuTrainer)
    ns = REFERENCE[file]
    fn = getattr(ns[cls](), name) if cls else ns[name]
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})


# -- the volunteer and the entry script ----------------------------------------


def _write_tokens_npz(path: Path, n: int = 16) -> str:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, TINY["vocab"], (n, TINY["max_len"] + 1))
    np.savez(path, tokens=toks[:, :-1], targets=toks[:, 1:])
    return str(path)


# case -> (config fields, script argv); "{npz}" stands for a file of tokens.
OPTIONS = {
    "grads": (dict(averaging="sync", average_what="grads"), ["--averaging", "sync", "--average-what", "grads"]),
    "steps_per_call": (dict(steps_per_call=4), ["--steps-per-call", "4"]),
    "data": (dict(data_path="{npz}", eval_every=5, eval_batches=2),
             ["--data", "{npz}", "--eval-every", "5", "--eval-batches", "2"]),
    "outer": (dict(averaging="sync", outer_optimizer="nesterov", outer_lr=0.5, outer_momentum=0.8),
              ["--averaging", "sync", "--outer-optimizer", "nesterov", "--outer-lr", "0.5", "--outer-momentum", "0.8"]),
}


def _start_and_stop(cfg):
    async def main():
        vol = Volunteer(cfg)
        try:
            await vol.start()
            return vol
        finally:
            await vol.stop()

    return asyncio.run(asyncio.wait_for(main(), timeout=60))


def _check_reached(case, vol, npz):
    t = vol.trainer
    if case == "grads":
        assert t._grads_mode and t.average_what == "grads" and not t.overlap
        assert vol.averager.namespace == "gpt2_small/grads"
        assert vol.membership.extra_info["avg_ns"] == "gpt2_small/grads"
    elif case == "steps_per_call":
        assert t.steps_per_call == 4 and t._multi_fn is not None and t.chunk_cadences == ()
    elif case == "data":
        seed = zlib.crc32(vol.cfg.peer_id.encode()) & 0x7FFFFFFF
        want, want_eval = npz_batch_iter(npz, 2, seed=seed), npz_batch_iter(npz, 2, seed=seed ^ 0x5EED)
        assert t.eval_every == 5 and t.eval_batches == 2
        for got, ref in ((next(iter(t._data)), next(want)), (next(iter(t._eval_data)), next(want_eval))):
            assert all(np.array_equal(got[k], ref[k]) for k in ("tokens", "targets"))
    else:
        assert (t.outer_optimizer, t.outer_lr, t.outer_momentum) == ("nesterov", 0.5, 0.8)


def _fill(value, npz):
    if isinstance(value, str):
        return value.replace("{npz}", npz)
    if isinstance(value, list):
        return [_fill(v, npz) for v in value]
    if isinstance(value, dict):
        return {k: _fill(v, npz) for k, v in value.items()}
    return value


@pytest.mark.parametrize("case", list(OPTIONS))
def test_option_reaches_the_volunteer(case, tmp_path):
    npz = _write_tokens_npz(tmp_path / "tokens.npz")
    fields = _fill(OPTIONS[case][0], npz)
    cfg = VolunteerConfig(model="gpt2_small", model_overrides=TINY, batch_size=2, device="cpu",
                          heartbeat_ttl=3.0, join_timeout=1.0, gather_timeout=2.0, **fields)
    _check_reached(case, _start_and_stop(cfg), npz)


@pytest.mark.parametrize("case", list(OPTIONS))
def test_script_passes_the_flag(case, tmp_path, monkeypatch):
    """``run_volunteer_torch.py --device cpu`` with the flag builds a
    volunteer that carries it (``run_volunteer`` replaced by a start and a
    stop)."""
    import runpy

    npz = _write_tokens_npz(tmp_path / "tokens.npz")
    started = []
    monkeypatch.setattr(vol_mod, "run_volunteer", lambda cfg: started.append(_start_and_stop(cfg)) or {})
    main = runpy.run_path(str(REPO / "run_volunteer_torch.py"))["main"]
    monkeypatch.setattr(sys, "argv", [
        "run_volunteer_torch.py", "--model", "gpt2_small", "--batch-size", "2", "--device", "cpu",
        "--join-timeout", "1", "--gather-timeout", "2",
        *[a for k, v in TINY.items() for a in ("--model-override", f"{k}={json.dumps(v)}")],
        *_fill(OPTIONS[case][1], npz),
    ])
    main()
    _check_reached(case, started[0], npz)


def test_checkpoint_cadence_survives_chunks(tmp_path):
    """Under steps_per_call the volunteer declares its checkpoint cadence in
    chunk_cadences: every multiple of it is a host-visible step, so each
    periodic save happens (on_step fires only on chunk-final steps)."""
    cfg = VolunteerConfig(model="gpt2_small", model_overrides=TINY, batch_size=2, device="cpu", steps=12,
                          steps_per_call=8, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3,
                          heartbeat_ttl=3.0)

    async def main():
        vol = Volunteer(cfg)
        seen = []
        try:
            await vol.start()
            assert vol.trainer.chunk_cadences == (3,)
            inner = vol.trainer.on_step
            vol.trainer.on_step = lambda tr, s: (seen.append(s), inner(tr, s))
            await vol.train()
            return seen
        finally:
            await vol.stop()

    seen = asyncio.run(asyncio.wait_for(main(), timeout=60))
    assert {3, 6, 9, 12} <= set(seen) and len(seen) < 12
    assert ckpt.latest_step(str(tmp_path / "ck")) == 12


def _ref_config_error(**fields):
    from distributedvolunteercomputing_tpu.swarm.volunteer import VolunteerConfig as RefConfig

    with pytest.raises(ValueError) as e:
        RefConfig(**fields)
    return str(e.value)


@pytest.mark.parametrize(
    "fields",
    [
        dict(coordinator="127.0.0.1:1", averaging="sync", average_what="grads", average_interval_s=5.0),
        dict(coordinator="127.0.0.1:1", averaging="none", average_interval_s=5.0),
        dict(averaging="sync", average_what="grads", outer_optimizer="nesterov"),
        dict(averaging="gossip", outer_optimizer="nesterov"),
        dict(averaging="butterfly", outer_optimizer="nesterov"),
        dict(averaging="none", outer_optimizer="nesterov"),
    ],
    ids=["interval-grads", "interval-none", "outer-grads", "outer-gossip", "outer-butterfly", "outer-none"],
)
def test_config_checks_raise_what_the_reference_raises(fields):
    want = _ref_config_error(**fields)
    with pytest.raises(ValueError) as e:
        VolunteerConfig(**fields)
    assert str(e.value) == want


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(average_what="both"), "average_what"),
        (dict(eval_every=5, eval_batches=0), "eval_batches"),
        (dict(outer_optimizer="adam"), "outer_optimizer"),
        (dict(outer_optimizer="nesterov", average_what="grads", averager=lambda g, s: g), "outer_optimizer"),
    ],
    ids=["average_what", "eval_batches", "outer-unknown", "outer-grads"],
)
def test_trainer_checks_raise_what_the_reference_raises(kw, match):
    from distributedvolunteercomputing_tpu_torch.models import get_model

    with pytest.raises(ValueError, match=match):
        CpuTrainer(get_model("mnist_mlp"), batch_size=8, **kw)


def test_two_port_volunteers_average_gradients():
    """Gradient rounds over localhost TCP on the bf16 wire: a round every
    step, one batch of weight each, and both volunteers step on the same
    averaged gradients, so their params stay together."""
    assert native.ensure_built()
    base = dict(model="gpt2_small", model_overrides=TINY, batch_size=2, averaging="sync", wire="bf16",
                average_what="grads", steps=3, device="cpu", join_timeout=5.0, gather_timeout=5.0)
    weights = []

    async def main():
        v0 = Volunteer(VolunteerConfig(peer_id="g0", seed=1, **base))
        await v0.start()
        v1 = Volunteer(VolunteerConfig(peer_id="g1", seed=2, coordinator="%s:%d" % v0.transport.addr, **base))
        try:
            await v1.start()
            for v in (v0, v1):
                avg = v.averager.average

                async def counted(tree, round_no, weight, _avg=avg):
                    weights.append(weight)
                    return await _avg(tree, round_no=round_no, weight=weight)

                v.averager.average = counted
            summaries = await asyncio.gather(v0.train(), v1.train())
            return summaries, [v.trainer.host_snapshot() for v in (v0, v1)], (v0, v1)
        finally:
            await asyncio.gather(v0.stop(), v1.stop())

    summaries, _, vols = asyncio.run(asyncio.wait_for(main(), timeout=90))
    assert all(s["steps"] == 3 and np.isfinite(s["final_loss"]) for s in summaries)
    assert min(s["rounds_ok"] for s in summaries) >= 2
    assert set(weights) == {2.0}
    # Same init, same averaged gradients at every committed round: the
    # params differ only where a round was skipped or by bf16 rounding.
    a, b = (np.concatenate([np.asarray(x, np.float32).ravel()
                            for x in jax.tree_util.tree_leaves(
                                trainer_mod.Trainer._host_tree(v.trainer.state.params))]) for v in vols)
    if all(s["rounds_ok"] == 3 for s in summaries):
        assert np.abs(a - b).max() < 5e-3
