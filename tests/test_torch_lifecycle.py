"""The volunteer's lifecycle in the port against the JAX package: state sync,
``adopt_params``, reports to a coordinator, the entry scripts and their
flags.

- State sync, mixed in both directions on the bf16 and f32 wires: a port
  puller from a reference provider and the reverse, over localhost TCP. The
  bytes each package serves for one tree (the tiny gpt2's reference init
  plus seeded noise, numpy) are equal, and the tree a puller adopts into
  its trainer is bit-equal to the served buffer decoded.
- ``Trainer.adopt_params`` then two steps, against the reference trainer's
  on the same params and batches: atol 5e-6, the key bias (rounding noise
  that Adam normalizes, see ``tests/test_torch_train_step.py``) to lr / 20.
- A port volunteer's report reaches a port and a reference ``Coordinator``
  (``coord.status``: alive, its telemetry summary, its watchdog summary).
  Port transports close first: the reference's close waits for its open
  inbound connections.
- ``coordinator_torch.py`` and ``run_volunteer_torch.py --device cpu`` as
  subprocesses: a two-step run, and a run stopped by SIGTERM that exits 0
  after its final checkpoint. The scripts take the reference scripts'
  flags (read from their ``add_argument`` calls), with ``--device`` the
  one flag of the port's own.
- Options of later slices raise in ``VolunteerConfig`` and make the script
  exit with status 2; the options this slice ported (the three averaging
  modes, the wall-clock cadence, the robust methods, the resilience layer)
  reach the averager, the trainer and the policy, from the config and from
  the script.
"""

import ast
import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu import native as jax_native
from distributedvolunteercomputing_tpu.models import get_model as jax_get_model
from distributedvolunteercomputing_tpu.swarm.coordinator import Coordinator as JaxCoordinator
from distributedvolunteercomputing_tpu.swarm.dht import DHTNode as JaxDHTNode
from distributedvolunteercomputing_tpu.swarm.state_sync import StateSyncService as JaxStateSync
from distributedvolunteercomputing_tpu.swarm.transport import Transport as JaxTransport
from distributedvolunteercomputing_tpu.training.trainer import Trainer as JaxTrainer
from distributedvolunteercomputing_tpu.utils.pytree import flatten_to_buffer as jax_flatten
from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.models import get_model
from distributedvolunteercomputing_tpu_torch.models.convert import params_from_jax
from distributedvolunteercomputing_tpu_torch.swarm import volunteer as vol_mod
from distributedvolunteercomputing_tpu_torch.swarm.coordinator import Coordinator
from distributedvolunteercomputing_tpu_torch.swarm.dht import DHTNode
from distributedvolunteercomputing_tpu_torch.swarm.state_sync import StateSyncService
from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport
from distributedvolunteercomputing_tpu_torch.swarm.volunteer import Volunteer, VolunteerConfig
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer, tree_leaves

REPO = Path(__file__).resolve().parent.parent
TINY = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=256, max_len=32, xent_chunk=16, remat=False)
LR = 1e-2


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    assert native.ensure_built() and jax_native.ensure_built()


def _reference_tree(seed=3):
    """The tiny gpt2's reference init plus seeded noise, as numpy."""
    jb = jax_get_model("gpt2_small", **TINY)
    params = jax.tree_util.tree_map(np.array, jb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)


def _decode(wire, payload: bytes) -> np.ndarray:
    if wire == "bf16":
        return native.bf16_to_f32(np.frombuffer(payload, np.uint16))
    return np.frombuffer(payload, np.float32)


async def _sync_node(pkg, peer_id, wire, boot=None):
    t = Transport() if pkg == "port" else JaxTransport()
    dht = DHTNode(t) if pkg == "port" else JaxDHTNode(t)
    await t.start()
    await dht.start(bootstrap=[boot] if boot else None)
    svc_cls = StateSyncService if pkg == "port" else JaxStateSync
    return t, dht, svc_cls(t, dht, peer_id, namespace="gpt2_small", wire=wire)


@pytest.mark.parametrize("wire", ["bf16", "f32"])
@pytest.mark.parametrize("provider,puller", [("reference", "port"), ("port", "reference")])
def test_state_sync_mixed(provider, puller, wire):
    tree = _reference_tree()

    async def main():
        tp, dp, sp = await _sync_node(provider, "prov", wire)
        tq, dq, sq = await _sync_node(puller, "pull", wire, boot=tp.addr)
        try:
            for svc in (sp, sq):
                svc.set_provider(lambda: (7, tree))
            # What each package serves for the tree, from one fetch.
            served = []
            for svc in (sp, sq):
                meta, chunk = await svc._rpc_fetch({"session": "", "offset": 0, "length": 1 << 30}, b"")
                assert meta["done"] and meta["wire"] == wire and meta["step"] == 7
                served.append(bytes(chunk))
            sq.set_provider(None)
            await sp.announce()
            local = jax.tree_util.tree_map(np.zeros_like, tree)
            pulled = await sq.pull(local, 0)
            nothing = await sq.pull(local, 7)  # nobody ahead of step 7
            return served, pulled, nothing
        finally:
            # The port's transport first (see the module doc).
            for t, d in sorted(((tp, dp), (tq, dq)), key=lambda n: not isinstance(n[0], Transport)):
                await asyncio.wait_for(d.stop(), 5)
                await asyncio.wait_for(t.close(), 5)

    served, pulled, nothing = run(main())
    assert served[0] == served[1]
    assert nothing is None
    step, subtree = pulled
    assert step == 7
    want = _decode(wire, served[0])
    if wire == "f32":
        np.testing.assert_array_equal(want, jax_flatten(tree)[0])
    if puller == "port":
        trainer = Trainer(get_model("gpt2_small", **TINY), batch_size=2, device="cpu")
        trainer.adopt_params(subtree, step=step)
        got = flatten_to_buffer(trainer.state.params)[0]
        assert trainer.state.step == 7 and trainer.host_snapshot()[0] == 7
    else:
        jt = JaxTrainer(jax_get_model("gpt2_small", **TINY), batch_size=2)
        jt.adopt_params(subtree, step=step)
        got = jax_flatten(jax.tree_util.tree_map(np.asarray, jt.state.params))[0]
        assert int(jt.state.step) == 7
    assert got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()


def _assert_params_close(params, jparams, msg):
    key_bias = slice(TINY["d_model"], 2 * TINY["d_model"])
    qkv_b = params["blocks"]["qkv"]["b"]
    for a, b in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        x, y = a.numpy().copy(), np.array(b)
        if a is qkv_b:
            np.testing.assert_allclose(x[:, key_bias], y[:, key_bias], atol=LR / 20, rtol=0, err_msg=f"{msg} key bias")
            x[:, key_bias] = y[:, key_bias] = 0.0
        np.testing.assert_allclose(x, y, atol=5e-6, rtol=0, err_msg=msg)


def test_adopt_params_then_two_steps_match_reference():
    jb = jax_get_model("gpt2_small", **TINY)
    batches = [jax.tree_util.tree_map(np.asarray, jb.make_batch(jax.random.PRNGKey(20 + i), 2)) for i in range(4)]
    tbatches = [{k: torch.from_numpy(np.array(v)).long() for k, v in b.items()} for b in batches]
    jt = JaxTrainer(jb, batch_size=2, optimizer="adamw", lr=LR, total_steps=10, data=iter(batches))
    tt = Trainer(get_model("gpt2_small", **TINY), batch_size=2, optimizer="adamw", lr=LR, total_steps=10,
                 data=iter(tbatches), device="cpu")
    params0 = jax.tree_util.tree_map(np.array, jt.state.params)
    with torch.no_grad():
        for p, v in zip(tree_leaves(tt.state.params), tree_leaves(params_from_jax(params0, "cpu"))):
            p.copy_(v)
    # Two steps of each first, so the kept moments are not zeros.
    jt.run(steps=2, log_every=0)
    tt.run(steps=2, log_every=0)
    pulled = _reference_tree(seed=9)
    jt.adopt_params(pulled, step=5)
    tt.adopt_params(pulled, step=5)
    assert tt.state.step == int(jt.state.step) == 5 and tt.mutation_counter == jt.mutation_counter == 1
    step, snap = tt.host_snapshot()
    assert step == 5
    np.testing.assert_array_equal(flatten_to_buffer(snap)[0], jax_flatten(pulled)[0])
    jt.run(steps=2, log_every=0)
    tt.run(steps=2, log_every=0)
    assert tt.state.step == int(jt.state.step) == 7
    _assert_params_close(tt.state.params, jt.state.params, "params after adopt_params and 2 steps")


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_report_reaches_coordinator(pkg):
    async def main():
        coord = Coordinator() if pkg == "port" else JaxCoordinator()
        addr = await coord.start()
        cfg = VolunteerConfig(
            peer_id="vol-report", model="gpt2_small", model_overrides=TINY, batch_size=2, steps=2,
            device="cpu", coordinator="%s:%d" % addr, heartbeat_ttl=1.5,
        )
        vol = Volunteer(cfg)
        client = Transport()
        try:
            await vol.start()
            await client.start()
            deadline = time.monotonic() + 20.0
            while True:
                status, _ = await client.call(addr, "coord.status", {}, timeout=5.0)
                per_peer = (status.get("telemetry") or {}).get("per_peer") or {}
                if "vol-report" in status["alive"] and "vol-report" in per_peer and status["alerts"]["reporting"]:
                    return status
                if time.monotonic() > deadline:
                    raise AssertionError(f"no report in coord.status: {status}")
                await asyncio.sleep(0.2)
        finally:
            await client.close()
            await vol.stop()
            await asyncio.wait_for(coord.close(), 10)

    status = run(main())
    assert status["n_alive"] >= 1
    assert status["control_plane"]["exchanges"] + status["control_plane"]["reports"] >= 1


def _script_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


@pytest.fixture(scope="module")
def coordinator_proc(tmp_path_factory):
    metrics = tmp_path_factory.mktemp("coord") / "swarm.jsonl"
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "coordinator_torch.py"), "--port", "0", "--metrics", str(metrics)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO, env=_script_env(),
    )
    try:
        line = ""
        while not line.startswith("COORDINATOR_READY"):
            line = proc.stdout.readline()
            assert line, "the coordinator exited before it was ready"
        yield line.split()[1], metrics
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0


def _volunteer_argv(addr, ckpt_dir, metrics, steps):
    overrides = [a for k, v in TINY.items() for a in ("--model-override", f"{k}={json.dumps(v)}")]
    return [
        sys.executable, str(REPO / "run_volunteer_torch.py"), "--device", "cpu", "--model", "gpt2_small",
        *overrides, "--batch-size", "2", "--steps", str(steps), "--coordinator", addr,
        "--checkpoint-dir", str(ckpt_dir), "--checkpoint-every", "1000", "--metrics", str(metrics),
        "--peer-id", f"vol-script-{steps}",
    ]


def test_entry_scripts_run_two_cpu_steps(coordinator_proc, tmp_path):
    addr, _ = coordinator_proc
    out = subprocess.run(
        _volunteer_argv(addr, tmp_path / "ckpt", tmp_path / "v.jsonl", 2),
        capture_output=True, text=True, cwd=REPO, env=_script_env(), timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("VOLUNTEER_DONE ")]
    summary = json.loads(done[-1].split(" ", 1)[1])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_2"]  # the final save


def test_entry_script_volunteer_exits_0_on_sigterm_after_its_final_save(coordinator_proc, tmp_path):
    addr, _ = coordinator_proc
    metrics = tmp_path / "v.jsonl"
    proc = subprocess.Popen(
        _volunteer_argv(addr, tmp_path / "ckpt", metrics, 100000),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=_script_env(),
    )
    try:
        deadline = time.monotonic() + 90
        while not (metrics.exists() and '"loss"' in metrics.read_text()):
            assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()[-2000:] if proc.poll() else ""
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-2000:]
    summary = json.loads([ln for ln in stdout.splitlines() if ln.startswith("VOLUNTEER_DONE ")][-1].split(" ", 1)[1])
    assert 1 <= summary["steps"] < 100000
    assert os.listdir(tmp_path / "ckpt") == [f"step_{summary['steps']}"]


def _add_arguments(path):
    """flag -> {keyword: source text} of every ``add_argument`` in a script."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flag = node.args[0].value
            out[flag] = {kw.arg: ast.unparse(kw.value) for kw in node.keywords if kw.arg != "help"}
    return out


@pytest.mark.parametrize(
    "ref,port,extra",
    [("run_volunteer.py", "run_volunteer_torch.py", {"--device"}), ("coordinator.py", "coordinator_torch.py", set())],
)
def test_script_flags_match_reference(ref, port, extra):
    want, got = _add_arguments(REPO / ref), _add_arguments(REPO / port)
    assert len(want) > 3 and set(got) - set(want) == extra
    assert {k: v for k, v in got.items() if k not in extra} == want


def _non_default(value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    if value is None:
        return "x"
    return value + "x"


@pytest.mark.parametrize(
    "field,value",
    [(f, _non_default(d)) for f, (d, _) in vol_mod.LATER_SLICES.items()]
    + [("mesh", "dp=1,sp=2"), ("mesh", "pp=2")],
)
def test_unported_config_options_raise(field, value):
    with pytest.raises(NotImplementedError, match="not ported"):
        VolunteerConfig(**{field: value})


# The reference's config checks of group schedules and zones: the port
# raises the same ValueError for each.
GROUP_CONFIG_ERRORS = {
    "negative_rotation": (dict(averaging="sync", group_size=2, group_rotation_s=-1.0), "group_rotation_s must be"),
    "negative_k": (dict(averaging="sync", group_size=2, cross_zone_every_k=-1), "cross_zone_every_k must be"),
    "k_without_groups": (dict(averaging="sync", cross_zone_every_k=2), "requires --group-size"),
    "group_of_one": (dict(averaging="sync", group_size=1), "group_size must be >= 2"),
    "gossip_groups": (dict(averaging="gossip", group_size=2), "requires --averaging sync"),
    "below_min_group": (dict(averaging="sync", group_size=2, min_group=3), "< min_group"),
    "above_max_group": (dict(averaging="sync", group_size=8, max_group=4), "> max_group"),
}


@pytest.mark.parametrize("case", list(GROUP_CONFIG_ERRORS))
def test_group_config_errors_match_reference(case):
    from distributedvolunteercomputing_tpu.swarm.volunteer import VolunteerConfig as JaxVolunteerConfig

    fields, match = GROUP_CONFIG_ERRORS[case]
    with pytest.raises(ValueError, match=match) as want:
        JaxVolunteerConfig(**fields)
    with pytest.raises(ValueError, match=match) as got:
        VolunteerConfig(**fields)
    assert str(got.value) == str(want.value)


# The reference's config checks of the wires and zone sharding: the port
# raises the same ValueError for each.
GRADS = dict(average_what="grads")
WIRE_CONFIG_ERRORS = {
    "unknown_wire": (dict(averaging="sync", wire="q4"), "unknown wire dtype"),
    "powersgd_params": (dict(averaging="sync", wire="powersgd"), "requires --average-what grads"),
    "powersgd_gossip": (dict(averaging="gossip", wire="powersgd", **GRADS), "requires --averaging sync"),
    "powersgd_rank_0": (dict(averaging="byzantine", wire="powersgd", powersgd_rank=0, **GRADS), "powersgd_rank"),
    "sign_params": (dict(averaging="byzantine", wire="sign"), "requires --average-what grads"),
    "sign_butterfly": (dict(averaging="butterfly", wire="sign", **GRADS), "requires --averaging sync"),
    "topk_params": (dict(averaging="sync", wire="topk"), "requires --average-what grads"),
    "topk_gossip": (dict(averaging="gossip", wire="topk", **GRADS), "requires --averaging sync"),
    "topk_negative_warmup": (dict(averaging="sync", wire="topk", topk_warmup_rounds=-1, **GRADS),
                             "topk_warmup_rounds must be"),
    "topk_robust_method": (dict(averaging="byzantine", wire="topk", method="median", **GRADS),
                           "requires --method mean"),
    "topk_unrobust": (dict(averaging="byzantine", wire="topk", method="mean", **GRADS), "--allow-unrobust-topk"),
    "negative_zone_shards": (dict(averaging="sync", zone="a", zone_shards=-1), "zone_shards must be"),
    "zone_shards_without_zone": (dict(averaging="sync", group_size=2, zone_shards=2), "requires --zone"),
    "zone_shards_without_groups": (dict(averaging="sync", zone="a", zone_shards=2), "requires --group-size"),
}


@pytest.mark.parametrize("case", list(WIRE_CONFIG_ERRORS))
def test_wire_and_shard_config_errors_match_reference(case):
    from distributedvolunteercomputing_tpu.swarm.averager import SyncAverager as JaxSyncAverager
    from distributedvolunteercomputing_tpu.swarm.volunteer import VolunteerConfig as JaxVolunteerConfig

    fields, match = WIRE_CONFIG_ERRORS[case]
    if case == "unknown_wire":
        # Both configs take any wire; each averager refuses an unknown one
        # with this message when the volunteer starts.
        from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager

        assert VolunteerConfig(**fields).wire == JaxVolunteerConfig(**fields).wire == fields["wire"]
        with pytest.raises(ValueError, match=match) as got:
            SyncAverager(None, None, None, wire=fields["wire"])
        with pytest.raises(ValueError) as want:
            JaxSyncAverager(None, None, None, wire=fields["wire"])
    else:
        with pytest.raises(ValueError, match=match) as got:
            VolunteerConfig(**fields)
        with pytest.raises(ValueError, match=match) as want:
            JaxVolunteerConfig(**fields)
    assert str(got.value) == str(want.value)


def _later_flag_argv():
    """One argv per flag of a later slice, set away from its default."""
    import runpy

    later = runpy.run_path(str(REPO / "run_volunteer_torch.py"))["LATER_FLAGS"]
    specs = {}
    for flag, kw in _add_arguments(REPO / "run_volunteer.py").items():
        dest = flag.lstrip("-").replace("-", "_")
        if dest in later:
            if kw.get("action") == "'store_true'":
                specs[dest] = [flag]
            elif "choices" in kw:
                specs[dest] = [flag, next(c for c in ast.literal_eval(kw["choices"]) if repr(c) != kw["default"])]
            elif kw.get("action") == "'append'":
                specs[dest] = [flag, "k=1"]
            else:
                specs[dest] = [flag, "3"]
    assert set(specs) == set(later)
    return [specs[d] for d in sorted(specs)] + [
        ["--mesh", "sp=2"], ["--mesh", "pp=2"],
    ]


@pytest.mark.parametrize("argv", _later_flag_argv(), ids=lambda a: "=".join(a))
def test_script_refuses_unported_flags(argv, monkeypatch, capsys):
    import runpy

    main = runpy.run_path(str(REPO / "run_volunteer_torch.py"))["main"]
    extra = [] if argv[0] == "--model" else ["--model", "gpt2_small"]
    monkeypatch.setattr(sys, "argv", ["run_volunteer_torch.py", *extra, *argv, "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        main()
    assert e.value.code == 2
    assert "not ported" in capsys.readouterr().err


# The options this slice ported: case -> (config fields, script argv). Each
# replaces a refusal the earlier slices tested.
PORTED_OPTIONS = {
    "method": (dict(averaging="byzantine", method="median"), ["--averaging", "byzantine", "--method", "median"]),
    "method_kw": (dict(averaging="byzantine", method="trimmed_mean", method_kw={"trim": 1}),
                  ["--averaging", "byzantine", "--method", "trimmed_mean", "--method-kw", "trim=1"]),
    "resilience": (dict(averaging="sync", resilience=True), ["--averaging", "sync", "--resilience"]),
    "phi_threshold": (dict(averaging="sync", resilience=True, phi_threshold=3.0),
                      ["--averaging", "sync", "--resilience", "--phi-threshold", "3"]),
    "adapt": (dict(averaging="byzantine", resilience=True, adapt=False),
              ["--averaging", "byzantine", "--resilience", "--no-adapt"]),
    "average_interval_s": (dict(averaging="sync", average_interval_s=5.0),
                           ["--averaging", "sync", "--average-interval-s", "5"]),
    "gossip": (dict(averaging="gossip"), ["--averaging", "gossip"]),
    "butterfly": (dict(averaging="butterfly"), ["--averaging", "butterfly"]),
    "byzantine": (dict(averaging="byzantine"), ["--averaging", "byzantine"]),
    # Group schedules and zones: each replaces its refusal one for one.
    "group_size": (dict(averaging="sync", group_size=2), ["--averaging", "sync", "--group-size", "2"]),
    "group_rotation_s": (dict(averaging="sync", group_size=2, group_rotation_s=7.0),
                         ["--averaging", "sync", "--group-size", "2", "--group-rotation-s", "7"]),
    "zone": (dict(averaging="sync", zone="a"), ["--averaging", "sync", "--zone", "a"]),
    "cross_zone_every_k": (dict(averaging="sync", group_size=2, zone="a", cross_zone_every_k=2),
                           ["--averaging", "sync", "--group-size", "2", "--zone", "a",
                            "--cross-zone-every-k", "2"]),
    # The wires and zone sharding: each replaces its refusal.
    "wire_q8": (dict(averaging="sync", wire="q8"), ["--averaging", "sync", "--wire", "q8"]),
    "topk_frac": (dict(averaging="sync", wire="topk", topk_frac=0.05, **GRADS),
                  ["--averaging", "sync", "--average-what", "grads", "--wire", "topk", "--topk-frac", "0.05"]),
    "topk_warmup_rounds": (dict(averaging="sync", wire="topk", topk_warmup_rounds=3, **GRADS),
                           ["--averaging", "sync", "--average-what", "grads", "--wire", "topk",
                            "--topk-warmup-rounds", "3"]),
    "allow_unrobust_topk": (dict(averaging="byzantine", wire="topk", method="mean", allow_unrobust_topk=True, **GRADS),
                            ["--averaging", "byzantine", "--average-what", "grads", "--wire", "topk",
                             "--method", "mean", "--allow-unrobust-topk"]),
    "powersgd_rank": (dict(averaging="byzantine", wire="powersgd", powersgd_rank=2, method="trimmed_mean",
                           method_kw={"trim": 1}, **GRADS),
                      ["--averaging", "byzantine", "--average-what", "grads", "--wire", "powersgd", "--psgd-rank", "2",
                       "--method", "trimmed_mean", "--method-kw", "trim=1"]),
    "wire_sign": (dict(averaging="byzantine", wire="sign", **GRADS),
                  ["--averaging", "byzantine", "--average-what", "grads", "--wire", "sign"]),
    "zone_shards": (dict(averaging="sync", group_size=2, zone="a", zone_shards=2),
                    ["--averaging", "sync", "--group-size", "2", "--zone", "a", "--zone-shards", "2"]),
}


def _start_and_stop(cfg):
    async def main():
        vol = Volunteer(cfg)
        try:
            await vol.start()
            return vol
        finally:
            await vol.stop()

    return run(main())


def _check_reached(case, vol):
    from distributedvolunteercomputing_tpu_torch.swarm import averager as avg_mod
    from distributedvolunteercomputing_tpu_torch.swarm.controller import SwarmController
    from distributedvolunteercomputing_tpu_torch.swarm.failure_detector import PhiAccrualDetector
    from distributedvolunteercomputing_tpu_torch.swarm.resilience import ResiliencePolicy

    avg, trainer = vol.averager, vol.trainer
    if case in ("wire_q8", "topk_frac", "topk_warmup_rounds", "allow_unrobust_topk", "powersgd_rank", "wire_sign"):
        wire = {"wire_q8": "q8", "powersgd_rank": "powersgd", "wire_sign": "sign"}.get(case, "topk")
        assert avg.wire == vol.cfg.wire == wire
        # The state sync serves over q8 on the q8 wire, else f32.
        assert vol.state_sync.wire == ("q8" if wire == "q8" else "f32")
        assert (avg.topk_frac, avg.topk_warmup_rounds) == (
            0.05 if case == "topk_frac" else 0.01, 3 if case == "topk_warmup_rounds" else 0)
        assert avg.powersgd_rank == (2 if case == "powersgd_rank" else 4)
        if case in ("allow_unrobust_topk", "powersgd_rank", "wire_sign"):
            # topk passes method "mean" explicitly over the Byzantine default.
            assert type(avg) is avg_mod.ByzantineAverager
            assert avg.method == {"allow_unrobust_topk": "mean"}.get(case, "trimmed_mean")
        else:
            assert type(avg) is avg_mod.SyncAverager
        assert vol.trainer._wire_averager is avg
    elif case == "zone_shards":
        from distributedvolunteercomputing_tpu_torch.swarm.sharding import ShardManager
        from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

        sm = vol.shard_manager
        assert isinstance(sm, ShardManager) and avg.shard_manager is sm
        assert (sm.k, sm.zone, sm.map.gen) == (2, "a", 0)
        # The only zone member owns both shards, seeded from the sorted-key
        # flattening of the averaged subtree.
        flat, _, _ = flatten_to_buffer(trainer.host_snapshot()[1])
        assert sm.owned() == [0, 1] and sm.missing() == [] and sm.n_elems == flat.size
        for s in sm.owned():
            lo, hi = sm.ranges[s]
            assert np.array_equal(sm.store.get(s), flat[lo:hi])
        assert vol._build_report()["sharding"]["k"] == 2
        assert sm._maint_task is None or sm._maint_task.done()
    elif case in ("method", "method_kw", "byzantine"):
        assert type(avg) is avg_mod.ByzantineAverager
        assert avg.method == {"method": "median"}.get(case, "trimmed_mean")
        assert avg.method_kw == ({"trim": 1} if case == "method_kw" else {})
    elif case in ("resilience", "phi_threshold", "adapt"):
        fd, policy = vol.failure_detector, vol.resilience_policy
        assert isinstance(fd, PhiAccrualDetector) and isinstance(policy, ResiliencePolicy)
        assert fd.threshold == (3.0 if case == "phi_threshold" else 8.0)
        assert avg.failure_detector is fd is vol.membership.failure_detector and avg.resilience is policy
        assert policy.failure_detector is fd
        if case == "adapt":  # --no-adapt: no controller, none in the report
            assert vol.controller is None and avg.controller is None and "controller" not in vol._build_report()
        else:
            assert isinstance(vol.controller, SwarmController) and avg.controller is vol.controller
            assert "controller" in vol._build_report()
    elif case in ("group_size", "group_rotation_s", "zone", "cross_zone_every_k"):
        sched = avg.group_schedule
        zone = "" if case in ("group_size", "group_rotation_s") else "a"
        assert vol.membership.extra_info.get("zone") == (zone or None)
        assert avg.zone == zone
        if case == "zone":
            assert sched is None
        else:
            from distributedvolunteercomputing_tpu_torch.swarm.matchmaking import GroupSchedule

            assert isinstance(sched, GroupSchedule) and (sched.target_size, sched.min_size) == (2, 2)
            # The rotation falls back to 15 s without a wall-clock cadence.
            assert sched.rotation_s == (7.0 if case == "group_rotation_s" else 15.0)
            assert sched.cross_zone_every_k == (2 if case == "cross_zone_every_k" else 0)
            assert sched.clock is time.time and vol.clocksync is None
    elif case in ("average_interval_s", "butterfly"):
        interval = 5.0 if case == "average_interval_s" else vol_mod.DEFAULT_BUTTERFLY_INTERVAL_S
        assert vol.cfg.average_interval_s == trainer.average_interval_s == interval
        cs = vol.clocksync
        assert cs is not None and trainer._wall_clock == cs.now and avg.clock == cs.now
        if case == "butterfly":
            assert type(avg) is avg_mod.ButterflyAverager and interval == 20.0
    else:
        # Gossip publishes the post-state-sync params before its first round.
        assert type(avg) is avg_mod.GossipAverager and avg._current is not None
        assert vol.clocksync is None and trainer.average_interval_s == 0.0


@pytest.mark.parametrize("case", list(PORTED_OPTIONS))
def test_ported_config_option_reaches_the_volunteer(case):
    fields, _ = PORTED_OPTIONS[case]
    cfg = VolunteerConfig(model="gpt2_small", model_overrides=TINY, batch_size=2, device="cpu",
                          heartbeat_ttl=3.0, join_timeout=1.0, gather_timeout=2.0, **fields)
    _check_reached(case, _start_and_stop(cfg))


@pytest.mark.parametrize("case", list(PORTED_OPTIONS))
def test_script_passes_ported_flag(case, monkeypatch):
    """The script builds the volunteer the same flags describe, and the
    option reaches it (``run_volunteer`` replaced by a start and a stop)."""
    import runpy

    _, argv = PORTED_OPTIONS[case]
    started = []
    monkeypatch.setattr(vol_mod, "run_volunteer", lambda cfg: started.append(_start_and_stop(cfg)) or {})
    main = runpy.run_path(str(REPO / "run_volunteer_torch.py"))["main"]
    monkeypatch.setattr(sys, "argv", [
        "run_volunteer_torch.py", "--model", "gpt2_small", "--batch-size", "2", "--device", "cpu",
        "--join-timeout", "1", "--gather-timeout", "2",
        *[a for k, v in TINY.items() for a in ("--model-override", f"{k}={json.dumps(v)}")], *argv,
    ])
    main()
    _check_reached(case, started[0])


def test_ported_options_reach_the_averager_trainer_and_codec():
    cfg = VolunteerConfig(
        model="gpt2_small", model_overrides=TINY, batch_size=4, device="cpu", averaging="sync", wire="bf16",
        min_group=3, max_group=5, adaptive_timeout=True, round_deadline_s=7.0, hedge=False,
        tail_redundancy_frac=0.25, param_dtype="bfloat16", accum_steps=2, mesh_codec="host",
        heartbeat_ttl=6.0, average_interval_s=0,
    )

    async def main():
        vol = Volunteer(cfg)
        try:
            await vol.start()
            return vol
        finally:
            await vol.stop()

    vol = run(main())
    avg, trainer = vol.averager, vol.trainer
    assert (avg.min_group, avg.max_group, avg.adaptive_timeout, avg.round_deadline_s) == (3, 5, True, 7.0)
    assert (avg.hedge, avg.tail_redundancy_frac, avg.mesh_codec.backend) == (False, 0.25, "host")
    assert avg.control_plane is vol.control_plane is not None
    assert vol.membership.ttl == 6.0
    assert trainer.param_dtype == "bfloat16" and all(p.dtype == torch.bfloat16 for p in tree_leaves(trainer.state.params))
    # accum_steps reaches the trainer, which refuses one that does not divide the batch.
    bad = Volunteer(VolunteerConfig(model="gpt2_small", model_overrides=TINY, batch_size=4, device="cpu",
                                    accum_steps=3))

    async def start_bad():
        try:
            await bad.start()
        finally:
            await bad.stop()

    with pytest.raises(ValueError, match="accum_steps=3"):
        run(start_bad())


# The volunteer's fault-injection hooks, read from the environment as the
# reference volunteer reads them.
def _hook_cfg(**kw):
    return VolunteerConfig(model="gpt2_small", model_overrides=TINY, batch_size=2, device="cpu", wire="f32",
                           heartbeat_ttl=3.0, join_timeout=1.0, gather_timeout=2.0, **kw)


def test_state_poison_hook_serves_step_plus_lie_and_scaled_tree(monkeypatch):
    """``DVC_CHAOS_STATE_POISON=lie,scale``: state sync announces and serves
    the provider's step + lie with its tree scaled. A reference puller and a
    port volunteer that joins both take that step and that tree."""
    monkeypatch.setenv("DVC_CHAOS_STATE_POISON", "5,-2")

    async def main():
        a = Volunteer(_hook_cfg(peer_id="poisoner", averaging="sync"))
        b = Volunteer(_hook_cfg(peer_id="joiner", averaging="sync"))
        t = dht = None
        try:
            await a.start()
            t, dht, ref = await _sync_node("reference", "ref", "f32", boot=a.transport.addr)
            ref_pulled = await ref.pull(jax.tree_util.tree_map(np.zeros_like, _reference_tree()), 0)
            b.cfg.coordinator = "%s:%d" % a.transport.addr
            await b.start()
            return a.trainer.host_snapshot(), ref_pulled, int(b.trainer.state.step), b.trainer.state.params
        finally:
            await asyncio.gather(a.stop(), b.stop())
            if t is not None:
                await asyncio.wait_for(dht.stop(), 5)
                await asyncio.wait_for(t.close(), 5)

    (step, served), ref_pulled, b_step, b_params = run(main())
    want = (-2 * flatten_to_buffer(served)[0]).view(np.uint32)
    assert step == 0 and ref_pulled[0] == 5 and b_step == 5
    assert jax_flatten(ref_pulled[1])[0].view(np.uint32).tobytes() == want.tobytes()
    assert flatten_to_buffer(b_params)[0].view(np.uint32).tobytes() == want.tobytes()


def test_step_delay_hook_stretches_each_step(monkeypatch):
    """``DVC_STEP_DELAY_MS=<ms>`` sleeps that long after each step; unset,
    the volunteer adds no step hook."""
    def trained_step_times(delay_ms):
        if delay_ms:
            monkeypatch.setenv("DVC_STEP_DELAY_MS", str(delay_ms))
        else:
            monkeypatch.delenv("DVC_STEP_DELAY_MS", raising=False)

        async def main():
            vol = Volunteer(_hook_cfg(steps=3))
            try:
                await vol.start()
                hook, times = vol.trainer.on_step, []
                if hook is not None:
                    vol.trainer.on_step = lambda trainer, step: (hook(trainer, step), times.append(time.perf_counter()))
                await vol.train()
                return hook, times
            finally:
                await vol.stop()

        return run(main())

    hook, _ = trained_step_times(0)
    assert hook is None
    hook, times = trained_step_times(300)
    assert hook is not None and len(times) == 3
    assert min(b - a for a, b in zip(times, times[1:])) >= 0.3


def test_clock_skew_hook_is_pulled_onto_the_unskewed_peers_boundary(monkeypatch):
    """``DVC_CLOCK_SKEW_S=<s>`` skews a volunteer's local clock under the
    wall-clock cadence; clock sync pulls the skewed and the unskewed
    volunteer onto one consensus time, so both arm the same boundary."""
    interval = 10.0

    async def main():
        a = Volunteer(_hook_cfg(peer_id="straight", averaging="sync", average_interval_s=interval))
        b = Volunteer(_hook_cfg(peer_id="skewed", averaging="sync", average_interval_s=interval))
        try:
            await a.start()
            monkeypatch.setenv("DVC_CLOCK_SKEW_S", "6")
            b.cfg.coordinator = "%s:%d" % a.transport.addr
            await b.start()
            monkeypatch.delenv("DVC_CLOCK_SKEW_S")
            skews = [v.clocksync.clock() - time.time() for v in (a, b)]
            # The periodic estimation's rounds, run now: each moves halfway.
            for _ in range(8):
                await a.clocksync.estimate()
                await b.clocksync.estimate()
            while (a.clocksync.now() + 0.1) % interval < 0.2:  # not astride a boundary
                await asyncio.sleep(0.1)
            gap = abs(a.clocksync.now() - b.clocksync.now())
            for v in (a, b):
                v.trainer._arm_next_boundary(v.clocksync.now())
            return skews, gap, [v.trainer._next_avg_t for v in (a, b)], [v.clocksync.offset for v in (a, b)]
        finally:
            await asyncio.gather(a.stop(), b.stop())

    skews, gap, boundaries, offsets = run(main())
    assert abs(skews[0]) < 0.1 and abs(skews[1] - 6) < 0.1
    assert gap < 0.05 and boundaries[0] == boundaries[1]
    assert abs(offsets[0] - offsets[1] - 6) < 0.05  # the corrections take out the skew
