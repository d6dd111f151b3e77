"""The PyTorch port stands alone: it loads no jax, optax, orbax or module of
the JAX package, and its entry points never fall back to the CPU silently."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "distributedvolunteercomputing_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "distributedvolunteercomputing_tpu")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


# The modules of the averaging and ring slices: the scans below must reach them.
SWARM_SLICE = (
    "distributedvolunteercomputing_tpu_torch.native",
    "distributedvolunteercomputing_tpu_torch.ops.mesh_codec",
    "distributedvolunteercomputing_tpu_torch.ops.mesh_collective",
    "distributedvolunteercomputing_tpu_torch.parallel.mesh",
    "distributedvolunteercomputing_tpu_torch.parallel.train_step",
    "distributedvolunteercomputing_tpu_torch.ops.robust",
    "distributedvolunteercomputing_tpu_torch.swarm.agg_stream",
    "distributedvolunteercomputing_tpu_torch.swarm.averager",
    "distributedvolunteercomputing_tpu_torch.swarm.dht",
    "distributedvolunteercomputing_tpu_torch.swarm.health",
    "distributedvolunteercomputing_tpu_torch.swarm.matchmaking",
    "distributedvolunteercomputing_tpu_torch.swarm.membership",
    "distributedvolunteercomputing_tpu_torch.swarm.telemetry",
    "distributedvolunteercomputing_tpu_torch.swarm.transport",
    "distributedvolunteercomputing_tpu_torch.swarm.volunteer",
    "distributedvolunteercomputing_tpu_torch.swarm.watchdog",
)

# The modules of the lifecycle slice.
LIFECYCLE_SLICE = (
    "distributedvolunteercomputing_tpu_torch.utils.asyncio_debug",
    "distributedvolunteercomputing_tpu_torch.swarm.controller",
    "distributedvolunteercomputing_tpu_torch.swarm.control_plane",
    "distributedvolunteercomputing_tpu_torch.swarm.coordinator",
    "distributedvolunteercomputing_tpu_torch.swarm.state_sync",
    "distributedvolunteercomputing_tpu_torch.training.checkpoint",
)
ENTRY_SCRIPTS = [REPO / "coordinator_torch.py", REPO / "run_volunteer_torch.py"]

# The modules of the protocols slice (gossip, butterfly, byzantine).
PROTOCOLS_SLICE = (
    "distributedvolunteercomputing_tpu_torch.swarm.failure_detector",
    "distributedvolunteercomputing_tpu_torch.swarm.resilience",
    "distributedvolunteercomputing_tpu_torch.swarm.clocksync",
)


# The modules of the model-zoo slice.
MODELS_SLICE = (
    "distributedvolunteercomputing_tpu_torch.models.mlp",
    "distributedvolunteercomputing_tpu_torch.models.resnet",
    "distributedvolunteercomputing_tpu_torch.models.vit",
    "distributedvolunteercomputing_tpu_torch.models.bert",
    "distributedvolunteercomputing_tpu_torch.models.lora",
    "distributedvolunteercomputing_tpu_torch.models.llama",
)


# The modules of the trainer slice (gradient mode, multi-step calls, eval,
# the outer optimizer, .npz data).
TRAINER_SLICE = (
    "distributedvolunteercomputing_tpu_torch.training.steps",
    "distributedvolunteercomputing_tpu_torch.training.data",
    "distributedvolunteercomputing_tpu_torch.training.trainer",
    "distributedvolunteercomputing_tpu_torch.training.checkpoint",
    "distributedvolunteercomputing_tpu_torch.parallel.train_step",
    "distributedvolunteercomputing_tpu_torch.swarm.volunteer",
)


# The modules of the faults-and-zones slice (leader failover, hedged tile
# recovery, zoned group schedules).
FAULTS_SLICE = (
    "distributedvolunteercomputing_tpu_torch.swarm.chaos",
    "distributedvolunteercomputing_tpu_torch.swarm.matchmaking",
    "distributedvolunteercomputing_tpu_torch.swarm.averager",
    "distributedvolunteercomputing_tpu_torch.swarm.agg_stream",
    "distributedvolunteercomputing_tpu_torch.swarm.volunteer",
)
FAULTS_SCRIPTS = [REPO / "experiments" / "torch_chaos_soak.py"]


def test_scans_cover_the_faults_slice():
    assert set(FAULTS_SLICE) <= {m for m, _ in _port_modules()}
    assert all(p.exists() for p in FAULTS_SCRIPTS)


def test_faults_scripts_load_no_jax():
    # A subprocess: the slice's modules, then each new script's own imports,
    # then the chaos soak's campaigns (the reference script's text on the port).
    code = (
        "import importlib, json, runpy, sys\n"
        f"for m in {list(FAULTS_SLICE)!r}: importlib.import_module(m)\n"
        f"ns = [runpy.run_path(s) for s in {[str(p) for p in FAULTS_SCRIPTS]!r}]\n"
        "campaigns = ns[0]['load_campaigns']()\n"
        "from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager\n"
        "assert issubclass(campaigns['SyncAverager'], SyncAverager) and callable(campaigns['tail_campaign'])\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120, check=True,
    )
    leaked = [m for m in json.loads(out.stdout.strip().splitlines()[-1]) if _forbidden(m)]
    assert not leaked, f"faults slice pulled in {leaked[:10]}"


def test_scans_cover_the_trainer_slice():
    assert set(TRAINER_SLICE) <= {m for m, _ in _port_modules()}


def test_scans_cover_the_models_slice():
    assert set(MODELS_SLICE) <= {m for m, _ in _port_modules()}


def test_scans_cover_the_swarm_slice():
    assert set(SWARM_SLICE) <= {m for m, _ in _port_modules()}


def test_scans_cover_the_lifecycle_slice():
    assert set(LIFECYCLE_SLICE) <= {m for m, _ in _port_modules()}
    assert all(p.exists() for p in ENTRY_SCRIPTS)


def test_scans_cover_the_protocols_slice():
    assert set(PROTOCOLS_SLICE) <= {m for m, _ in _port_modules()}


def test_entry_scripts_load_no_jax():
    # A subprocess, as above: each script's own imports, then the package
    # modules its main() reaches, then the volunteer script's main() itself.
    code = (
        "import importlib, json, runpy, sys\n"
        f"for s in {[str(p) for p in ENTRY_SCRIPTS]!r}: runpy.run_path(s)\n"
        f"for m in {list(LIFECYCLE_SLICE + PROTOCOLS_SLICE + MODELS_SLICE + TRAINER_SLICE)!r}:\n"
        "    importlib.import_module(m)\n"
        "sys.argv = ['run_volunteer_torch.py', '--list-models']\n"
        f"runpy.run_path({str(ENTRY_SCRIPTS[1])!r}, run_name='__main__')\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120, check=True,
    )
    lines = out.stdout.strip().splitlines()
    assert {"gpt2_small", "mnist_mlp", "cifar10_resnet18", "cifar10_vit", "bert_mlm", "llama_lora"} <= set(lines[:-1])
    leaked = [m for m in json.loads(lines[-1]) if _forbidden(m)]
    assert not leaked, f"entry scripts pulled in {leaked[:10]}"


def test_import_loads_no_jax():
    # A subprocess: tests/conftest.py has already imported the JAX package here.
    mods = [m for m, _ in _port_modules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    leaked = [m for m in loaded if _forbidden(m)]
    assert not leaked, f"port imports pulled in {leaked[:10]}"


WIRES_SLICE = (
    "distributedvolunteercomputing_tpu_torch.swarm.powersgd",
    "distributedvolunteercomputing_tpu_torch.swarm.sharding",
    "distributedvolunteercomputing_tpu_torch.training.checkpoint",
    "distributedvolunteercomputing_tpu_torch.ops.mesh_codec",
)
WIRES_SCRIPTS = [REPO / "experiments" / "torch_shard_bench.py", REPO / "experiments" / "torch_byz_ratio.py"]


def test_scans_cover_the_wires_slice():
    assert set(WIRES_SLICE) <= {m for m, _ in _port_modules()}
    assert all(p.exists() for p in WIRES_SCRIPTS)


def test_wires_scripts_load_no_jax():
    # A subprocess: the slice's modules, the shard bench with the reference
    # bench's text on the port, and the chaos soak's shard campaign.
    code = (
        "import importlib, json, runpy, sys\n"
        f"for m in {list(WIRES_SLICE)!r}: importlib.import_module(m)\n"
        f"bench = runpy.run_path({str(WIRES_SCRIPTS[0])!r})['load_bench']()\n"
        f"soak = runpy.run_path({str(FAULTS_SCRIPTS[0])!r})['load_campaigns']()\n"
        "from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager\n"
        "from distributedvolunteercomputing_tpu_torch.swarm.sharding import ShardManager\n"
        "assert issubclass(bench['SyncAverager'], SyncAverager) and callable(bench['run_config'])\n"
        "assert soak['ShardManager'] is ShardManager and callable(soak['shard_campaign'])\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120, check=True,
    )
    leaked = [m for m in json.loads(out.stdout.strip().splitlines()[-1]) if _forbidden(m)]
    assert not leaked, f"wires slice pulled in {leaked[:10]}"


# The modules of the model-parallel slice (the partition rules, the sharded
# steps, gpt2_moe).
MESH_SLICE = (
    "distributedvolunteercomputing_tpu_torch.parallel",
    "distributedvolunteercomputing_tpu_torch.parallel.sharding",
    "distributedvolunteercomputing_tpu_torch.parallel.train_step",
    "distributedvolunteercomputing_tpu_torch.models.common",
    "distributedvolunteercomputing_tpu_torch.models.moe",
)


def test_scans_cover_the_mesh_slice():
    assert set(MESH_SLICE) <= {m for m, _ in _port_modules()}


def test_mesh_slice_loads_no_jax():
    # A subprocess: the slice's modules, then a dp2ep2tp2 step of a tiny
    # gpt2_moe on CPU ranks.
    code = (
        "import importlib, json, sys, torch\n"
        f"for m in {list(MESH_SLICE)!r}: importlib.import_module(m)\n"
        "from distributedvolunteercomputing_tpu_torch.models import get_model\n"
        "from distributedvolunteercomputing_tpu_torch.parallel import make_mesh, train_step as pts\n"
        "from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer\n"
        "from distributedvolunteercomputing_tpu_torch.training.steps import TrainState\n"
        "b = get_model('gpt2_moe', vocab=64, max_len=8, d_model=16, n_heads=2, n_layers=1, d_ff=16, n_experts=4)\n"
        "mesh = make_mesh(dp=2, ep=2, tp=2, devices=['cpu'] * 8)\n"
        "tx = make_optimizer('adamw')\n"
        "st, _ = pts.shard_train_state(TrainState.create(b.init(torch.Generator()), tx, torch.Generator()), mesh)\n"
        "st, m = pts.make_sharded_train_step(b.loss_fn, tx, mesh)(st, pts.put_batch(b.make_batch(torch.Generator(), 4), mesh))\n"
        "assert torch.isfinite(m['loss'])\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120, check=True,
    )
    leaked = [m for m in json.loads(out.stdout.strip().splitlines()[-1]) if _forbidden(m)]
    assert not leaked, f"mesh slice pulled in {leaked[:10]}"


SCRIPTS = [REPO / "chip_smoke.py"] + ENTRY_SCRIPTS + [REPO / "experiments" / f for f in (
    "torch_step_profile.py", "torch_ring_cards.py", "torch_dp_trace.py", "torch_attention_shapes.py",
    "torch_dq_variants.py", "torch_codec_variants.py", "torch_avg_ab.py", "torch_departed_member.py",
    "torch_ring_variants.py", "torch_trainer_modes.py")] + FAULTS_SCRIPTS + WIRES_SCRIPTS


@pytest.mark.parametrize("path", SCRIPTS + [p for _, p in _port_modules()], ids=lambda p: p.name)
def test_sources_import_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


def test_trainer_without_device_needs_a_card():
    from distributedvolunteercomputing_tpu_torch.models import get_model
    from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer

    bundle = get_model("gpt2_small", n_layers=1, d_model=64, n_heads=1, d_ff=64, vocab=64, max_len=16)
    if torch.cuda.is_available():
        assert Trainer(bundle, batch_size=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(bundle, batch_size=2)
    assert Trainer(bundle, batch_size=2, device="cpu").device.type == "cpu"


def test_unported_models_say_so():
    from distributedvolunteercomputing_tpu_torch.models import get_model

    # The zoo's last model is ported; a name outside the zoo still says so.
    assert get_model("gpt2_moe").name == "gpt2_moe"
    with pytest.raises(KeyError, match="unknown model"):
        get_model("no_such_model")
