#!/usr/bin/env python3
"""What serializes the ranks of the port's data-parallel train step.

    python3 experiments/torch_dp_trace.py [--steps 3]

Builds the full-width gpt2_small ``Trainer`` (batch 8, remat on, bf16) in
four placements, one after the other in one process:

- ``one_rank_bs8``: no mesh, the whole batch on cuda:0;
- ``one_rank_bs4``: no mesh, half the batch (one dp rank's share);
- ``dp2_shared``: a dp=2 mesh whose two ranks share cuda:0;
- ``dp2_cross``: a dp=2 mesh on cuda:0 and cuda:1 (needs two cards).

For each, after two warm-up steps, it times ``--steps`` steps of the
trainer's step function on a batch already on the device: ``wall_ms`` from
the host clock with every card synchronized before and after, and
``dispatch_ms``, the host time until the step function returns (the kernels
are queued, not finished). ``grad_half_ms`` is the host time of each rank's
``grad_half`` call inside the dp step. Then one step is traced with
``torch.profiler``: per card, the summed device time of its kernels and
copies (``busy_ms``), and, for two cards, the time both were busy at once
(``both_busy_ms``). Last, one step runs under
``torch.cuda.set_sync_debug_mode("warn")`` and the synchronizing calls it
makes are counted by the Python line that made them. One JSON line per
placement. Needs a CUDA device; ``dp2_cross`` needs two.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
from collections import Counter, defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from distributedvolunteercomputing_tpu_torch.models import get_model  # noqa: E402
from distributedvolunteercomputing_tpu_torch.parallel import train_step as ts  # noqa: E402
from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer  # noqa: E402


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(xs, ys) -> float:
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_intervals(prof) -> dict:
    """Per card index, the merged [start, end) microseconds of its kernels
    and copies in the trace."""
    from torch.autograd import DeviceType

    per = defaultdict(list)
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            per[evt.device_index].append((evt.time_range.start, evt.time_range.end))
    return {d: merged(v) for d, v in per.items()}


def placement(name: str, bundle, batch_size: int, devices, steps: int) -> dict:
    mesh = make_mesh(dp=len(devices), devices=devices) if devices else None
    trainer = Trainer(bundle, batch_size=batch_size, mesh=mesh, total_steps=1000)
    gen = torch.Generator().manual_seed(3)
    batch = trainer._to_device(bundle.make_batch(gen, batch_size))
    step = trainer._step_fn
    rank_ms: list = []
    inner = ts.grad_half

    def timed_grad_half(*args, **kw):
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        rank_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    ts.grad_half = timed_grad_half
    try:
        for _ in range(2):
            trainer.state, _ = step(trainer.state, batch)
        sync_all()
        rank_ms.clear()
        walls, dispatches = [], []
        for _ in range(steps):
            sync_all()
            t0 = time.perf_counter()
            trainer.state, _ = step(trainer.state, batch)
            t1 = time.perf_counter()
            sync_all()
            walls.append((time.perf_counter() - t0) * 1e3)
            dispatches.append((t1 - t0) * 1e3)
        per_rank = [rank_ms[r::len(devices)] for r in range(len(devices))] if devices else []

        from torch.profiler import ProfilerActivity, profile

        sync_all()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.state, _ = step(trainer.state, batch)
            sync_all()
        iv = device_intervals(prof)
        busy = {str(d): sum(b - a for a, b in v) / 1e3 for d, v in sorted(iv.items())}
        both = overlap_us(iv.get(0, []), iv.get(1, [])) / 1e3 if len(iv) >= 2 else None

        sync_all()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                trainer.state, _ = step(trainer.state, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sync_all()
        syncs = Counter(
            f"{Path(w.filename).name}:{w.lineno}" for w in caught if "synchroniz" in str(w.message).lower()
        )
    finally:
        ts.grad_half = inner
    row = {
        "placement": name, "batch_size": batch_size, "devices": [str(d) for d in devices] or ["cuda:0"],
        "steps": steps, "wall_ms": statistics.median(walls), "dispatch_ms": statistics.median(dispatches),
        "samples_per_sec": batch_size / statistics.median(walls) * 1e3,
        "grad_half_ms": [statistics.median(r) for r in per_rank],
        "traced_busy_ms": busy, "traced_both_busy_ms": both,
        "sync_calls": sum(syncs.values()), "sync_sites": syncs.most_common(8),
    }
    del trainer, batch, prof
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dp_trace: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps({"torch": torch.__version__, "cards": smi}), flush=True)
    bundle = get_model("gpt2_small")
    c0 = torch.device("cuda", 0)
    plan = [("one_rank_bs8", 8, []), ("one_rank_bs4", 4, []), ("dp2_shared", 8, [c0, c0])]
    if torch.cuda.device_count() >= 2:
        plan.append(("dp2_cross", 8, [c0, torch.device("cuda", 1)]))
    for name, bs, devices in plan:
        print(json.dumps(placement(name, bundle, bs, devices, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
