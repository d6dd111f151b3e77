#!/usr/bin/env python3
"""Where the time of the port's flagship train step goes, on one GPU.

    python3 experiments/torch_step_profile.py [--steps 3] [--batch-size 8]

Builds ``Trainer(get_model("gpt2_small"), batch_size=8)`` (full width, remat
on), and for two attention arms in one process, in turns (kernels, plain,
plain, kernels):

- ``kernels``: ``auto`` routing — attention through the CUDA flash kernels;
- ``plain``: the plain PyTorch attention core (``set_attention_impl("xla")``);

times ``--steps`` steps after warm-up (host clock around work that ends in
``torch.cuda.synchronize()``), then traces the kernels arm with
``torch.profiler`` and sums device time by kernel class (flash kernels,
matrix products, everything else) and by kernel name. The device's busy
share is the summed kernel time over the traced wall time (one stream, so
kernels do not overlap). Prints one JSON line per arm and one for the trace.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from distributedvolunteercomputing_tpu_torch.models import get_model  # noqa: E402
from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distributedvolunteercomputing_tpu_torch.ops.attention import set_attention_impl  # noqa: E402
from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer  # noqa: E402

GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas", "matmul")


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_" in low and "_kernel" in low:
        return "flash_kernels"
    if any(m in low for m in GEMM_MARKS):
        return "matrix_products"
    return "other"


def step_times(trainer: Trainer, steps: int) -> list:
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(steps=1, log_every=0)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val:
            return float(val)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    trainer = Trainer(get_model("gpt2_small"), batch_size=args.batch_size)
    trainer.run(steps=2, log_every=0)  # warm-up: kernel build, allocator, cuBLAS heuristics

    arms = defaultdict(list)
    try:
        for impl, name in (("auto", "kernels"), ("xla", "plain"), ("xla", "plain"), ("auto", "kernels")):
            set_attention_impl(impl)
            trainer.run(steps=1, log_every=0)
            arms[name] += step_times(trainer, args.steps)
    finally:
        set_attention_impl("auto")
    for name, ms in arms.items():
        print(json.dumps({
            "arm": name, "device": smi, "batch_size": args.batch_size, "step_ms": ms,
            "median_step_ms": statistics.median(ms),
            "samples_per_sec": args.batch_size * 1e3 / statistics.median(ms),
        }), flush=True)

    from torch.profiler import ProfilerActivity, profile

    fa.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(steps=args.steps, log_every=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_class = defaultdict(float)
    by_name = defaultdict(float)
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = device_time_us(evt)
        by_class[kernel_class(evt.key)] += us
        by_name[evt.key] += us
    busy_us = sum(by_class.values())
    per_step = lambda us: us / args.steps / 1e3  # noqa: E731  (ms per step)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "trace": "kernels arm", "device": smi, "steps": args.steps,
        "wall_ms_per_step": per_step(wall_us),
        "device_busy_ms_per_step": per_step(busy_us),
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else None,
        "by_class_ms_per_step": {k: per_step(v) for k, v in sorted(by_class.items())},
        "top_kernels_ms_per_step": [[k[:90], per_step(v)] for k, v in top],
        "launches": dict(fa.LAUNCHES),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
