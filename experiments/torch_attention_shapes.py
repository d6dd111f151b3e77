#!/usr/bin/env python3
"""Flash attention kernels against SDPA across shapes, by device time, on one GPU.

    python3 experiments/torch_attention_shapes.py

For each shape (the flagship B 8, H 12, T 1024, D 64 causal and not, a long
T 4096 causal and not, D 128, and short rows T 256), in one process: K1
(forward) and K3 (dk/dv) against their plain versions (row by row, within
``chip_smoke.TOL``), then K1, K3 and ``F.scaled_dot_product_attention``'s
forward timed by device time (``chip_smoke.device_ms``: the calls enqueued
behind a spin kernel, events around the calls only), with TFLOP/s on the
causal pairs. Then the host's enqueue time per wrapper call of K1 (three
TMA tensor maps encoded per call), K2 (four) and K3 (four), at the
flagship shape. Prints one JSON line per shape, one for the enqueue
times, and the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device  # noqa: E402

SHAPES = (
    ((8, 12, 1024, 64), True), ((8, 12, 1024, 64), False),
    ((2, 12, 4096, 64), True), ((2, 12, 4096, 64), False),
    ((2, 8, 1024, 128), True), ((32, 12, 256, 64), True),
)


def enqueue_us(fn, reps: int = 200) -> float:
    """Median host time per call over 5 runs of ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_attention_shapes: needs a CUDA device", file=sys.stderr)
        return 2
    resolve_device(None)
    rtol, atol, _ = cs.TOL[torch.bfloat16]
    for shape, causal in SHAPES:
        q, k, v, do = cs.attention_inputs(shape, torch.bfloat16, "contiguous")
        runs = cs.attention_runs(fa, q, k, v, do, causal)
        b, h, t, d = shape
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        row = {"shape": list(shape), "causal": causal}
        for name, key, flops in (("K1", "flash_fwd", 4 * d * pairs), ("K2", "flash_dq", 6 * d * pairs),
                                 ("K3", "flash_dkv", 8 * d * pairs)):
            kernel, plain = runs[key]
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            used = max(cs.row_check(a, w, rtol, atol)["limit_used"]
                       for a, w in zip(got, want) if a.dim() == 4)
            if not used <= 1.0:
                raise AssertionError(f"{name} disagrees with its plain version at {shape} causal={causal}")
            ms = cs.device_ms(kernel, 20)["ms"]
            row[name] = {"ms": ms, "tflops": flops / ms / 1e9, "limit_used": used}
        ms = cs.device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 20)["ms"]
        row["sdpa_fwd"] = {"ms": ms, "tflops": 4 * d * pairs / ms / 1e9}
        print(json.dumps(row), flush=True)
        del q, k, v, do, runs
    q, k, v, do = cs.attention_inputs(cs.FLAGSHIP, torch.bfloat16, "contiguous")
    runs = cs.attention_runs(fa, q, k, v, do, True)
    print(json.dumps({"enqueue_us_per_call": {
        "K1 (3 tensor maps)": enqueue_us(runs["flash_fwd"][0]),
        "K2 (4 tensor maps)": enqueue_us(runs["flash_dq"][0]),
        "K3 (4 tensor maps)": enqueue_us(runs["flash_dkv"][0]),
    }, "shape": list(cs.FLAGSHIP)}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
