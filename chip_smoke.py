#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env      torch / CUDA versions, device count, the card's name and power limit;
2. build    nvcc builds the port's CUDA kernels from csrc/ (seconds, library path);
3. kernels  each flash-attention kernel (K1 forward, K2 dq, K3 dk/dv) against its
            plain PyTorch version, element by element on each row's own scale
            (``TOL``), at the flagship shape (B=8, H=12, T=1024, D=64, bf16,
            causal) and at a ragged shape (T=200), causal and not, in bf16 and
            f32; with kernel / plain / library times (median of CUDA-event
            timings) and the card's bound for the same work;
4. trainer  ``Trainer(get_model("gpt2_small"), batch_size=8)`` at full width:
            2 warm-up steps, 20 timed steps with finite losses, launch counts of
            24 K1 / 12 K2 / 12 K3 per step; then one fwd/bwd through the kernels
            and through the plain attention core on the same batch and on params
            whose attention is far from uniform, with the loss and every
            gradient leaf compared (``PARITY_TOL``).

Then one line listing every kernel, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Any failure raises: the script
exits non-zero and prints no ``ok`` line. It needs one card and no network.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
FLAGSHIP = (8, 12, 1024, 64)
RAGGED_T = 200
# Kernel vs plain version, element by element, each output row on its own
# scale: |kernel - plain| <= atol + rtol * max|plain row|, where a row is one
# query row of O / dq and one key row of dk / dv. Per row, so a late causal
# row (|O| ~ 0.1) is held as tightly as row 0 (|O| ~ 3). atol only covers rows
# whose exact value is 0 (dq of causal row 0 is rounding noise on both sides).
# lse is held in absolute terms.
TOL = {  # dtype -> (rtol, atol, lse atol)
    torch.bfloat16: (2e-2, 2e-5, 1e-4),  # rtol: 2.5 bf16 ulps of the row's max
    torch.float32: (1e-5, 1e-6, 1e-5),
}
# Full-width train step, kernels vs plain core, in f32 and in bf16, per
# gradient leaf: ``leaf_l2`` bounds ||kernels - plain|| / ||plain||,
# ``leaf_max`` bounds max |kernels - plain| / max |plain|; ``loss`` bounds
# the loss's relative difference. In bf16 the plain core rounds dP and P to
# bf16 where the kernels keep f32, so leaves differ by up to ~2e-2; there
# ``vs_plain`` bounds how much farther than the plain core the kernels may
# land from the f32 plain result. Set from readings on an H100 (PERF.md):
# f32 leaves within 1.8e-6, bf16 leaves within 2.5e-2, and the bf16 kernels
# within 0.2% of the plain core's distance from f32.
PARITY_TOL = {
    "f32": {"leaf_l2": 1e-5, "leaf_max": 1e-5, "loss": 1e-6},
    "bf16": {"leaf_l2": 5e-2, "leaf_max": 5e-2, "loss": 1e-5, "vs_plain": 1.1},
}
QK_SCALE = 4.0  # qkv's q/k columns are scaled so attention is far from uniform
KERNELS = {  # name -> (TPU kernel it replaces, what it computes)
    "flash_fwd": ("distributedvolunteercomputing_tpu/ops/pallas_attention.py:94", "K1"),
    "flash_dq": ("distributedvolunteercomputing_tpu/ops/pallas_attention.py:197", "K2"),
    "flash_dkv": ("distributedvolunteercomputing_tpu/ops/pallas_attention.py:240", "K3"),
}
SOURCE = "distributedvolunteercomputing_tpu_torch/csrc/flash_attention.cu"
# Published dense peaks (NVIDIA data sheets): bytes/s, bf16 FLOP/s, f32 FLOP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12), "H100": (3.35e12, 989e12, 67e12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}; add them to PEAKS")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def row_check(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> dict:
    """``got`` against ``want`` [B, H, T, D] row by row (see ``TOL``).

    ``limit_used`` is the largest |error| / (atol + rtol * row scale): the
    check passes iff it is at most 1. ``worst_row_rel`` is the largest
    |error| / row scale over rows whose scale is above atol / rtol."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(-1, keepdim=True)
    used = (err / (atol + rtol * scale)).max().item()
    row_err = err.amax(-1, keepdim=True)
    live = scale > atol / rtol
    worst_rel = (row_err[live] / scale[live]).max().item() if live.any() else 0.0
    return {"limit_used": used, "worst_row_rel": worst_rel, "min_row_scale": scale.min().item()}


def check_kernels(fa, shape, dtype, causal, peak, timed):
    """Each kernel against its plain version on the same inputs."""
    import torch.nn.functional as F

    b, h, t, d = shape
    gen = torch.Generator(device="cuda").manual_seed(1234)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal), lambda: fa.flash_fwd_plain(q, k, v, causal)),
        "flash_dq": (
            lambda: fa.flash_dq(q, k, v, do, lse_ref, delta, causal),
            lambda: fa.flash_dq_plain(q, k, v, do, lse_ref, delta, causal),
        ),
        "flash_dkv": (
            lambda: fa.flash_dkv(q, k, v, do, lse_ref, delta, causal),
            lambda: fa.flash_dkv_plain(q, k, v, do, lse_ref, delta, causal),
        ),
    }
    # Work this run's data needs: the (query, key) pairs the mask keeps.
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor_bytes = b * h * t * d * q.element_size()
    row_bytes = b * h * t * 4
    work = {  # name -> (FLOPs, bytes: each input read once, each output written once)
        "flash_fwd": (4 * d * pairs, 4 * tensor_bytes + row_bytes),
        "flash_dq": (6 * d * pairs, 5 * tensor_bytes + 2 * row_bytes),
        "flash_dkv": (8 * d * pairs, 6 * tensor_bytes + 2 * row_bytes),
    }
    mem_rate, bf16_rate, f32_rate = peak
    op_rate = bf16_rate if dtype == torch.bfloat16 else f32_rate
    library_ms = {}
    if timed:
        qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        library_ms["fwd"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
            torch.autograd.grad(out, (qs, ks, vs), do)

        library_ms["fwd_bwd"] = time_ms(sdpa_fwd_bwd)
    rtol, atol, lse_atol = TOL[dtype]
    results = {}
    for name, (kernel, plain) in runs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        outs = ("o", "lse") if name == "flash_fwd" else ("dq",) if name == "flash_dq" else ("dk", "dv")
        checks = {}
        for out, a, w in zip(outs, got, want):
            if out == "lse":
                checks[out] = {"max_abs_err": abs_err(a, w), "atol": lse_atol}
                checks[out]["limit_used"] = checks[out]["max_abs_err"] / lse_atol
            else:
                checks[out] = row_check(a, w, rtol, atol)
        row = {
            "phase": "kernel_check", "kernel": name, "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
            "causal": causal, "max_abs_err": max(abs_err(a, w) for a, w in zip(got, want)),
            "rtol": rtol, "atol": atol, "checks": checks,
        }
        finite = all(torch.isfinite(a).all() for a in got)
        if not finite or not all(c["limit_used"] <= 1.0 for c in checks.values()):
            emit(row)
            raise AssertionError(f"{name} disagrees with its plain version at {shape} {dtype} causal={causal}")
        flops, nbytes = work[name]
        bytes_ms, ops_ms = nbytes / mem_rate * 1e3, flops / op_rate * 1e3
        row.update(
            bound_ms=max(bytes_ms, ops_ms), bound_us=max(bytes_ms, ops_ms) * 1e3,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            flops=flops, bytes=nbytes,
        )
        if timed:
            row.update(
                ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
                library_ms=library_ms["fwd" if name == "flash_fwd" else "fwd_bwd"],
                library_call="F.scaled_dot_product_attention forward"
                if name == "flash_fwd" else "F.scaled_dot_product_attention forward+backward (K1+K2+K3 work)",
            )
        emit(row)
        results[name] = row
    return results


def trainer_phase(fa, steps_warm: int = 2, steps_timed: int = 20):
    from distributedvolunteercomputing_tpu_torch.models import get_model
    from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer

    bundle = get_model("gpt2_small")
    cfg = bundle.config
    metrics_path = HERE / "build" / "chip_smoke" / "metrics.jsonl"
    metrics_path.parent.mkdir(parents=True, exist_ok=True)
    metrics_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    trainer = Trainer(bundle, batch_size=8, total_steps=steps_warm + steps_timed, metrics_path=str(metrics_path))
    init_s = time.perf_counter() - t0
    warm = trainer.run(steps=steps_warm, log_every=0)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    summary = trainer.run(steps=steps_timed, log_every=0)
    launches = dict(fa.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [json.loads(line)["loss"] for line in metrics_path.read_text().splitlines()]
    expect = {"flash_fwd": 24 * steps_timed, "flash_dq": 12 * steps_timed, "flash_dkv": 12 * steps_timed}
    row = {
        "phase": "trainer", "model": bundle.name, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
        "n_layers": cfg.n_layers, "d_ff": cfg.d_ff, "vocab": cfg.vocab, "seq_len": cfg.max_len,
        "batch_size": 8, "remat": cfg.remat, "init_s": init_s, "warmup_wall_s": warm["wall_time_s"],
        "losses": losses, "timed_steps": steps_timed, "samples_per_sec": summary["samples_per_sec"],
        "step_ms": summary["wall_time_s"] / steps_timed * 1e3,
        "max_memory_allocated": peak_mem, "launches": launches, "launches_expected": expect,
    }
    emit(row)
    if len(losses) != steps_warm + steps_timed or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    parity_phase(bundle, trainer)
    return launches


def leaf_names(tree, prefix: str = "") -> list:
    """Leaf paths in the port's flattening order (sorted keys, depth first)."""
    if isinstance(tree, dict):
        return [n for key in sorted(tree) for n in leaf_names(tree[key], f"{prefix}{key}/")]
    return [prefix.rstrip("/")]


def leaf_diff(got, want, names) -> dict:
    """Per gradient leaf: ||got - want|| / ||want|| and max |got - want| / max |want|."""
    out = {}
    for name, a, b in zip(names, got, want):
        diff, ref = a.float() - b.float(), b.float()
        out[name] = {
            "l2": (diff.norm() / ref.norm().clamp_min(1e-30)).item(),
            "max": (diff.abs().max() / ref.abs().max().clamp_min(1e-30)).item(),
        }
    return out


def parity_phase(bundle, trainer) -> None:
    """Full-width fwd/bwd through the kernels and through the plain core on
    the same params and batch, in f32 and in bf16; every gradient leaf and
    the loss compared (``PARITY_TOL``).

    The trained params are still close to init, where attention is nearly
    uniform and a wrong kernel barely moves the loss. So the q and k columns
    of every layer's qkv weight are scaled by ``QK_SCALE``: layer 0's scores
    then spread over several units and each row's softmax has a clear peak.
    The f32 pass holds the kernels' f32 path tightly. The bf16 pass is the
    main path's dtype; there the two sides round at different points, so each
    is also held against the f32 plain result, and the kernels must be no
    farther from it than ``vs_plain`` times the plain core."""
    from distributedvolunteercomputing_tpu_torch.models import common
    from distributedvolunteercomputing_tpu_torch.models.gpt2 import embed
    from distributedvolunteercomputing_tpu_torch.ops.attention import set_attention_impl, split_heads
    from distributedvolunteercomputing_tpu_torch.training.steps import grad_half
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import compute_dtype_as

    cfg = bundle.config
    params = dict(trainer.state.params)
    blocks = dict(params["blocks"])
    qkv_w = blocks["qkv"]["w"].clone()
    qkv_w[..., : 2 * cfg.d_model] *= QK_SCALE
    blocks["qkv"] = {**blocks["qkv"], "w": qkv_w}
    params["blocks"] = blocks
    state = dataclasses.replace(trainer.state, params=params)
    batch = trainer._to_device(bundle.make_batch(torch.Generator().manual_seed(99), 8))

    with torch.no_grad():  # how far from uniform layer 0's attention is
        p0 = {k: {n: t[0] for n, t in v.items()} for k, v in blocks.items()}
        h = common.layernorm(p0["ln1"], embed(params, batch["tokens"], cfg))
        q, k, _ = common.dense(p0["qkv"], h).split(cfg.d_model, dim=-1)
        s = split_heads(q, cfg.n_heads).float() @ split_heads(k, cfg.n_heads).float().transpose(-1, -2)
        s = s / math.sqrt(cfg.d_model // cfg.n_heads)
        above = torch.ones_like(s, dtype=torch.bool).triu(1)
        probs = torch.softmax(s.masked_fill(above, -1e30), dim=-1)
        layer0 = {
            "score_std": s[~above].std().item(),
            "mean_row_max_prob": probs.amax(-1)[..., 64:].mean().item(),  # rows with >= 65 keys
            "uniform_row_max_prob": (1.0 / torch.arange(65, cfg.max_len + 1, device=s.device)).mean().item(),
        }
        del s, probs, above

    runs = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for side, impl in (("kernels", "auto"), ("plain", "xla")):
                set_attention_impl(impl)
                with compute_dtype_as(dtype):
                    grads, m = grad_half(bundle.loss_fn, state, batch)
                runs[side, dtype] = (grads, float(m["loss"]))
    finally:
        set_attention_impl("auto")
    names = leaf_names(params)
    failures = []
    row = {"phase": "trainer_parity", "qk_scale": QK_SCALE, "layer0_attention": layer0, "tol": PARITY_TOL}
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        (g_k, loss_k), (g_p, loss_p) = runs["kernels", dtype], runs["plain", dtype]
        tol = PARITY_TOL[key]
        leaves = leaf_diff(g_k, g_p, names)
        res = {
            "loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
            "leaf": leaves,
            "worst": {kind: max((e[kind], n) for n, e in leaves.items()) for kind in ("l2", "max")},
        }
        if not all(torch.isfinite(g).all() for g in g_k) or not res["loss_rel_diff"] <= tol["loss"]:
            failures.append(f"{key} loss")
        failures += [f"{key} {n} {kind}" for n, e in leaves.items() for kind in ("l2", "max")
                     if not e[kind] <= tol[f"leaf_{kind}"]]
        if dtype == torch.bfloat16:
            ref = runs["plain", torch.float32][0]
            to_k, to_p = leaf_diff(g_k, ref, names), leaf_diff(g_p, ref, names)
            res["to_f32_plain"] = {n: {"kernels": to_k[n]["l2"], "plain": to_p[n]["l2"]} for n in names}
            ratio = max(to_k[n]["l2"] / max(to_p[n]["l2"], 1e-30) for n in names)
            res["worst_ratio_to_f32"] = ratio
            if not ratio <= tol["vs_plain"]:
                failures.append(f"bf16 kernels {ratio:.3g}x farther from f32 than the plain core")
        row[key] = res
    emit(row)
    if failures:
        raise AssertionError(f"full-width train step through the kernels disagrees with the plain core: {failures}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from distributedvolunteercomputing_tpu_torch.ops import _build
    from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device

    resolve_device(None)  # pins TF32 off for the f32 references
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({
        "phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "device": name, "count": torch.cuda.device_count(), "nvidia_smi": smi,
    })
    peak = peaks(name)

    t0 = time.perf_counter()
    _build.load_library()
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": _build.build_info.get("seconds"),
        "library": _build.build_info["path"], "command": _build.build_info.get("command"),
        "ptxas": [ln.strip() for ln in _build.build_info.get("log", "").splitlines() if "registers" in ln],
    })

    flagship = check_kernels(fa, FLAGSHIP, torch.bfloat16, True, peak, timed=True)
    b, h, _, d = FLAGSHIP
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (False, True):
            check_kernels(fa, (2, h, RAGGED_T, d), dtype, causal, peak, timed=False)

    launches = trainer_phase(fa)

    kernels = []
    for kname, (replaces, kid) in KERNELS.items():
        r = flagship[kname]
        kernels.append({
            "name": kname, "id": kid, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_call": r["library_call"],
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
