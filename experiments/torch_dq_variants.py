#!/usr/bin/env python3
"""Variants of the Hopper dq kernel (K2), checked and timed in turns on one GPU.

    python3 experiments/torch_dq_variants.py

Each variant is ``csrc/flash_attention.cu`` with a few lines replaced,
written with the other sources under ``build/dq_variants/<variant>/`` (the
repo's sources are not touched) and built into its own library. For each
variant, in turns (all variants, then all again in reverse order), K2 is
held against ``flash_dq_plain`` row by row (``chip_smoke.TOL``) and timed by
device time (``chip_smoke.device_ms``) at the flagship shape causal and
not, at D=128 causal and at T=4096 causal; the build's registers, spill
bytes and HGMMA count are printed beside. Variants: ``current`` (the
source as it is), ``two_stages`` (two K/V stages at D=64 instead of three)
and ``wait_first`` (wait for the next K/V stage before issuing
dQ += dS.K, not after). Prints one JSON line per reading, a summary line
and the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from distributedvolunteercomputing_tpu_torch.ops import _build  # noqa: E402
from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device  # noqa: E402

VARIANTS = {
    "current": [],
    "two_stages": [("static constexpr int stages = D == 64 ? 3 : 2;", "static constexpr int stages = 2;")],
    "wait_first": [(
        "      wg_fence();\n      issue_dq(j - 1);\n      wg_commit();\n      mbar_wait(full(j), use(j));\n",
        "      mbar_wait(full(j), use(j));\n      wg_fence();\n      issue_dq(j - 1);\n      wg_commit();\n",
    )],
}
SOURCES = _build.SOURCES  # the repo's own
SHAPES = ((cs.FLAGSHIP, True), (cs.FLAGSHIP, False), (cs.D128, True), ((2, 12, 4096, 64), True))


def variant_sources(name: str) -> tuple:
    """The sources with the variant's replacements, under build/dq_variants/."""
    out = ROOT / "build" / "dq_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for src in SOURCES:
        text = src.read_text()
        if src.name == "flash_attention.cu":
            for old, new in VARIANTS[name]:
                if old not in text:
                    raise RuntimeError(f"variant {name}: {old!r} not in {src.name}")
                text = text.replace(old, new)
        dst = out / src.name
        dst.write_text(text)
        paths.append(dst)
    return tuple(paths)


def use_variant(name: str) -> dict:
    """Build and load the variant's library; its K2 build report."""
    _build.SOURCES = variant_sources(name)
    _build._lib = None
    _build.build_info.clear()
    _build.load_library()
    report = cs.kernel_build_report(_build.build_info["log"], _build.build_info["path"])
    return {("D128" if "ILi128E" in n else "D64"): r for n, r in report.items() if "6hopper15flash_dq_kernel" in n}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_dq_variants: needs a CUDA device", file=sys.stderr)
        return 2
    resolve_device(None)
    rtol, atol, _ = cs.TOL[torch.bfloat16]
    inputs = {}
    for shape, causal in SHAPES:
        q, k, v, do = cs.attention_inputs(shape, torch.bfloat16, "contiguous")
        o, lse = fa.flash_fwd_plain(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        inputs[shape, causal] = (q, k, v, do, lse, delta, fa.flash_dq_plain(q, k, v, do, lse, delta, causal))
    summary = {}
    try:
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            build = use_variant(name)
            for (shape, causal), (q, k, v, do, lse, delta, want) in inputs.items():
                used = cs.row_check(fa.flash_dq(q, k, v, do, lse, delta, causal), want, rtol, atol)["limit_used"]
                if not used <= 1.0:
                    raise AssertionError(f"variant {name} disagrees with flash_dq_plain at {shape} causal={causal}")
                ms = cs.device_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta, causal), 40)["ms"]
                summary.setdefault(name, {}).setdefault(f"{list(shape)} causal={causal}", []).append(ms)
                print(json.dumps({"variant": name, "shape": list(shape), "causal": causal, "ms": ms,
                                  "limit_used": used, "build": build}), flush=True)
    finally:
        _build.SOURCES = SOURCES
    print(json.dumps({"summary_ms": summary, "method": cs.DEVICE_MS_METHOD}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
