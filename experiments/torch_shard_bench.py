#!/usr/bin/env python3
"""Shard bench on the PyTorch port: ``experiments/shard_bench.py``'s cells on
port averagers, with the codec on the card.

    python3 experiments/torch_shard_bench.py                # K = 1, 2, 4
    python3 experiments/torch_shard_bench.py --quick        # smaller tree, 2 rounds
    python3 experiments/torch_shard_bench.py --quick --device cpu

Each cell is two zones of K volunteers on a pinned schedule whose every
rotation crosses zones; K = 1 averages the whole tree (the replicated
baseline), K > 1 tags each volunteer with its shard so same-shard holders
rendezvous and each averages only its slice. The bench reports cross-zone
bytes per committed volunteer-round, measured from the transports' per-peer
counters joined with the membership's zone map (``zone_traffic()``), and
its verdict: bytes per commit must fall at least 1.5x from K = 1 to 2 and
again from 2 to 4.

The reference script's text is loaded with its import root rewritten to the
port (as the CPU tests run the reference's test files) and run in a
namespace of its own. Its averagers use the process codec, which this
script configures on ``--device`` (the card unless ``cpu`` is asked for)
with the device backend; ``--wire`` (the reference's f32 by default, or
bf16) is every averager's wire.

Writes ``--out`` (default ``build/torch_shard_bench.json``), prints one JSON
line per cell and the verdict; exits 1 when a ``pass_`` verdict fails or a
codec op ran off the device backend.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def load_bench(wire: str = "f32") -> dict:
    """The reference shard bench's namespace on the port, its averagers on
    ``wire``."""
    for p in (REPO, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager

    path = os.path.join(HERE, "shard_bench.py")
    with open(path) as f:
        src = re.sub(r"\bdistributedvolunteercomputing_tpu(?=[.\s])", "distributedvolunteercomputing_tpu_torch",
                     f.read())
    ns = {"__name__": "torch_shard_bench_reference", "__file__": path}
    exec(compile(src, path, "exec"), ns)

    class WireAverager(SyncAverager):
        """The bench's SyncAverager on ``wire`` unless one is given."""

        def __init__(self, *a, **kw):
            kw.setdefault("wire", wire)
            super().__init__(*a, **kw)

    ns["SyncAverager"] = WireAverager
    return ns


def verdict(cells: dict) -> dict:
    """The reference script's verdict (its ``main``)."""
    b1, b2, b4 = (cells[k]["xz_bytes_per_commit"] for k in ("1", "2", "4"))
    out = {
        "xz_bytes_per_commit_k1": b1,
        "xz_bytes_per_commit_k2": b2,
        "xz_bytes_per_commit_k4": b4,
        "ratio_k1_over_k2": round(b1 / max(b2, 1.0), 2),
        "ratio_k2_over_k4": round(b2 / max(b4, 1.0), 2),
        "ratio_k1_over_k4": round(b1 / max(b4, 1.0), 2),
        "pass_k2_beats_replicated": b1 / max(b2, 1.0) >= 1.5,
        "pass_k4_beats_k2": b2 / max(b4, 1.0) >= 1.5,
        "pass_all_commit": all(c["commit_frac"] >= 0.7 for c in cells.values()),
    }
    out["pass"] = bool(out["pass_k2_beats_replicated"] and out["pass_k4_beats_k2"] and out["pass_all_commit"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the codec runs: the card (default; exits when there is none) or the CPU")
    ap.add_argument("--wire", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--tree-elems", type=int, default=None, help="default: the reference's")
    ap.add_argument("--rounds", type=int, default=None, help="default: the reference's")
    ap.add_argument("--links", action="store_true", help="model the thin cross-zone WAN edges")
    ap.add_argument("--quick", action="store_true", help="the reference's --quick tree and rounds")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "torch_shard_bench.json"))
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    import torch

    from distributedvolunteercomputing_tpu_torch import native
    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device

    device = resolve_device(args.device)  # raises without a card unless --device cpu
    if not native.ensure_built():
        raise RuntimeError("the host codec's C++ core did not build")
    codec = mc.configure(device=device, backend="device")
    ns = load_bench(args.wire)
    tree_elems = args.tree_elems or (32_768 if args.quick else ns["TREE_ELEMS"])
    rounds = args.rounds or (2 if args.quick else ns["ROUNDS"])
    out = {"device": str(device), "device_name": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "wire": args.wire, "tree_elems": tree_elems, "rounds": rounds, "links": args.links, "cells": {}}
    before = codec.stats()
    for k in (1, 2, 4):
        mc.reset_launch_counts()
        t0 = time.perf_counter()
        cell = asyncio.run(ns["run_config"](k, tree_elems=tree_elems, rounds=rounds, links=args.links))
        cell["seconds"] = time.perf_counter() - t0
        cell["launches"] = dict(mc.LAUNCHES)
        out["cells"][str(k)] = cell
        print(json.dumps(cell, default=str), flush=True)
    after = codec.stats()
    out["verdict"] = verdict(out["cells"])
    out["verdict"]["pass_codec_on_device"] = after["backend"] == "device" and after["ops_host"] == before["ops_host"]
    print(json.dumps(out["verdict"]), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, default=str)
    print(f"[done] -> {args.out}")
    return 0 if all(v for k, v in out["verdict"].items() if k.startswith("pass")) else 1


if __name__ == "__main__":
    sys.exit(main())
