#!/usr/bin/env python3
"""Chaos soak on the PyTorch port: the campaigns of ``experiments/chaos_soak.py``
whose modules the port carries, on port averagers over ``ChaosTransport``s
with the codec on the card.

    python3 experiments/torch_chaos_soak.py                 # the five campaigns
    python3 experiments/torch_chaos_soak.py --quick         # short ones
    python3 experiments/torch_chaos_soak.py --campaign tail --device cpu
    python3 experiments/torch_chaos_soak.py --quick --shard  # the shard campaign alone

Campaigns (``--campaign``, repeatable; default all five), each the
reference's own code and verdict:

- ``straggler``: four volunteers, one delayed x10 under a seeded fault
  schedule; deadline-bounded rounds against a blocking baseline, the
  phi-accrual detector's suspicion of the straggler (``campaign``). The
  reference's training phase (subprocess volunteers) is not run here.
- ``failover``: the sync leader killed at each instrumented round phase,
  survivors committing through the epoch-fenced recovery round, and the
  fencing scenario (``failover_campaign``).
- ``multigroup``: eight volunteers on a rotating group schedule, one
  group's leader killed per kill round, a flash-crowd join burst
  (``multigroup_campaign``).
- ``tail``: hedged per-tile recovery against the drop-the-straggler
  baseline at one static round deadline under heavy-tailed links
  (``tail_campaign``).
- ``shard`` (``--shard``): three zones of two shard holders on the
  zone-sharded schedule; each kill round the shard-0 trio's leader dies at
  an instrumented phase and its zone mate re-shards and recovers the
  victim's latest shard bytes (``shard_campaign``).

The reference script's text is loaded with its import root rewritten to the
port (as the CPU tests run the reference's test files) and run in a
namespace of its own; its control-plane and other campaigns are never
called. Every ``SyncAverager`` the
campaigns build takes ``--wire`` (bf16 by default) and the process codec,
which this script configures on ``--device`` (the card unless ``cpu`` is
asked for) with the device backend: K4 encodes and K5 folds on the card.
On the bf16 wire the tail campaign's payload doubles in elements, so its
wire bytes and tiles are the reference's (64 KiB, 16 tiles of 4 KiB).

Writes ``--out`` (default ``build/torch_chaos_soak.json``) and prints one
JSON line per campaign with its verdict; exits 1 when a ``pass_`` verdict
fails or a codec op ran off the device backend.
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
CAMPAIGNS = ("straggler", "failover", "multigroup", "tail", "shard")


def load_campaigns(wire: str = "bf16") -> dict:
    """The reference chaos soak's namespace on the port."""
    for p in (REPO, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    from distributedvolunteercomputing_tpu_torch.swarm.averager import SyncAverager

    path = os.path.join(HERE, "chaos_soak.py")
    with open(path) as f:
        src = re.sub(r"\bdistributedvolunteercomputing_tpu(?=[.\s])", "distributedvolunteercomputing_tpu_torch",
                     f.read())
    ns = {"__name__": "torch_chaos_soak_reference", "__file__": path}
    exec(compile(src, path, "exec"), ns)

    class WireAverager(SyncAverager):
        """The campaigns' SyncAverager on ``wire`` unless one is given."""

        def __init__(self, *a, **kw):
            kw.setdefault("wire", wire)
            super().__init__(*a, **kw)

    ns["SyncAverager"] = WireAverager
    if wire == "bf16":
        ns["TAIL_N_ELEMS"] *= 2  # the reference's 64 KiB of wire bytes, 16 tiles
    return ns


def verdicts(ns: dict, name: str, result: dict) -> dict:
    """The reference script's verdict of each campaign (its ``main``)."""
    if name == "straggler":
        fd = result["faulted_deadline"]
        return {
            "within_budget_frac": fd["within_budget_frac"],
            "pass_95pct_within_budget": fd["within_budget_frac"] >= 0.95,
            "detector_suspect_after_rounds": fd["detector_suspect_after_rounds"],
            "pass_detector_within_3_rounds": (
                fd["detector_suspect_after_rounds"] is not None and fd["detector_suspect_after_rounds"] <= 3
            ),
            "round_time_ratio_blocking_over_deadline": result["round_time_ratio_blocking_over_deadline"],
        }
    if name == "failover":
        fracs = [p["recovery_frac"] for p in result["phases"].values()]
        return {
            "recovery_frac_min": min(fracs),
            "pass_95pct_recovery": min(fracs) >= 0.95,
            "pass_stall_bound": all(p["within_stall_bound"] == p["rounds"] for p in result["phases"].values()),
            "pass_fencing": bool(
                result["fencing"]["survivors_recovered"] and result["fencing"]["stale_serve_rejected"]
                and result["fencing"]["stale_push_rejected"]
            ),
        }
    if name == "multigroup":
        mg = result["verdict_inputs"]
        return {
            "pass_other_groups_unaffected": mg["others_unaffected_rounds"] == mg["rounds"],
            "pass_local_recovery": mg["local_recovery_rounds"] >= 0.8 * mg["rounds"],
            "pass_flash_crowd": (
                mg["burst_rounds"] > 0 and mg["burst_rounds_committed"] == mg["burst_rounds"]
                and mg["max_groups_seen"] >= 4
            ),
        }
    if name == "shard":
        return ns["shard_verdict"](result)
    return ns["tail_verdict"](result)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--campaign", action="append", choices=CAMPAIGNS, default=None,
                    help="campaign to run (repeatable; default all five)")
    ap.add_argument("--shard", action="store_true", help="the shard campaign alone (the reference's --shard)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the codec runs: the card (default; exits when there is none) or the CPU")
    ap.add_argument("--wire", default="bf16", choices=("f32", "bf16"))
    ap.add_argument("--quick", action="store_true", help="the reference's --quick round counts")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--warmup-rounds", type=int, default=10)
    ap.add_argument("--faulted-rounds", type=int, default=25)
    ap.add_argument("--blocking-rounds", type=int, default=6)
    ap.add_argument("--round-cadence-s", type=float, default=0.75)
    ap.add_argument("--failover-rounds", type=int, default=20)
    ap.add_argument("--multigroup-rounds", type=int, default=6)
    ap.add_argument("--tail-rounds", type=int, default=12)
    ap.add_argument("--shard-rounds", type=int, default=6)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "torch_chaos_soak.json"))
    args = ap.parse_args()
    if args.quick:
        args.warmup_rounds, args.faulted_rounds, args.blocking_rounds = 6, 10, 3
        args.failover_rounds, args.multigroup_rounds, args.tail_rounds = 5, 3, 6
        args.shard_rounds = 3
    if args.shard:
        args.campaign = ["shard"]

    sys.path.insert(0, REPO)
    import torch

    from distributedvolunteercomputing_tpu_torch import native
    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device

    device = resolve_device(args.device)  # raises without a card unless --device cpu
    if not native.ensure_built():
        raise RuntimeError("the host codec's C++ core did not build")
    codec = mc.configure(device=device, backend="device")
    ns = load_campaigns(args.wire)
    runners = {"straggler": ns["campaign"], "failover": ns["failover_campaign"],
               "multigroup": ns["multigroup_campaign"], "tail": ns["tail_campaign"],
               "shard": ns["shard_campaign"]}
    out = {"device": str(device), "device_name": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "wire": args.wire, "quick": args.quick, "campaigns": {}}
    ok = True
    for name in args.campaign or CAMPAIGNS:
        mc.reset_launch_counts()
        before = codec.stats()
        t0 = time.perf_counter()
        result = asyncio.run(runners[name](args))
        seconds = time.perf_counter() - t0
        after = codec.stats()
        verdict = verdicts(ns, name, result)
        verdict["pass_codec_on_device"] = after["backend"] == "device" and after["ops_host"] == before["ops_host"]
        row = {"campaign": name, "seconds": seconds, "verdict": verdict,
               "codec_ops": after["ops_mesh"] - before["ops_mesh"], "launches": dict(mc.LAUNCHES)}
        out["campaigns"][name] = {**row, "result": result}
        print(json.dumps(row, default=str), flush=True)
        ok &= all(v for k, v in verdict.items() if k.startswith("pass_"))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, default=str)
    print(f"[done] -> {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
