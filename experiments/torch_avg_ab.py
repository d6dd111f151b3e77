#!/usr/bin/env python3
"""``chip_smoke.py``'s trainer and averaging phases from two trees in turns,
on one GPU.

    git archive <parent commit> | tar -x -C build/parent   # the other tree
    python3 experiments/torch_avg_ab.py [--other build/parent] [--order pccppccp] [--ring]

Each run is a process of its own that imports ``chip_smoke`` and the port
from its tree, builds that tree's kernels and runs ``trainer_phase()`` (20
timed full-width gpt2_small steps; its parity check left out) and
``averaging_phase()``: two full-width volunteers in blocking bf16 sync
rounds on the one card. ``p`` is the other tree, ``c`` this checkout.
Prints one JSON line per run (the trainer's samples/s, round seconds per
volunteer, committed rounds, the phase's round spans), then the card's
name and power limit. With ``--ring`` each run is ``ring_averaging``
alone instead: the averaging phase with both volunteers on a dp=2 mesh of
``chip_smoke.ring_ranks(2)`` and ``mesh_collective="ring"`` (K6 / K7).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CODE = (
    "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs;"
    "from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device; resolve_device(None);"
    "from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa;"
    "cs.parity_phase = lambda *a: None; cs.trainer_phase(fa); cs.averaging_phase()"
)
RING_CODE = (
    "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs;"
    "from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device; resolve_device(None);"
    "devices, _ = cs.ring_ranks(2);"
    "cs.averaging_phase(mesh=cs._mesh(devices), collective='ring', phase='ring_averaging')"
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--other", default=str(HERE / "build" / "parent"), help="the other tree (p)")
    ap.add_argument("--order", default="pccppccp", help="runs in turn: p = the other tree, c = this one")
    ap.add_argument("--ring", action="store_true", help="run ring_averaging alone (dp=2 mesh, K6 / K7)")
    args = ap.parse_args()
    code, phase = (RING_CODE, "ring_averaging") if args.ring else (CODE, "averaging")
    trees = {"p": Path(args.other).resolve(), "c": HERE}
    for tag in args.order:
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", code, str(trees[tag])], capture_output=True, text=True, cwd=str(trees[tag])
        )
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        row = next((r for r in rows if r.get("phase") == phase), None)
        trainer = next((r for r in rows if r.get("phase") == "trainer"), {})
        rec = {"tree": tag, "rc": proc.returncode, "wall_s": time.time() - t0,
               "samples_per_sec": trainer.get("samples_per_sec"), "step_ms": trainer.get("step_ms")}
        if row:
            rec.update(round_s=row["round_s"], rounds_ok=row["rounds_ok"], rounds_skipped=row["rounds_skipped"],
                       run_s=row["run_s"], spans=row["spans"], steps=row["steps"], launches=row["launches"])
        else:
            rec["err"] = proc.stderr[-1500:]
        print(json.dumps(rec), flush=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
