#!/usr/bin/env python3
"""Which volunteer's result the mesh swarm's value check holds to the
leader's bound, after a round both volunteers skipped.

    python3 experiments/torch_mesh_swarm_leader.py               # 4 runs, the round at step 4 skipped
    python3 experiments/torch_mesh_swarm_leader.py --runs 1 --skip-steps 4,8

Runs ``chip_smoke.py``'s phase 33 (``mesh_swarm_phase``: two
``run_volunteer_torch.py`` volunteers of gpt2_moe, ``--mesh ep=2,tp=2`` and
``--mesh dp=2 --fsdp``, bf16 sync rounds every 2 steps) on the CPU at a tiny
size (1 layer, d_model 128, vocab 8192, 4 experts: a payload of several wire
chunks, so the leader folds a streamed contribution). In the rounds at
``--skip-steps`` each volunteer defers the lead to the other, so both wait
for a begin and skip, as two volunteers whose views of each other's uplink
disagree do.

Each committed round pair is checked twice, on the same recorded values:
- naming the leader from the group each volunteer recorded (the phase's
  rule): the leader's result against the weighted mean of the two
  contributions within one bf16 rounding, the member's against the leader's;
- naming as leader the volunteer whose result has the smaller max abs error
  against the mean (the rule the phase used before it recorded the group).
  The member's result is the leader's rounded to bf16 once more, so when it
  is named the leader its error can reach two roundings.

Prints one JSON line per run: per round, the step, the recorded leader, the
leader each rule named, and the share of its bound each rule's leader and
member used (``leader_limit_used``, ``member_limit_used``; the check fails
above 1).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

ROW = ("leader", "leader_limit_used", "member_limit_used")
TINY = dict(n_layers=1, d_model=128, n_heads=2, d_ff=128, vocab=8192, max_len=32, n_experts=4)
# A volunteer of the phase, spawned as ``<dir>/chip_smoke.py --mesh-swarm-child DIR -- argv``.
CHILD = """import sys
sys.path.insert(0, {exp!r})
import torch_mesh_swarm_leader as exp
sys.exit(exp.child(sys.argv[2], sys.argv[4:]))
"""


def child(record_dir: str, argv: list) -> int:
    """One volunteer: in the rounds at ``SKIP_STEPS`` (the environment) it
    names the other volunteer as the leader to wait for."""
    import chip_smoke
    from distributedvolunteercomputing_tpu_torch.swarm import matchmaking
    from distributedvolunteercomputing_tpu_torch.training import trainer

    skip = {int(s) for s in os.environ.get("SKIP_STEPS", "").split(",") if s}
    state = {"skip": False}
    run_round, pick = trainer.Trainer._run_average_round, matchmaking.Matchmaker._pick_leader

    def skipping_round(self, step_no):
        state["skip"] = step_no in skip
        try:
            return run_round(self, step_no)
        finally:
            state["skip"] = False

    def deferring_pick(self, members):
        others = [pid for pid, _ in members if pid != self.peer_id]
        return others[0] if state["skip"] and others else pick(self, members)

    trainer.Trainer._run_average_round = skipping_round
    matchmaking.Matchmaker._pick_leader = deferring_pick
    return chip_smoke.mesh_swarm_child(record_dir, argv)


def run_once(skip_steps: str) -> dict:
    import torch

    import chip_smoke as cs

    torch.set_num_threads(2)
    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="mesh_swarm_leader_", dir=REPO / "build"))
    (root / "chip_smoke.py").write_text(CHILD.format(exp=str(HERE)))
    for name in ("coordinator_torch.py", "run_volunteer_torch.py", "distributedvolunteercomputing_tpu_torch"):
        (root / name).symlink_to(REPO / name)
    os.environ["SKIP_STEPS"] = skip_steps
    cs.HERE, cs.MESH_DEVICE = root, "cpu"
    cs.flash_per_step = lambda model, overrides=None: (0, 0, 0)  # no kernels on the CPU
    check = cs.check_averaged_values
    rounds = []

    def both_rules(records, failures, all_rounds=False, nearest_leads=False):
        if not all_rounds:
            return check(records, failures, all_rounds=all_rounds, nearest_leads=nearest_leads)
        recorded = check(records, failures, all_rounds=True)
        by_error = [[{**r, "led_streamed": False} for r in rec] for rec in records]
        nearest = check(by_error, [], all_rounds=True)
        for a, b, pair in zip(recorded["rounds"], nearest["rounds"], zip(*records)):
            rounds.append({"step": a["step"], "recorded_leader": [r["led_streamed"] for r in pair].index(True),
                           "recorded_rule": {k: a[k] for k in ROW},
                           "max_abs_error_rule": {k: b[k] for k in ROW}})
        return recorded

    cs.check_averaged_values = both_rules
    try:
        cs.mesh_swarm_phase(overrides=TINY, extra_argv=["--device", "cpu"])
        ok = True
    except AssertionError as e:
        ok, rounds = False, rounds + [{"error": str(e)[:2000]}]
    finally:
        cs.check_averaged_values = check
        shutil.rmtree(root, ignore_errors=True)
    return {"skip_steps": skip_steps, "phase_ok": ok, "rounds": rounds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--skip-steps", default="4", help="comma-separated steps whose round both volunteers skip")
    args = ap.parse_args()
    for _ in range(args.runs):
        print(json.dumps(run_once(args.skip_steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
