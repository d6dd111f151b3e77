#!/usr/bin/env python3
"""What a departed member costs the sync rounds of the volunteers that stay,
without and with the resilience layer.

    python3 experiments/torch_departed_member.py                 # on the card: gpt2_small at full width
    python3 experiments/torch_departed_member.py --device cpu --tiny

Three port volunteers in this process average in blocking bf16 sync rounds
every 2 steps until each has committed ``--before`` rounds that all three
fed. Then the third stops as on SIGTERM (its current step, a membership
leave, its transport closed; its rendezvous record stays live until it
expires), and the other two go on for ``--after`` averaging calls each.
One JSON line per arm (``resilience`` off, then on): per averaging call of
the two after the departure, as ``chip_smoke.ProtoRecorder`` records it (its
seconds, whether it committed, the group it formed, the outcome), whether it
waited out the gather deadline, and whom this volunteer pre-excluded when it
led the formation.
"""

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

TINY = dict(n_layers=1, d_model=32, n_heads=2, d_ff=64, vocab=64, max_len=16, xent_chunk=8, remat=False)


async def arm(args, resilience: bool) -> dict:
    from chip_smoke import ProtoRecorder
    from distributedvolunteercomputing_tpu_torch.swarm.volunteer import Volunteer, VolunteerConfig

    base = dict(model="gpt2_small", model_overrides=TINY if args.tiny else {}, batch_size=8, averaging="sync",
                wire="bf16", average_every=2, overlap=False, steps=100000, device=args.device,
                gather_timeout=args.gather_timeout, resilience=resilience)
    vols = []
    for i in range(3):
        boot = "%s:%d" % vols[0].transport.addr if vols else None
        vols.append(Volunteer(VolunteerConfig(peer_id=f"vol{i}", seed=i + 1, coordinator=boot, **base)))
        await vols[-1].start()
    recs = [ProtoRecorder(v, keep=0) for v in vols]
    state = {"departed": False}

    def instrument(rec):
        mm = rec.vol.averager.matchmaker

        def before():
            mm.last_preexcluded = []

        def after(call, result):
            call.update(after=state["departed"], deadline=call["s"] >= args.gather_timeout,
                        preexcluded=list(mm.last_preexcluded))
            fed = [sum(1 for c in r.calls if c["ok"] and c["size"] == 3 and not c["deadline"]) for r in recs]
            if not state["departed"] and min(fed) >= args.before:
                state["departed"] = True
                vols[2]._stop.set()
            if state["departed"] and all(sum(c["after"] for c in recs[j].calls) >= args.after for j in (0, 1)):
                vols[0]._stop.set()
                vols[1]._stop.set()

        rec.before, rec.after = before, after

    for rec in recs:
        instrument(rec)
    tasks = [asyncio.create_task(v.train()) for v in vols]
    try:
        await tasks[2]
        await vols[2].stop()
        t_departed = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(*tasks[:2]), args.wait_s)
        after_s = time.perf_counter() - t_departed
    finally:
        for v in vols:
            v._stop.set()
        await asyncio.gather(*tasks, return_exceptions=True)
        await asyncio.gather(*(v.stop() for v in vols), return_exceptions=True)
    after = [[c for c in r.calls if c["after"]] for r in recs[:2]]
    return {"resilience": resilience, "device": str(vols[0].trainer.device), "tiny": args.tiny,
            "gather_timeout": args.gather_timeout, "before": args.before, "after_calls": after,
            "after_s": after_s, "deadline_waits": [sum(c["deadline"] for c in a) for a in after]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true", help="a one-layer gpt2 (for the CPU)")
    ap.add_argument("--gather-timeout", type=float, default=20.0)
    ap.add_argument("--before", type=int, default=2)
    ap.add_argument("--after", type=int, default=4)
    ap.add_argument("--wait-s", type=float, default=600.0)
    args = ap.parse_args()
    from distributedvolunteercomputing_tpu_torch import native

    native.ensure_built()
    for resilience in (False, True):
        print(json.dumps(asyncio.run(arm(args, resilience))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
