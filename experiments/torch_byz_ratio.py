#!/usr/bin/env python3
"""The Byzantine rejection rule on config 8's compressed gradient arms, round
by round, on the PyTorch port.

    python3 experiments/torch_byz_ratio.py                       # both wires, both starts
    python3 experiments/torch_byz_ratio.py --wire sign --local 2 --rounds 4
    python3 experiments/torch_byz_ratio.py --device cpu --override d_model=128 \\
        --override n_heads=4 --override d_ff=512 --override n_layers=2 --override max_len=128

Three trainers of gpt2_small (full width unless ``--override`` cuts it),
batch 8, the volunteer's defaults (AdamW, lr 1e-3, shared ``init_seed`` 0),
data seeds 1, 2 and 9 as ``chip_smoke.py``'s Byzantine phases give them.
Each takes a gradient per step. The first ``--local`` steps apply each
trainer's own gradient (what a volunteer does after a failed round); every
later step is a round of ``ByzantineAverager``s on ``--wire``: each
contribution goes through its averager's own pack and compression (error
feedback and PowerSGD's warm Q included; PowerSGD at rank 4), the third
trainer's tree scaled by -3 first (``DVC_CHAOS_CONTRIB_SCALE``), the first
averager decodes the two others' payloads, and the codec's trimmed mean
(trim 1) of the three decoded rows is every trainer's gradient. Nothing is sent (each averager's
transport is made and never started): the rounds are the averagers' own
codec paths, in order.

Per round it prints one JSON line: the rejection rule's ratio (the
attacker's squared distance to the aggregate over the median row distance
squared; ``ByzantineAverager`` rejects past 9), whether the attacker is
rejected, the cosine of the two honest decoded rows (for sign rows, twice the
share of coordinates whose signs agree, less one), each row's RMS, and the
attacker's RMS over the honest mean. Writes ``--out`` (default
``build/torch_byz_ratio.json``); with ``--dump DIR``, each arm's first-round
payloads and leaf shapes to ``DIR/<wire>_local<n>_round1.npz``, which
``experiments/byz_rows_reference.py`` reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

BAR = 9.0  # ByzantineAverager: d2 > 9 x median(d)^2 is a rejection
SEEDS = (1, 2, 9)  # honest, honest, attacker
SCALE = -3.0  # config 8's attacker (DVC_CHAOS_CONTRIB_SCALE)
RANK = 4  # config 8's --psgd-rank


def run_arm(wire: str, local: int, rounds: int, device, overrides: dict, dump=None) -> list:
    import numpy as np
    import torch

    from distributedvolunteercomputing_tpu_torch.models import get_model
    from distributedvolunteercomputing_tpu_torch.ops.mesh_codec import MeshCodec
    from distributedvolunteercomputing_tpu_torch.swarm import health
    from distributedvolunteercomputing_tpu_torch.swarm.averager import ByzantineAverager
    from distributedvolunteercomputing_tpu_torch.swarm.transport import Transport
    from distributedvolunteercomputing_tpu_torch.training.trainer import Trainer
    from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_map

    codec = MeshCodec(device=device, backend="device")
    trainers, avgs, its = [], [], []
    for i, seed in enumerate(SEEDS):
        t = Trainer(get_model("gpt2_small", **overrides), batch_size=8, lr=1e-3, seed=seed, init_seed=0,
                    device=device, averager=lambda payload, step: None, average_what="grads")
        trainers.append(t)
        its.append(t.data_iter())
        avgs.append(ByzantineAverager(Transport(), None, types.SimpleNamespace(peer_id=f"v{i}"),
                                      method="trimmed_mean", method_kw={"trim": 1}, wire=wire,
                                      powersgd_rank=RANK, mesh_codec=codec))
    out = []
    for step in range(1, local + rounds + 1):
        t0 = time.perf_counter()
        grads = []
        for t, it in zip(trainers, its):
            g, _, rng = t._grad_fn(t.state, t._to_device(next(it)))
            grads.append((g, rng))
        if step <= local:
            for t, (g, rng) in zip(trainers, grads):
                t.state = t._apply_fn(t.state, g, rng)
            continue
        sels, sent = [], []
        for i, (t, (g, _)) in enumerate(zip(trainers, grads)):
            sel = tree_map(lambda x, p: torch.zeros_like(p) if x is None else x,
                           t.bundle.avg_select(g), t.bundle.avg_select(t.state.params))
            sels.append(sel)
            tree = t._host_tree(sel)
            if i == 2:
                tree = tree_map(lambda a: np.asarray(a, np.float32) * np.float32(SCALE), tree)
            buf = avgs[i]._pack(tree)
            payload, dense = avgs[i]._compress_contribution(buf)
            sent.append((payload, dense))
        rows = [np.asarray(sent[0][1](), np.float32)]
        rows += [avgs[0]._buf_from_payload(bytes(p) if not isinstance(p, bytes) else p) for p, _ in sent[1:]]
        stack = np.stack(rows)
        del rows
        agg = codec.aggregate(stack, "trimmed_mean", trim=1)
        d2 = health.row_d2(stack, agg)
        med2 = float(np.median(np.sqrt(d2))) ** 2
        sq = np.einsum("ij,ij->i", stack, stack, dtype=np.float64)
        cross = float(np.einsum("j,j->", stack[0], stack[1], dtype=np.float64))
        rms = np.sqrt(sq / stack.shape[1])
        rec = {"wire": wire, "local_steps": local, "step": step, "ratio": float(d2[2] / med2),
               "rejected": bool(d2[2] > BAR * med2), "d2": d2.tolist(),
               "honest_cos": cross / float(np.sqrt(sq[0] * sq[1])), "rms": rms.tolist(),
               "attacker_rms_over_honest": float(rms[2] / (0.5 * (rms[0] + rms[1]))),
               "payload_bytes": [len(p) for p, _ in sent], "s": time.perf_counter() - t0}
        del stack
        if dump and not out:
            # The first round's three payloads and the leaves' shapes, for
            # ``experiments/byz_rows_reference.py`` (the rule on the JAX
            # package, on the CPU, on the same rows).
            os.makedirs(dump, exist_ok=True)
            np.savez(os.path.join(dump, f"{wire}_local{local}_round1.npz"),
                     **{f"payload{i}": np.frombuffer(bytes(p), np.uint8) for i, (p, _) in enumerate(sent)},
                     shapes=json.dumps([list(sp.shape) for sp in avgs[0]._specs]), port=json.dumps(rec))
        for a in avgs:
            a._commit_ef(True)
        for t, a, sel, (g, rng) in zip(trainers, avgs, sels, grads):
            averaged = t._device_tree(a._unpack(agg), sel)
            t.state = t._apply_fn(t.state, t.bundle.avg_merge(g, averaged), rng)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    del trainers, avgs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wire", choices=("sign", "powersgd"), action="append")
    ap.add_argument("--local", type=int, action="append", help="local steps before the first round")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default=None)
    ap.add_argument("--override", action="append", default=[], help="gpt2_small field=value")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "torch_byz_ratio.json"))
    ap.add_argument("--dump", default=None, help="directory for each arm's first-round payloads (.npz)")
    args = ap.parse_args()
    overrides = {k: int(v) for k, v in (o.split("=", 1) for o in args.override)}
    results = []
    for wire in args.wire or ["sign", "powersgd"]:
        for local in args.local or [0, 2]:
            results += run_arm(wire, local, args.rounds, args.device, overrides, args.dump)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"overrides": overrides, "scale": SCALE, "rounds": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
