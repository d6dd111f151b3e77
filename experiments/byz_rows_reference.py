#!/usr/bin/env python3
"""The Byzantine rejection rule of the JAX package on rows the PyTorch port
produced, on the CPU.

    python3 experiments/torch_byz_ratio.py --dump build/byz_rows      # on the card
    JAX_PLATFORMS=cpu python3 experiments/byz_rows_reference.py build/byz_rows/*.npz

Each ``.npz`` holds one round's three wire payloads (honest, honest, the
×−3 attacker) as ``experiments/torch_byz_ratio.py --dump`` wrote them, the
averaged leaves' shapes, and the port's reading of that round. This script
decodes the payloads with a ``ByzantineAverager`` of the JAX package (its
schema fixed by packing zeros of those shapes, in the same leaf order),
aggregates them with that package's host codec (trimmed mean, trim 1), and
applies the rule of its ``ByzantineAverager`` (a row is rejected when its
squared distance to the aggregate passes 9 times the median row distance
squared). It prints one JSON line per file: the package's ratio for the
attacker's row and the rows it rejects beside the port's.
"""

from __future__ import annotations

import json
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def reference_round(path: str) -> dict:
    import numpy as np

    from distributedvolunteercomputing_tpu.ops import mesh_codec as jax_mc
    from distributedvolunteercomputing_tpu.swarm import health
    from distributedvolunteercomputing_tpu.swarm.averager import ByzantineAverager
    from distributedvolunteercomputing_tpu.swarm.transport import Transport

    got = np.load(path)
    port = json.loads(str(got["port"]))
    shapes = json.loads(str(got["shapes"]))
    wire = port["wire"]
    avg = ByzantineAverager(Transport(), None, types.SimpleNamespace(peer_id="ref"), method="trimmed_mean",
                            method_kw={"trim": 1}, wire=wire, mesh_codec=jax_mc.MeshCodec(backend="host"))
    avg._pack({f"{i:04d}": np.zeros(s, np.float32) for i, s in enumerate(shapes)})
    n = sum(int(np.prod(s)) for s in shapes)
    stack = np.empty((3, n), np.float32)
    for i in range(3):
        stack[i] = avg._buf_from_payload(got[f"payload{i}"].tobytes())
    agg = avg.mesh_codec.aggregate(stack, "trimmed_mean", trim=1)
    d2 = health.row_d2(stack, agg)
    med2 = float(np.median(np.sqrt(d2))) ** 2
    return {"file": os.path.basename(path), "wire": wire, "elements": n,
            "reference_ratio": float(d2[2] / med2), "reference_rejects": [int(i) for i in np.nonzero(d2 > 9.0 * med2)[0]],
            "port_ratio": port["ratio"], "port_rejects_attacker": port["rejected"],
            "ratio_rel_diff": abs(float(d2[2] / med2) - port["ratio"]) / port["ratio"],
            "d2_rel_diff": float(np.max(np.abs(d2 - np.array(port["d2"])) / np.array(port["d2"])))}


def main() -> int:
    paths = sys.argv[1:]
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    for p in paths:
        print(json.dumps(reference_round(p)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
