#!/usr/bin/env python3
"""The ring fold (K6 / K7) and the dp=2 volunteer across cards, beside the
same ring with its ranks sharing one card.

    python3 experiments/torch_ring_cards.py

Runs ``chip_smoke.py``'s ring phases on a machine with two or more GPUs:
``ring_kernels`` with the ranks on the first nd cards (nd = 2 and 4 as the
cards allow: the hops are peer reads over NVLink), then again with nd ranks
sharing cuda:0 (device-local reads), in the same process so the two
placements are compared on the same cards, and with the nd ranks alternating
over cards 0 and 1 (two ranks per K6 launch on each card, ordered by events
between the cards); then ``dp_parity`` with the two
ranks on cards 0 and 1, and ``ring_averaging``: two full-width volunteers on
a dp=2 mesh over cards 0 and 1. Each check is the one ``chip_smoke.py``
makes; each phase prints its JSON line. Needs two or more CUDA devices.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"torch_ring_cards: needs two or more CUDA devices, found {n}", file=sys.stderr)
        return 2
    from distributedvolunteercomputing_tpu_torch.ops import _build
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device

    resolve_device(None)
    _build.load_library()
    cs.emit({"phase": "env", "torch": torch.__version__, "count": n,
             "cards": [torch.cuda.get_device_name(i) for i in range(n)], "nvidia_smi": cs.nvidia_smi()})
    peak = cs.peaks(torch.cuda.get_device_name(0))
    nds = tuple(nd for nd in cs.RING_NDS if nd <= n)
    cs.RING_NDS = nds
    cs.ring_kernels_phase(peak, ranks=lambda nd: ([torch.device("cuda", i) for i in range(nd)], True))
    cs.ring_kernels_phase(peak, ranks=lambda nd: ([torch.device("cuda", 0)] * nd, False))
    cs.ring_kernels_phase(peak, ranks=lambda nd: ([torch.device("cuda", i % 2) for i in range(nd)], True))
    cs.dp_parity_phase()
    cs.averaging_phase(mesh=cs._mesh([torch.device("cuda", 0), torch.device("cuda", 1)]), collective="ring",
                       phase="ring_averaging")
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
