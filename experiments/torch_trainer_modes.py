#!/usr/bin/env python3
"""``chip_smoke.py``'s phases of the trainer's other modes alone, on one GPU.

    python3 experiments/torch_trainer_modes.py [multi_step grad_averaging outer_sync mnist_file resnet_file]

Builds the kernels (``chip_smoke.build_phase``), then runs the named phases
(all five by default, ~2 min on an H100): ``multi_step`` (8 full-width
gpt2_small steps chunked against single steps, then eval through K1),
``grad_averaging`` (two volunteers, a gradient round every step),
``outer_sync`` (sync rounds with the outer Nesterov step, the checkpoint
sidecar), ``mnist_file`` and ``resnet_file`` (capability configs 6 and 7 on
files of ``experiments/make_npz.py``). Each phase prints its JSON line, as
in ``chip_smoke.py``, then ``PHASE_OK`` or ``PHASE_FAILED`` with its
seconds; a failed phase does not stop the others. Prints the card's name
and power limit first; exits 1 when a phase failed, 2 without a GPU.
"""

import shutil
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

PHASES = ("multi_step", "grad_averaging", "outer_sync", "mnist_file", "resnet_file")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_trainer_modes: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from distributedvolunteercomputing_tpu_torch.ops import flash_attention as fa
    from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device

    which = sys.argv[1:] or list(PHASES)
    unknown = set(which) - set(PHASES)
    if unknown:
        print(f"unknown phases {sorted(unknown)}; known: {PHASES}", file=sys.stderr)
        return 2
    resolve_device(None)
    print(cs.nvidia_smi(), flush=True)
    cs.build_phase()
    data_dir = HERE / "build" / "chip_smoke" / "data"
    data_dir.mkdir(parents=True, exist_ok=True)
    runs = {
        "multi_step": lambda: cs.multi_step_phase(fa),
        "grad_averaging": cs.grad_averaging_phase,
        "outer_sync": cs.outer_sync_phase,
        "mnist_file": lambda: cs.mnist_file_phase(data_dir),
        "resnet_file": lambda: cs.resnet_file_phase(data_dir),
    }
    failed = []
    try:
        for name in which:
            t0 = time.perf_counter()
            try:
                runs[name]()
                print("PHASE_OK", name, round(time.perf_counter() - t0, 3), flush=True)
            except Exception as e:  # noqa: BLE001 — report and go on to the next phase
                traceback.print_exc()
                failed.append(name)
                print("PHASE_FAILED", name, round(time.perf_counter() - t0, 3), str(e)[:4000], flush=True)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
