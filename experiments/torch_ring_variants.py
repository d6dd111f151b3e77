#!/usr/bin/env python3
"""Designs of the ring kernels (K6 fold, K7 all-gather) with every rank on one card, checked and timed in turns.

    python3 experiments/torch_ring_variants.py

Each design is held bit-equal to its plain version (``ring_fold_plain``,
``ring_allgather_plain``) at nd = 2 and 4 ranks sharing cuda:0, then timed
in turns (all designs, then all again in reverse order) by device time
(``chip_smoke.device_ms``: launches enqueued behind a spin kernel) and by
the wall of one call (CUDA events around it, host packing included:
``chip_smoke.time_ms``):

- ``card``: the port's one-card design (``csrc/ring_collective.cu``
  ``card_ring_fold_kernel`` / ``card_ring_allgather_kernel``) through its
  wrappers, ``mesh_collective.ring_fold`` and ``ring_allgather``;
- ``batch1`` / ``batch8``: K6 with 1 or 8 chunk loads issued before they
  fold (the port: 4); ``unroll2`` / ``unroll8``: K7 with 2 or 8 groups a
  thread (the port: 4). Text patches of the shipped source, each built alone
  with nvcc (``ops/_build.py``'s flags) into ``build/ring_variants/``;
- ``tma``: K7 by TMA bulk copies (``experiments/torch_ring_variants.cu``,
  ``chip_smoke.ring_tma_library``);
- ``stepwise``: the design the port keeps for ranks on several cards, run
  with the ranks on the one card as the port ran it there before: K6's nd
  ring steps of one launch each (``dvc_ring_fold``, partial slots kept
  across flushes), K7's nd − 1 hops of nd launches, all on the current
  stream, whose order alone orders them.

K6 runs per flagship flush (16 chunks of 1 MiB, 12 tiles, the tail tile and
three repeats, one zero weight, split over the ranks as the ring folder
splits a batch), cycling ``chip_smoke.FLUSH_SETS`` flushes with disjoint
tiles and bits so no call finds its bytes in the 50 MB L2; K7 per result on
gpt2_small's [238, 524,288] accumulator. Prints one JSON line per reading,
a summary with the bounds, and the card's name and power limit. Needs one
CUDA device (~2 min on an H100).
"""

from __future__ import annotations

import array
import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from distributedvolunteercomputing_tpu_torch.ops import _build  # noqa: E402
from distributedvolunteercomputing_tpu_torch.ops import mesh_collective as mcol  # noqa: E402
from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device  # noqa: E402

RING = _build._PKG / "csrc" / "ring_collective.cu"
# name -> (kernel, replacements of the shipped source)
PATCHED = {
    "batch1": ("K6", [("constexpr int kFoldBatch = 4;", "constexpr int kFoldBatch = 1;")]),
    "batch8": ("K6", [("constexpr int kFoldBatch = 4;", "constexpr int kFoldBatch = 8;")]),
    "unroll2": ("K7", [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")]),
    "unroll8": ("K7", [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")]),
}
_SIGS = {
    "dvc_ring_fold_card": _build._SIGNATURES["dvc_ring_fold_card"],
    "dvc_ring_allgather_card": _build._SIGNATURES["dvc_ring_allgather_card"],
}


def patched_source(name: str) -> str:
    """The shipped source with ``name``'s replacements; raises if one no
    longer finds its text."""
    text = RING.read_text()
    for old, new in PATCHED[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {RING.name} once")
        text = text.replace(old, new)
    return text


def build_patched() -> dict:
    out_dir = ROOT / "build" / "ring_variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(name):
        src = out_dir / f"{name}.cu"
        src.write_text(patched_source(name))
        lib = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}{proc.stdout}")
        so = ctypes.CDLL(str(lib))
        for fn, argtypes in _SIGS.items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        return name, so

    with ThreadPoolExecutor(len(PATCHED)) as pool:
        return dict(pool.map(one, PATCHED))


def flush_sets(nd: int, gen, rng) -> tuple:
    """``chip_smoke.codec_flushes``' flagship flushes, each split over nd
    ranks on cuda:0 as the ring folder splits a batch, and the ranks'
    accumulator shards."""
    flag = cs.codec_flushes("flagship", gen, rng)
    shard = flag["tile"] // nd
    sets = []
    for s in flag["sets"]:
        k = len(s["tiles"])
        per = -(-k // nd)
        own = [slice(min(d * per, k), min((d + 1) * per, k)) for d in range(nd)]
        sets.append({"bits": [s["bits"][sl].contiguous() for sl in own],
                     "tiles": [s["tiles"][sl] for sl in own], "weights": [s["weights"][sl] for sl in own],
                     "bytes": s["bytes"], "flops": s["flops"]})
    accs = [flag["acc"][:, d * shard : (d + 1) * shard].contiguous() for d in range(nd)]
    del flag
    return sets, accs, shard


def k6_calls(nd, sets, accs, shard, libs, lib):
    """name -> fn(i): fold flush set i % len(sets) into ``accs``."""
    n_tiles = accs[0].shape[0]
    dev = accs[0].device
    partials = torch.empty((nd, 2, 32, shard), dtype=torch.float32, device=dev)

    def card(i):
        s = sets[i % len(sets)]
        mcol.ring_fold(accs, s["bits"], s["tiles"], s["weights"], mcol.RingPartials())

    def patched(so):
        def call(i):
            s = sets[i % len(sets)]
            ptrs = [(x.data_ptr() if x.numel() else 0, a.data_ptr()) for x, a in zip(s["bits"], accs)]
            for rec, meta, n_slots in mcol.card_fold_pack(ptrs, s["tiles"], s["weights"], n_tiles):
                err = so.dvc_ring_fold_card(rec.buffer_info()[0], nd, meta.buffer_info()[0], len(meta), n_slots,
                                            shard, nd * shard, n_tiles, dev.index,
                                            torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
        return call

    def stepwise(i):
        s = sets[i % len(sets)]
        slot = [(partials[d].data_ptr(), partials[d, 1].data_ptr()) for d in range(nd)]
        for group in mcol.fold_plan(s["tiles"], s["weights"], n_tiles):
            meta, offs = group.meta(range(nd))
            rec = array.array("q")
            for d, off in enumerate(offs):
                x = s["bits"][d]
                rec.extend((x.data_ptr() if x.numel() else 0, accs[d].data_ptr(), *slot[d], *slot[(d - 1) % nd], d,
                            off, len(group.chunks[d])))
            for step in range(nd):
                err = lib.dvc_ring_fold(rec.buffer_info()[0], nd, nd, step, meta.buffer_info()[0], len(meta),
                                        len(group.rows), shard, nd * shard, dev.index,
                                        torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

    calls = {"card": card, "stepwise": stepwise}
    calls.update({n: patched(so) for n, so in libs.items() if PATCHED[n][0] == "K6"})
    return calls


def k7_calls(nd, accs, libs, lib, tma):
    """name -> fn(): every rank's full copy, returned."""
    n_tiles, shard = accs[0].shape
    dev = accs[0].device
    width = nd * shard

    def outs():
        return [torch.empty((n_tiles, width), dtype=torch.float32, device=dev) for _ in range(nd)]

    def packed(fn):
        def call():
            o = outs()
            ptrs = mcol.card_gather_pack([a.data_ptr() for a in accs], [x.data_ptr() for x in o])
            err = fn(ptrs.buffer_info()[0], nd, n_tiles, shard, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return o
        return call

    def stepwise():
        o = outs()
        st = torch.cuda.current_stream().cuda_stream
        for s in range(nd - 1):
            for d in range(nd):
                left, blk = (d - 1) % nd, (d - s - 1) % nd
                if s == 0:
                    src, src_ld = accs[left].data_ptr(), shard
                    own = (accs[d].data_ptr(), o[d].data_ptr() + d * shard * 4, shard)
                else:
                    src, src_ld = o[left].data_ptr() + blk * shard * 4, width
                    own = (None, None, 0)
                err = lib.dvc_ring_allgather(src, o[d].data_ptr() + blk * shard * 4, src_ld, *own, n_tiles, shard,
                                             width, st)
                assert err == 0, err
        return o

    calls = {"card": lambda: mcol.ring_allgather(accs), "stepwise": stepwise,
             "tma": packed(lambda *a: tma.dvc_ring_allgather_tma(*a))}
    for n, so in libs.items():
        if PATCHED[n][0] == "K7":
            calls[n] = packed(lambda *a, so=so: so.dvc_ring_allgather_card(*a[:4], dev.index, a[4]))
    return calls


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ring_variants: needs a CUDA device", file=sys.stderr)
        return 2
    resolve_device(None)
    lib = _build.load_library()
    libs = build_patched()
    tma = cs.ring_tma_library()
    smi = cs.nvidia_smi()
    cs.emit({"phase": "env", "torch": torch.__version__, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    mem_rate, _, f32_rate = cs.peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(77)
    import numpy as np

    rng = np.random.default_rng(77)
    summary = {}
    for nd in cs.RING_NDS:
        sets, accs, shard = flush_sets(nd, gen, rng)
        fold = k6_calls(nd, sets, accs, shard, libs, lib)
        for name, fn in fold.items():  # bit-equal to the plain version on every flush
            for i, s in enumerate(sets):
                saved, want = [a.clone() for a in accs], [a.clone() for a in accs]
                fn(i)
                mcol.ring_fold_plain(want, s["bits"], s["tiles"], s["weights"])
                torch.cuda.synchronize()
                eq = [cs.bits_equal(a, b) for a, b in zip(accs, want)]
                for a, b in zip(accs, saved):
                    a.copy_(b)
                del saved, want
                if any(e["finite_lanes_differing"] or not e["nonfinite_match"] for e in eq):
                    raise AssertionError(f"K6 {name} nd={nd} flush {i} differs from its plain version: {eq}")
        gather = k7_calls(nd, accs, libs, lib, tma)
        want = mcol.ring_allgather_plain(accs)
        for name, fn in gather.items():
            got = fn()
            torch.cuda.synchronize()
            eq = [cs.bits_equal(a, b) for a, b in zip(got, want)]
            if any(e["finite_lanes_differing"] for e in eq):
                raise AssertionError(f"K7 {name} nd={nd} differs from its plain version: {eq}")
            del got
        del want
        turns = {f"K6/{n}": [] for n in fold} | {f"K7/{n}": [] for n in gather}
        walls = {k: [] for k in turns}
        counter = [0]

        def k6(fn):
            def call():
                counter[0] += 1
                fn(counter[0])
            return call

        calls = {f"K6/{n}": k6(fn) for n, fn in fold.items()} | {f"K7/{n}": fn for n, fn in gather.items()}
        for order in (list(calls), list(calls)[::-1]):
            for key in order:
                reps = 8 * len(sets) if key.startswith("K6") else 10
                turns[key].append(cs.device_ms(calls[key], reps=reps)["ms"])
                walls[key].append(cs.time_ms(calls[key], iters=reps))
                cs.emit({"phase": "ring_variant", "nd": nd, "design": key, "device_ms": turns[key][-1],
                         "wall_ms": walls[key][-1]})
        s0 = sets[0]
        fold_bytes = s0["bytes"]
        gather_bytes = (1 + nd) * accs[0].numel() * nd * 4
        summary[nd] = {
            "device_ms": {k: statistics.median(v) for k, v in turns.items()},
            "wall_ms": {k: statistics.median(v) for k, v in walls.items()},
            "K6_bound_ms": max(fold_bytes / mem_rate, s0["flops"] / f32_rate) * 1e3,
            "K7_bound_ms": gather_bytes / mem_rate * 1e3,
        }
        del sets, accs, fold, gather, calls
        torch.cuda.empty_cache()
    cs.emit({"phase": "ring_variants_summary", "summary": summary})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
