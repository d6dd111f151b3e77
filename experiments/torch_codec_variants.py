#!/usr/bin/env python3
"""Designs of the bf16 codec kernels (K4 encode, K5 fold), checked and timed in turns on one GPU.

    python3 experiments/torch_codec_variants.py

Each design is built alone with nvcc (``ops/_build.py``'s flags) into its own
library under ``build/codec_variants/`` (the repo's sources are not touched)
and called through ctypes:

- ``current``: ``csrc/bf16_codec.cu`` as the port builds it (candidate (a):
  unrolled 16-byte loads issued before use, streaming cache hints, a grid
  that covers the data in one pass); ``unroll8``: the same with 8 vector
  groups per thread instead of 4; ``no_hints``: with plain loads and stores;
  ``persistent``: with a persistent grid (8 blocks of 256 threads per SM)
  whose threads stride over the data. These three patch the shipped source
  by text, so they are tied to its lines as they stand: a patch that no
  longer finds its line raises here, and
  ``tests/test_torch_codec.py::test_codec_variant_patches_apply_to_the_source``
  says so on the CPU;
- ``tma``: candidate (b) of ``experiments/torch_codec_variants.cu``, TMA
  1-D bulk copies through a ring of shared-memory stages;
- ``parent``: the first design (same file), K5 launched once per chunk.

K4 runs on gpt2_small's flat buffer (124,439,808 floats, ``chip_smoke.
codec_inputs``). K5 runs per staged flush as ``MeshMeanFolder`` stages
them (``chip_smoke.codec_flushes``): ``flagship`` flushes of 16 chunks of
1 MiB (12 tiles, the short tail tile and three repeats, one zero weight) into
a [238, 524,288] accumulator, and ``small`` flushes of 256 chunks of 64 KiB
(a transport's ``chunk_bytes`` of 1 << 16) into a [3798, 32,768] one; four
flushes with disjoint tiles and bits are cycled, so no call finds its bytes
in the 50 MB L2. Every design
is first held bit-equal to its plain version (``encode_bf16_plain``,
``fold_chunks_plain``). Then, in turns (all designs, then all again in
reverse order), each is timed by device time (``chip_smoke.device_ms``) and,
per flush, by the wall of its host call (CUDA events around it, table and
launches included: ``chip_smoke.time_ms``); the library yardsticks are
``x.to(torch.bfloat16).view(torch.int16)`` and one ``index_add_`` of the
weighted decoded batch (decode not timed). Prints one JSON line per reading,
a summary with the bounds, and the card's name and power limit. Needs a CUDA
device (~9 min on an H100, most of it the first design's small flushes: 256
launches each).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from distributedvolunteercomputing_tpu_torch.ops import _build  # noqa: E402
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc  # noqa: E402
from distributedvolunteercomputing_tpu_torch.utils.torchenv import resolve_device  # noqa: E402

CODEC = _build._PKG / "csrc" / "bf16_codec.cu"
OTHERS = Path(__file__).resolve().parent / "torch_codec_variants.cu"
# name -> (source, replacements)
VARIANTS = {
    "current": (CODEC, []),
    "unroll8": (CODEC, [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")]),
    "no_hints": (CODEC, [("__ldcs(", "*("), ("__stcs(ov + g, L::encode(v[t]))", "ov[g] = L::encode(v[t])"),
                         ("__stcs(dv + g, a[t])", "dv[g] = a[t]")]),
    # A persistent grid: 8 blocks of 256 threads on each of the H100's 132
    # SMs (shared among a launch's tiles), each thread striding over the data.
    "persistent": (CODEC, [
        ("  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;\n",
         "  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;\n"
         "  for (int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + threadIdx.x; g0 < groups;"
         " g0 += step) {\n"),
        ("  if (kVec > 1 && blockIdx.x == 0) {", "  }\n  if (kVec > 1 && blockIdx.x == 0) {"),
        ("return static_cast<unsigned>(want < 1 ? 1 : want);",
         "return static_cast<unsigned>(want < 1 ? 1 : (want < 1056 ? want : 1056));"),
        ("  const dim3 grid(blocks_for(vec ? widest / 4 : widest), p.n_tiles);",
         "  const unsigned want = blocks_for(vec ? widest / 4 : widest), cap = (1056 + p.n_tiles - 1) / p.n_tiles;\n"
         "  const dim3 grid(want < cap ? want : cap, p.n_tiles);"),
    ]),
    "tma": (OTHERS, []),
    "parent": (OTHERS, []),
}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
FOLD_ARGS = [_P, _P, _L, _L, _L, _P, _I, _I, _I, _P]
SIGNATURES = {
    "dvc_bf16_encode": [_P, _P, _L, _P], "dvc_bf16_fold_chunks": FOLD_ARGS,
    "dvc_tma_encode": [_P, _P, _L, _P], "dvc_tma_fold_chunks": FOLD_ARGS,
    "dvc_parent_encode": [_P, _P, _L, _P], "dvc_parent_decode_axpy": [_P, _P, _P, _F, _L, _P],
}


def build(name: str) -> dict:
    """The variant's library: its source with the replacements, built alone."""
    src, reps = VARIANTS[name]
    out = ROOT / "build" / "codec_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    for old, new in reps:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {src.name}")
        text = text.replace(old, new)
    cu, lib = out / src.name, out / "lib.so"
    cu.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stderr}{proc.stdout}")
    return {"name": name, "lib": str(lib), "log": proc.stderr + proc.stdout}


def load(info: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(info["lib"])
    for fn, argtypes in SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def encoder(name: str, lib):
    fn = getattr(lib, {"tma": "dvc_tma_encode", "parent": "dvc_parent_encode"}.get(name, "dvc_bf16_encode"))

    def run(x: torch.Tensor) -> torch.Tensor:
        out = torch.empty(x.shape, dtype=torch.int16, device=x.device)
        check(fn(x.data_ptr(), out.data_ptr(), x.numel(), stream()), f"{name} encode")
        return out

    return run


def folder(name: str, lib):
    """The variant's flush: (acc, flush) -> None, in place, the table built
    on the host as the port's wrapper builds it."""
    if name == "parent":
        def run(acc, f):
            # The parent folder: one launch per chunk on acc[tile, :len].
            for i, (t, w, n) in enumerate(zip(f["tiles"], f["weights"], f["lens"])):
                if n > 0:
                    dst = acc[t, :n]
                    check(lib.dvc_parent_decode_axpy(f["bits"][i, :n].data_ptr(), dst.data_ptr(), dst.data_ptr(),
                                                     float(w), n, stream()), "parent fold")
        return run
    fn = lib.dvc_tma_fold_chunks if name == "tma" else lib.dvc_bf16_fold_chunks

    def run(acc, f):
        for words, n_tiles, n_chunks in mc.fold_plan(f["tiles"], f["weights"], f["lens"]):
            check(fn(f["bits"].data_ptr(), acc.data_ptr(), f["bits"].stride(0), acc.stride(0), 0,
                     words.buffer_info()[0], len(words), n_tiles, n_chunks, stream()), f"{name} fold")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_codec_variants: needs a CUDA device", file=sys.stderr)
        return 2
    resolve_device(None)
    mem_rate, _, f32_rate = cs.peaks(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        infos = list(pool.map(build, VARIANTS))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    libs = {info["name"]: load(info) for info in infos}
    for info in infos:
        report = cs.kernel_build_report(info["log"], info["lib"])
        print(json.dumps({"variant": info["name"], "build": {
            n: r for n, r in report.items() if "registers" in r}}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(77)
    rng = np.random.default_rng(77)
    x, _ = cs.codec_inputs(cs.FLAT_N, gen)
    want_bits = mc.encode_bf16_plain(x)
    cases = [cs.codec_flushes("flagship", gen, rng), cs.codec_flushes("small", gen, rng)]
    encoders = {name: encoder(name, lib) for name, lib in libs.items()}
    folders = {name: folder(name, lib) for name, lib in libs.items()}

    # Every design bit-equal to its plain version before it is timed.
    for name in VARIANTS:
        got = encoders[name](x)
        torch.cuda.synchronize()
        if not torch.equal(got, want_bits):
            raise AssertionError(f"{name}: K4 differs from encode_bf16_plain")
        for case in cases:
            f = case["sets"][0]
            acc_k, acc_p = case["acc"].clone(), case["acc"].clone()
            folders[name](acc_k, f)
            mc.fold_chunks_plain(acc_p, f["bits"], f["tiles"], f["weights"], f["lens"], 0)
            torch.cuda.synchronize()
            eq = cs.bits_equal(acc_k, acc_p)
            if eq["finite_lanes_differing"] or not eq["nonfinite_match"]:
                raise AssertionError(f"{name}: K5 differs from fold_chunks_plain on a {case['kind']} flush: {eq}")
            del acc_k, acc_p
        print(json.dumps({"variant": name, "bit_equal": True}), flush=True)

    print(json.dumps({"checked_s": time.perf_counter() - t0}), flush=True)
    summary = {}

    def record(key: str, name: str, value: float) -> None:
        summary.setdefault(key, {}).setdefault(name, []).append(value)
        print(json.dumps({"reading": key, "variant": name, "ms": value}), flush=True)

    lib_calls = {
        "K4": lambda: x.to(torch.bfloat16).view(torch.int16),
    }
    for name in list(VARIANTS) + ["library"] + ["library"] + list(VARIANTS)[::-1]:
        if name == "library":
            record("K4 device_ms", name, cs.device_ms(lib_calls["K4"], 10)["ms"])
        else:
            enc = encoders[name]
            record("K4 device_ms", name, cs.device_ms(lambda: enc(x), 10)["ms"])
        for case in cases:
            acc, sets = case["acc"], case["sets"]
            it = iter(range(1 << 30))
            if name == "library":
                fn = lambda: (lambda f: acc.index_add_(0, f["tiles_t"], f["dec"]))(sets[next(it) % cs.FLUSH_SETS])
            else:
                fold = folders[name]
                fn = lambda: fold(acc, sets[next(it) % cs.FLUSH_SETS])
            reps = 4 * cs.FLUSH_SETS if name != "parent" or case["kind"] == "flagship" else cs.FLUSH_SETS
            record(f"K5 {case['kind']} device_ms per flush", name, cs.device_ms(fn, reps)["ms"])
            record(f"K5 {case['kind']} wall_ms per flush", name, cs.time_ms(fn, iters=4 * cs.FLUSH_SETS))
    bounds = {"K4": 6 * cs.FLAT_N / mem_rate * 1e3}
    for case in cases:
        f = case["sets"][0]
        bounds[f"K5 {case['kind']} per flush"] = max(f["bytes"] / mem_rate, f["flops"] / f32_rate) * 1e3
        bounds[f"K5 {case['kind']} chunks"] = len(f["tiles"])
    print(json.dumps({"timed_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"summary_ms": summary, "bound_ms": bounds, "method": cs.DEVICE_MS_METHOD,
                      "wall_method": "CUDA events around the host call (time_ms): host work included when the "
                                     "host is the slower side"}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
