"""Build the port's CUDA kernels with nvcc at first use and bind them with ctypes.

The sources under ``csrc/`` are compiled in parallel (one nvcc each) and
linked into one shared library with a plain C interface, in
``build/torch_kernels/<hash of the sources>/`` beside the package, so a
changed source never loads a stale library; the compiler's report (ptxas
registers and spills per kernel) is kept beside it as ``.log``. A file lock
in that directory lets one process build while the others wait for its
library (a volunteer started beside another on one machine). nvcc is found on
``PATH`` or under ``$CUDA_HOME`` (default ``/usr/local/cuda``). A missing
nvcc or a failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(
    _PKG / "csrc" / name for name in ("flash_attention.cu", "bf16_codec.cu", "ring_collective.cu")
)
# No --use_fast_math / -ftz: the codec kernels must round subnormals exactly.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, kept in the build log
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, Any] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# Flash attention: (dtype, d, *pointers, *(b, h, t) strides per tensor, B, H,
# Tq, Tk, scale, causal, stream).
_SIGNATURES = {
    "dvc_flash_fwd": [_I, _I] + [_P] * 5 + [_L] * 12 + [_I] * 4 + [_F, _I, _P],
    "dvc_flash_dq": [_I, _I] + [_P] * 7 + [_L] * 15 + [_I] * 4 + [_F, _I, _P],
    "dvc_flash_dkv": [_I, _I] + [_P] * 8 + [_L] * 18 + [_I] * 4 + [_F, _I, _P],
    # (x, out, n, stream)
    "dvc_bf16_encode": [_P, _P, _L, _P],
    # (bits, acc, bits_ld, acc_ld, col0, words, n_words, n_tiles, n_chunks, stream)
    "dvc_bf16_fold_chunks": [_P, _P, _L, _L, _L, _P, _I, _I, _I, _P],
    # (ranks, n_ranks, nd, step0, step1, meta, meta_words, n_slots, shard, tile_elems, device, stream)
    "dvc_ring_fold": [_P, _I, _I, _I, _P, _I, _I, _L, _L, _I, _P],
    # (ranks, nd, meta, meta_words, n_slots, shard, tile_elems, n_tiles, device, stream)
    "dvc_ring_fold_card": [_P, _I, _P, _I, _I, _L, _L, _L, _I, _P],
    # (src0, dst0, src0_ld, src1, dst1, src1_ld, rows, cols, dst_ld, stream)
    "dvc_ring_allgather": [_P, _P, _L, _P, _P, _L, _L, _L, _L, _P],
    # (ptrs, nd, rows, shard, device, stream)
    "dvc_ring_allgather_card": [_P, _I, _L, _L, _I, _P],
    "dvc_enable_peer_access": [_I, _I],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME; cannot build the CUDA kernels")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _PKG.parent / "build" / "torch_kernels" / source_hash() / "libdvc_torch_kernels.so"


def _run(cmd) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
        )
    return proc


def _compile(out: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [out.parent / f"{src.stem}.{os.getpid()}.o" for src in SOURCES]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(SOURCES, objs)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cmds)) as pool:
        procs = list(pool.map(_run, cmds))
    link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    procs.append(_run(link))
    log = "".join(p.stderr + p.stdout for p in procs)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    build_info.update(
        seconds=time.perf_counter() - t0, log=log, command=" && ".join(" ".join(c) for c in cmds + [link])
    )


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path.parent / ".build.lock", "w") as lock_file:
                fcntl.flock(lock_file, fcntl.LOCK_EX)  # released when the file closes
                built_here = not path.exists()
                if built_here:
                    _compile(path)
            if not built_here:  # built earlier: its compiler report was kept beside it
                build_info.setdefault("seconds", 0.0)
                log = path.with_suffix(".log")
                build_info.setdefault("log", log.read_text() if log.exists() else "")
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dvc_error_string.argtypes = [_I]
            lib.dvc_error_string.restype = ctypes.c_char_p
            build_info["path"] = str(path)
            _lib = lib
        return _lib
