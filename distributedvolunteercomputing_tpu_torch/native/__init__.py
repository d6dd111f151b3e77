"""ctypes binding for the C++ host core (dvc_native.cpp), with lazy build.

The library is compiled ON FIRST USE with the system g++ (no pybind11 in the
environment — plain C ABI + ctypes, per SURVEY.md §2's native-code
checklist) and cached next to the source; a stale .so (older than the .cpp)
is rebuilt. Every caller goes through ``get_lib()`` and falls back to numpy
when the toolchain is missing or ``DVC_NATIVE=0`` — the native core is a
throughput upgrade for the WAN path, never a hard dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from distributedvolunteercomputing_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "dvc_native.cpp")
_SO = os.path.join(_DIR, "libdvc_native.so")
_ABI = 3

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_done = False  # build+load attempt finished (success or permanent failure)
_builder: Optional[threading.Thread] = None


def _build() -> bool:
    """Compile to a temp file, then atomically rename into place: concurrent
    volunteer processes racing the build can never dlopen a half-written
    ELF, and a killed compile never leaves a corrupt .so behind."""
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        _SRC, "-o", tmp,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            log.warning("native build failed; using numpy fallbacks:\n%s", proc.stderr[-2000:])
            return False
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        log.info("native build unavailable (%s); using numpy fallbacks", e)
        return False
    finally:
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass


def _load() -> Optional[ctypes.CDLL]:
    lib = ctypes.CDLL(_SO)
    lib.dvc_abi_version.restype = ctypes.c_int
    if lib.dvc_abi_version() != _ABI:
        log.warning("native ABI mismatch; rebuilding")
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u64 = ctypes.c_uint64
    lib.dvc_crc32.argtypes = [u8p, u64, ctypes.c_uint32]
    lib.dvc_crc32.restype = ctypes.c_uint32
    lib.dvc_f32_to_bf16.argtypes = [f32p, u16p, u64]
    lib.dvc_bf16_to_f32.argtypes = [u16p, f32p, u64]
    lib.dvc_weighted_sum.argtypes = [f32p, f32p, ctypes.c_float, u64]
    lib.dvc_coord_median.argtypes = [f32p, u64, u64, f32p]
    lib.dvc_trimmed_mean.argtypes = [f32p, u64, u64, u64, f32p]
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.dvc_f32_to_q8.argtypes = [f32p, u64, u64, f32p, i8p]
    lib.dvc_q8_to_f32.argtypes = [i8p, f32p, u64, u64, f32p]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.dvc_topk_indices.argtypes = [f32p, u64, u64, u32p]
    return lib


def _build_and_load() -> None:
    """The one-shot build+load state machine (runs in the builder thread).

    Load failures (truncated .so from a crashed writer, ABI drift) get ONE
    rebuild before giving up — a stale-but-newer corrupt artifact must not
    disable the native path forever."""
    global _lib, _done
    try:
        stale = (not os.path.exists(_SO)) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        )
        lib = None
        if not stale:
            try:
                lib = _load()
            except OSError:
                lib = None
        if lib is None and _build():
            try:
                lib = _load()
            except OSError as e:
                log.warning("native load failed after fresh build (%s)", e)
        _lib = lib
    except OSError as e:
        log.info("native core unavailable (%s); using numpy fallbacks", e)
        _lib = None
    finally:
        _done = True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library; never blocks the caller on a compile.

    On first call with no usable .so, the build is kicked off on a
    background thread and None is returned (callers fall back to numpy)
    until it lands — a volunteer's asyncio loop must not stall for a g++
    run mid-round. Use ensure_built() at process start to wait for it.
    """
    global _builder
    if _done or os.environ.get("DVC_NATIVE", "1") == "0":
        return _lib
    with _lock:
        if _done:
            return _lib
        if _builder is None:
            _builder = threading.Thread(
                target=_build_and_load, name="dvc-native-build", daemon=True
            )
            _builder.start()
    return _lib


def ensure_built(timeout: float = 150.0) -> bool:
    """Block until the native core is built+loaded (or failed); returns
    availability. Call from process entrypoints BEFORE the event loop."""
    get_lib()
    b = _builder
    if b is not None:
        b.join(timeout)
    return _lib is not None


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# public ops (native with numpy fallback)
# ---------------------------------------------------------------------------


def crc32(data: bytes, seed: int = 0) -> int:
    """Frame checksum. zlib's crc32 measured ~2x faster than the C++
    slice-by-8 path on this host (hardware CRC in zlib), so it is the
    primary; dvc_crc32 stays in the ABI as a cross-check implementation
    (tests validate the two agree — a real integrity test of the codec)."""
    import zlib

    return zlib.crc32(data, seed) & 0xFFFFFFFF


def crc32_native(data: bytes, seed: int = 0) -> int:
    lib = get_lib()
    if lib is None:
        return crc32(data, seed)
    buf = np.frombuffer(data, np.uint8)
    return int(lib.dvc_crc32(_ptr(buf, ctypes.c_uint8), len(data), seed))


def f32_to_bf16(arr: np.ndarray) -> np.ndarray:
    """float32 [n] -> uint16 [n] bf16 bit patterns (round-to-nearest-even)."""
    arr = np.ascontiguousarray(arr, np.float32)
    lib = get_lib()
    out = np.empty(arr.size, np.uint16)
    if lib is not None:
        lib.dvc_f32_to_bf16(_ptr(arr, ctypes.c_float), _ptr(out, ctypes.c_uint16), arr.size)
        return out
    import ml_dtypes

    return arr.astype(ml_dtypes.bfloat16).view(np.uint16)


def bf16_to_f32(bits: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32. ``out``, when given, receives
    the decode in place (must be a contiguous f32 buffer of matching size)
    — the streaming aggregation tier decodes wire chunks straight into
    pooled tile buffers instead of allocating per chunk."""
    bits = np.ascontiguousarray(bits, np.uint16)
    if out is None:
        out = np.empty(bits.size, np.float32)
    elif (
        out.dtype != np.float32 or out.size != bits.size
        or not out.flags.c_contiguous
    ):
        raise ValueError(
            f"bf16_to_f32 out= needs a contiguous float32[{bits.size}], got "
            f"{out.dtype}[{out.size}]"
        )
    lib = get_lib()
    if lib is not None:
        lib.dvc_bf16_to_f32(_ptr(bits, ctypes.c_uint16), _ptr(out, ctypes.c_float), bits.size)
        return out
    import ml_dtypes

    out[:] = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    return out


def weighted_sum_inplace(acc: np.ndarray, x: np.ndarray, w: float) -> None:
    """acc += w * x over float32 buffers — the sync leader's streaming
    weighted-mean accumulation (swarm/averager.py _lead_round)."""
    # ValueError, not assert: this guards the native kernel's dtype/size
    # contract (out-of-bounds read if violated) and must survive `python -O`.
    if acc.dtype != np.float32 or x.dtype != np.float32 or acc.size != x.size:
        raise ValueError(
            f"weighted_sum_inplace needs matching float32 buffers, got "
            f"{acc.dtype}[{acc.size}] += w * {x.dtype}[{x.size}]"
        )
    lib = get_lib()
    if lib is not None and acc.flags.c_contiguous and x.flags.c_contiguous:
        lib.dvc_weighted_sum(_ptr(acc, ctypes.c_float), _ptr(x, ctypes.c_float), w, acc.size)
        return
    acc += np.float32(w) * x


Q8_CHUNK = 1024  # floats per quantization chunk (one f32 scale each)


def q8_encode(arr: np.ndarray, chunk: int = Q8_CHUNK) -> bytes:
    """f32 -> q8 wire bytes: [u64 n][f32 scale/chunk][int8 data]. ~4x fewer
    bytes than f32; symmetric per-chunk scales; exact on round-tripped
    values (pairwise protocols rely on idempotency)."""
    arr = np.ascontiguousarray(arr, np.float32).ravel()
    n = arr.size
    n_chunks = -(-n // chunk) if n else 0
    scales = np.empty(n_chunks, np.float32)
    out = np.empty(n, np.int8)
    lib = get_lib()
    if lib is not None and n:
        lib.dvc_f32_to_q8(
            _ptr(arr, ctypes.c_float), n, chunk, _ptr(scales, ctypes.c_float),
            _ptr(out, ctypes.c_int8),
        )
    elif n:
        # Mirrors the native path: non-finite -> 0 before scaling (UB-free,
        # scale stays finite), quantize via x * (1/scale) in f32 with
        # round-half-away-from-zero. Exact agreement with the C++ isn't
        # guaranteed at rounding boundaries (FMA contraction differs by
        # compiler), but both stay within one quantization step.
        arr = np.where(np.isfinite(arr), arr, np.float32(0))
        pad = n_chunks * chunk - n
        padded = np.pad(arr, (0, pad)).reshape(n_chunks, chunk)
        amax = np.max(np.abs(padded), axis=1)
        scales[:] = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = padded * (np.float32(1.0) / scales)[:, None]
        q = np.clip(q, -127.0, 127.0)
        q = np.where(q >= 0, np.floor(q + 0.5), np.ceil(q - 0.5)).astype(np.int8)
        out[:] = q.reshape(-1)[:n]
    return (
        np.uint64(n).tobytes() + scales.tobytes() + out.tobytes()
    )


def q8_coded_size(n: int, chunk: int = Q8_CHUNK) -> int:
    """Exact q8 wire size for n f32 elements — the ONE home of the layout
    (header u64 + f32 scale per chunk + int8 data); peers validate transfer
    sizes against this instead of re-deriving the format."""
    n_chunks = -(-n // chunk) if n else 0
    return 8 + 4 * n_chunks + n


def q8_decode(payload: bytes, chunk: int = Q8_CHUNK) -> np.ndarray:
    """Inverse of q8_encode; raises ValueError on malformed payloads."""
    if len(payload) < 8:
        raise ValueError("q8 payload too short for header")
    n = int(np.frombuffer(payload[:8], np.uint64)[0])
    n_chunks = -(-n // chunk) if n else 0
    expect = q8_coded_size(n, chunk)
    if len(payload) != expect:
        raise ValueError(f"q8 payload {len(payload)}B != expected {expect}B for n={n}")
    scales = np.frombuffer(payload[8 : 8 + 4 * n_chunks], np.float32)
    data = np.frombuffer(payload[8 + 4 * n_chunks :], np.int8)
    out = np.empty(n, np.float32)
    lib = get_lib()
    if lib is not None and n:
        data = np.ascontiguousarray(data)
        scales = np.ascontiguousarray(scales)
        lib.dvc_q8_to_f32(
            _ptr(data, ctypes.c_int8), _ptr(scales, ctypes.c_float), n, chunk,
            _ptr(out, ctypes.c_float),
        )
    elif n:
        pad = n_chunks * chunk - n
        padded = np.pad(data.astype(np.float32), (0, pad)).reshape(n_chunks, chunk)
        out[:] = (padded * scales[:, None]).reshape(-1)[:n]
    return out


# Decode-allocation ceiling when the caller has no schema to bound by:
# 2^29 f32 = the 2 GiB transport MAX_PAYLOAD expressed in floats. A sparse
# frame's uint64 n is attacker-controlled (a ~100-byte frame can claim any
# n), so the dense reconstruction must never exceed what a dense payload of
# the transport's own cap could have shipped.
TOPK_MAX_DECODE_FLOATS = 1 << 29


# 1-bit sign wire codec (EF-signSGD, Karimireddy et al.'s error-fixed
# signSGD lineage): ship sign(x) packed 1 bit/coord plus a per-chunk f32
# scale = mean(|x|) over the chunk, so the reconstruction ±scale carries the
# chunk's average magnitude (plain ±1 signs would need a global lr rescale;
# mean-|x| scaling is what makes EF residuals drain). ~32x fewer bytes than
# f32 — the extreme rung of the codec family (f32 -> bf16 2x -> q8 4x ->
# powersgd ~7x -> topk ~14-50x -> sign 32x on the contribution leg).
# Self-describing magic so the averager can tell a sign contribution from
# its q8-coded round RESULT on the same wire (see averager._buf_from_payload).
SIGN_MAGIC = b"SG1"
_SIGN_HDR = 3 + 8  # magic, n u64


def sign_coded_size(n: int, chunk: int = Q8_CHUNK) -> int:
    n_chunks = -(-n // chunk) if n else 0
    return _SIGN_HDR + 4 * n_chunks + (n + 7) // 8


def sign_encode(arr: np.ndarray, chunk: int = Q8_CHUNK) -> bytes:
    """f32 -> sign wire bytes: [SG1][u64 n][f32 mean-|x| per chunk][packed
    sign bits, 1 = negative]. Non-finite values encode as +scale with the
    non-finites excluded from the chunk mean (matching q8's zero-poison
    policy: one NaN must not wipe a 1024-float chunk's information)."""
    arr = np.ascontiguousarray(arr, np.float32).ravel()
    n = arr.size
    n_chunks = -(-n // chunk) if n else 0
    finite = np.isfinite(arr)
    clean = np.where(finite, arr, np.float32(0))
    pad = n_chunks * chunk - n
    padded = np.pad(clean, (0, pad)).reshape(n_chunks, chunk) if n else clean.reshape(0, 1)
    counts = np.pad(finite.astype(np.float64), (0, pad)).reshape(n_chunks, chunk).sum(axis=1) if n else np.zeros(0)
    sums = np.abs(padded).sum(axis=1, dtype=np.float64)  # f64: ulp-stable chunk means
    scales = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0).astype(np.float32)
    bits = np.packbits((clean < 0).astype(np.uint8))
    return SIGN_MAGIC + np.uint64(n).tobytes() + scales.tobytes() + bits.tobytes()


def sign_decode(
    payload: bytes, chunk: int = Q8_CHUNK,
    max_floats: int = TOPK_MAX_DECODE_FLOATS,
) -> np.ndarray:
    """Inverse of sign_encode: dense f32 of ±chunk-scale. ``max_floats``
    bounds the allocation (the u64 n is sender-controlled — same
    resource-exhaustion guard as topk/powersgd decodes)."""
    if len(payload) < _SIGN_HDR or payload[:3] != SIGN_MAGIC:
        raise ValueError("sign payload: bad header")
    n = int(np.frombuffer(payload[3:11], np.uint64)[0])
    if n > max_floats:
        raise ValueError(f"sign payload: n={n} exceeds decode cap {max_floats}")
    if len(payload) != sign_coded_size(n, chunk):
        raise ValueError(
            f"sign payload {len(payload)}B != expected {sign_coded_size(n, chunk)}B for n={n}"
        )
    n_chunks = -(-n // chunk) if n else 0
    scales = np.frombuffer(payload[_SIGN_HDR : _SIGN_HDR + 4 * n_chunks], np.float32)
    bits = np.unpackbits(
        np.frombuffer(payload[_SIGN_HDR + 4 * n_chunks :], np.uint8), count=n
    )
    signs = np.where(bits == 1, np.float32(-1.0), np.float32(1.0))
    pad = n_chunks * chunk - n
    out = (
        np.pad(signs, (0, pad)).reshape(n_chunks, chunk) * scales[:, None]
    ).reshape(-1)[:n].astype(np.float32)
    return np.ascontiguousarray(out)


# Top-k sparse wire codec (Deep-Gradient-Compression style): ship only the
# largest-magnitude entries. Self-describing header so the decoder needs no
# out-of-band state; falls back to dense when sparsity wouldn't pay.
_TOPK_MAGIC = b"TK1"
_TOPK_HDR = 3 + 1 + 8  # magic, mode u8, n u64
_TOPK_SPARSE, _TOPK_DENSE = 0, 1


def topk_encode(arr: np.ndarray, frac: float | None = None) -> bytes:
    """f32 -> top-k wire bytes.

    ``frac`` = fraction of entries to keep (by |value|). ``None`` = auto:
    keep every nonzero, or go dense when sparse coding (8 B/entry) would
    exceed dense f32 — the right mode for aggregation RESULTS, whose support
    is the union of sparse contributions. Non-finite values are zeroed (they
    would otherwise win the magnitude sort and poison the average)."""
    arr = np.ascontiguousarray(arr, np.float32).ravel()
    arr = np.where(np.isfinite(arr), arr, np.float32(0))
    n = arr.size
    if n >= 1 << 32:
        raise ValueError(f"topk codec supports < 2^32 elements, got {n}")
    header = _TOPK_MAGIC + bytes([_TOPK_SPARSE]) + np.uint64(n).tobytes()

    def dense() -> bytes:  # built on demand: it copies the whole buffer
        return _TOPK_MAGIC + bytes([_TOPK_DENSE]) + np.uint64(n).tobytes() + arr.tobytes()

    if frac is None:
        idx = np.flatnonzero(arr).astype(np.uint32)
        if 8 * idx.size >= 4 * n:  # sparse (8 B/entry) wouldn't pay
            return dense()
    else:
        k = max(1, int(n * frac)) if n else 0
        if 8 * k >= 4 * n or k >= n:
            # Dense mode is knowable from k alone — decide BEFORE paying
            # for any selection work.
            return dense()
        # numpy's SIMD introselect beats the C++ nth_element ~2x on this
        # hardware (measured at 31M f32: 0.30s vs 0.64s), so numpy is the
        # default; the native path (parity-tested) is an opt-in for
        # platforms where numpy's partition underperforms. Env checked
        # first: get_lib() would otherwise kick off the background g++
        # build for a value the condition then ignores.
        if (
            os.environ.get("DVC_TOPK_NATIVE") == "1"
            and n >= (1 << 15)
            and (lib := get_lib()) is not None
        ):
            idx = np.empty(k, np.uint32)
            lib.dvc_topk_indices(_ptr(arr, ctypes.c_float), n, k, _ptr(idx, ctypes.c_uint32))
        else:
            idx = np.sort(
                np.argpartition(np.abs(arr), n - k)[n - k:]
            ).astype(np.uint32)
    return header + idx.tobytes() + arr[idx].tobytes()




def topk_decode(
    payload: bytes, max_floats: int = TOPK_MAX_DECODE_FLOATS
) -> np.ndarray:
    """Inverse of topk_encode: dense f32 with zeros off-support."""
    if len(payload) < _TOPK_HDR or payload[:3] != _TOPK_MAGIC:
        raise ValueError("topk payload: bad header")
    mode = payload[3]
    n = int(np.frombuffer(payload[4:12], np.uint64)[0])
    if n > max_floats:
        raise ValueError(f"topk payload: n={n} exceeds decode cap {max_floats}")
    body = payload[_TOPK_HDR:]
    if mode == _TOPK_DENSE:
        if len(body) != 4 * n:
            raise ValueError(f"topk dense body {len(body)}B != {4 * n}B for n={n}")
        return np.frombuffer(body, np.float32).copy()
    if mode != _TOPK_SPARSE or len(body) % 8 != 0:
        raise ValueError("topk payload: bad mode or body size")
    k = len(body) // 8
    idx = np.frombuffer(body[: 4 * k], np.uint32)
    vals = np.frombuffer(body[4 * k:], np.float32)
    if k and (idx[-1] >= n or np.any(np.diff(idx.astype(np.int64)) <= 0)):
        raise ValueError("topk payload: indices out of range or unsorted")
    out = np.zeros(n, np.float32)
    out[idx] = vals
    return out


def coordinate_median(stack: np.ndarray) -> np.ndarray:
    """np.median(stack, axis=0) for float32 [n_peers, D], threaded."""
    lib = get_lib()
    if lib is None or stack.dtype != np.float32 or not stack.flags.c_contiguous:
        return np.median(stack, axis=0).astype(stack.dtype)
    out = np.empty(stack.shape[1], np.float32)
    lib.dvc_coord_median(
        _ptr(stack, ctypes.c_float), stack.shape[0], stack.shape[1], _ptr(out, ctypes.c_float)
    )
    return out


def trimmed_mean(stack: np.ndarray, trim: int) -> np.ndarray:
    """Coordinate-wise trimmed mean for float32 [n_peers, D], threaded."""
    n = stack.shape[0]
    if 2 * trim >= n:
        raise ValueError(f"trim={trim} too large for n={n}")
    lib = get_lib()
    if lib is None or stack.dtype != np.float32 or not stack.flags.c_contiguous:
        srt = np.sort(stack, axis=0)
        return srt[trim : n - trim].mean(axis=0)
    out = np.empty(stack.shape[1], np.float32)
    lib.dvc_trimmed_mean(
        _ptr(stack, ctypes.c_float), n, stack.shape[1], trim, _ptr(out, ctypes.c_float)
    )
    return out
