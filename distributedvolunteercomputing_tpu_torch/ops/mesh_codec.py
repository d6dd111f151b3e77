"""The swarm data path on the volunteer's card: the bf16 wire codec and the
leader's mean fold (ported from ``distributedvolunteercomputing_tpu/ops/mesh_codec.py``).

Two hand-written CUDA kernels (``csrc/bf16_codec.cu``) replace the reference's
Pallas TPU kernels; everything else here is plain PyTorch, as the reference
left it to XLA outside any Pallas kernel:

=====  ==========================  ==================================================
kernel TPU kernel it replaces       wrapper / plain version
=====  ==========================  ==================================================
K4     ``_enc_kernel``              ``bf16_encode`` / ``encode_bf16_plain``
K5     ``_dec_axpy_kernel``         ``bf16_decode_axpy`` / ``decode_axpy_plain``
=====  ==========================  ==================================================

Both are bound by bytes on an H100 (K4 ~223 us, K5 ~371 us over the 124.4 M
floats of gpt2_small); the source's header says more and PERF.md has the
measured times. A wrapper given CPU tensors computes the plain version; given
CUDA tensors it launches its kernel or raises — there is no fallback.
``LAUNCHES`` counts kernel launches, one per wrapper call that reached the card.

Encode semantics: round to nearest even on the bits, subnormals included; a
NaN encodes as its sign | ``0x7fc0`` (the XLA convert's canonical quiet NaN).
The host codec (``native.f32_to_bf16``) agrees on every finite value, on
±inf and on the canonical NaNs; it keeps the top payload bits of other NaNs.

``MeshCodec`` keeps the reference's names and contract for the copied
``swarm/agg_stream.py`` and ``swarm/averager.py``:

- ``backend``: ``"device"`` (the reference's ``"mesh"``) runs the codec ops as
  torch on the codec's device — the kernels on a CUDA device, the plain
  versions on the CPU (how the CPU tests drive the folder logic); ``"host"``
  delegates to ``native`` / ``ops.robust`` numpy; ``"auto"`` is device on CUDA
  and host otherwise. Chosen by argument only: no environment variable is read.
- One device per volunteer; the reference's multi-chip codec mesh and its
  ring collective (K6/K7, ``ops/mesh_collective.py``) are not ported.
- No degrade: the backend is fixed at construction. A device op that fails
  (a kernel that does not launch, a failed copy, ``inject_failure``, the chaos
  hook) raises out of the op, so the round fails and the trainer keeps its
  local params; the next round runs on the device again. The reference
  instead moves a failed codec to the host for good. A failed build raises
  from ``configure``.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.utils.torchenv import DeviceLike, resolve_device

# Stage this many raw wire bytes before a MeshMeanFolder flush (the
# reference's value): big enough to amortize one host-to-device copy over
# many chunks, small enough that folding stays overlapped with arrival.
FOLDER_FLUSH_BYTES = 16 << 20

LAUNCHES: Dict[str, int] = {"bf16_encode": 0, "bf16_decode_axpy": 0}
_launch_lock = threading.Lock()  # the codec launches from several worker threads


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


class MeshCodecError(RuntimeError):
    """An injected (chaos) or real device failure inside a codec op."""


# ---------------------------------------------------------------------------
# plain versions (int32 bit arithmetic; never .to(torch.bfloat16), whose NaN
# is 0xffff)
# ---------------------------------------------------------------------------


def encode_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 [n] -> bf16 bit patterns [n] as int16 (round to nearest even)."""
    u = x.contiguous().view(torch.int32)
    # Signed int32 addition has the bits of the unsigned one: no non-NaN input
    # carries past bit 31. The arithmetic shift leaves the high half, sign
    # extended, so the int16 cast is exact.
    hi = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).to(torch.int16)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    canonical = torch.where(u < 0, -64, 0x7FC0).to(torch.int16)  # 0xffc0 / 0x7fc0
    return torch.where(nan, canonical, hi)


def widen_bf16(bits: torch.Tensor) -> torch.Tensor:
    """int16 bf16 bit patterns -> f32 (exact: bf16 ⊂ f32, NaN bits kept)."""
    return bits.view(torch.bfloat16).to(torch.float32)


def decode_axpy_plain(acc: torch.Tensor, bits: torch.Tensor, w: float) -> torch.Tensor:
    """acc + w * widen(bits) in f32, the multiply and the add each rounded."""
    return acc + torch.tensor(w, dtype=torch.float32) * widen_bf16(bits)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch(name: str, device: torch.device, *args) -> None:
    from distributedvolunteercomputing_tpu_torch.ops import _build

    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"dvc_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.dvc_error_string(err).decode()}")
    with _launch_lock:
        LAUNCHES[name] += 1


def _check_flat(name: str, x: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name}: tensors on {x.device} and {device}")
    if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D {dtype}, got {x.dtype} {tuple(x.shape)}")


def bf16_encode(x: torch.Tensor) -> torch.Tensor:
    """K4. f32 [n] -> int16 [n] bf16 bit patterns."""
    if x.device.type == "cpu":
        return encode_bf16_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"bf16_encode: expected a CUDA or CPU tensor, got {x.device}")
    _check_flat("bf16_encode", x, torch.float32, x.device)
    out = torch.empty(x.shape, dtype=torch.int16, device=x.device)
    if x.numel():
        _launch("bf16_encode", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def bf16_decode_axpy(
    acc: torch.Tensor, bits: torch.Tensor, w: float, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K5. acc + w * widen(bits) in f32; ``out`` may be ``acc`` (in place)."""
    if acc.device.type == "cpu":
        res = decode_axpy_plain(acc, bits, w)
        return res if out is None else out.copy_(res)
    if acc.device.type != "cuda":
        raise ValueError(f"bf16_decode_axpy: expected CUDA or CPU tensors, got {acc.device}")
    _check_flat("bf16_decode_axpy", acc, torch.float32, acc.device)
    _check_flat("bf16_decode_axpy", bits, torch.int16, acc.device)
    if out is None:
        out = torch.empty_like(acc)
    _check_flat("bf16_decode_axpy", out, torch.float32, acc.device)
    if not acc.numel() == bits.numel() == out.numel():
        raise ValueError(
            f"bf16_decode_axpy: sizes differ: acc {acc.numel()}, bits {bits.numel()}, out {out.numel()}"
        )
    if acc.numel():
        _launch(
            "bf16_decode_axpy", acc.device,
            bits.data_ptr(), acc.data_ptr(), out.data_ptr(), float(w), acc.numel(),
        )
    return out


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def _host_u16(bits: torch.Tensor) -> np.ndarray:
    return bits.cpu().numpy().view(np.uint16)


class MeshCodec:
    """One volunteer's codec and fold engine on its device (or the host).

    ``device``: the volunteer's ``torch.device`` (``None`` = the card, as
    everywhere in the port). ``backend``: "auto" | "device" | "host"."""

    def __init__(self, device: DeviceLike = None, backend: str = "auto"):
        if backend not in ("auto", "device", "host"):
            raise ValueError(f"unknown mesh-codec backend {backend!r}")
        self._lock = threading.Lock()
        self.device = resolve_device(device)
        if backend == "auto":
            backend = "device" if self.device.type == "cuda" else "host"
        self.backend = backend
        if backend == "device" and self.device.type == "cuda":
            from distributedvolunteercomputing_tpu_torch.ops import _build

            _build.load_library()  # a failed build raises here, not mid-round
        self._fail_injected = 0
        self.ops_mesh = 0
        self.ops_host = 0
        self.device_s = 0.0

    @property
    def active(self) -> bool:
        """True when the codec ops run on the device."""
        return self.backend == "device"

    def stats(self) -> dict:
        return {
            "backend": self.backend,
            "device": str(self.device),
            "ops_mesh": int(self.ops_mesh),
            "ops_host": int(self.ops_host),
            "device_s": round(self.device_s, 6),
        }

    # -- device ops --------------------------------------------------------

    def inject_failure(self, n: int = 1) -> None:
        """Chaos hook: the next ``n`` device ops raise ``MeshCodecError`` (a
        synthetic device loss)."""
        with self._lock:
            self._fail_injected += int(n)

    def _device(self, op: Callable):
        """Run ``op`` on the device; any failure raises to the caller."""
        with self._lock:
            if self._fail_injected > 0:
                self._fail_injected -= 1
                raise MeshCodecError("injected mesh failure (chaos)")
        t0 = time.perf_counter()
        out = op()
        self.device_s += time.perf_counter() - t0
        self.ops_mesh += 1
        return out

    def _run(self, op: Callable, host: Callable):
        """``op`` on the device backend, ``host`` on the host backend."""
        if not self.active:
            self.ops_host += 1
            return host()
        return self._device(op)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        with warnings.catch_warnings():
            # Wire bytes arrive as read-only buffers; the codec only reads them.
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            return torch.from_numpy(arr).to(self.device)

    # -- bf16 wire codec ---------------------------------------------------

    def encode_bf16(self, buf: np.ndarray) -> np.ndarray:
        """float32 [n] -> uint16 [n] bf16 bit patterns (K4 on the card)."""
        from distributedvolunteercomputing_tpu_torch import native

        buf = np.ascontiguousarray(buf, np.float32).ravel()
        return self._run(
            lambda: _host_u16(bf16_encode(self._put(buf))), lambda: native.f32_to_bf16(buf)
        )

    def decode_bf16(self, bits: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        """uint16 bf16 bit patterns -> float32 (exact: bf16 ⊂ f32)."""
        from distributedvolunteercomputing_tpu_torch import native

        bits = np.ascontiguousarray(bits, np.uint16).ravel()

        def dev() -> np.ndarray:
            res = widen_bf16(self._put(bits.view(np.int16))).cpu().numpy()
            if out is not None:
                out[: res.size] = res
                return out[: res.size]
            return res

        return self._run(dev, lambda: native.bf16_to_f32(bits, out=out))

    # -- window folds ------------------------------------------------------

    def aggregate(self, stack: np.ndarray, method: str, **kw) -> np.ndarray:
        """``ops.robust.aggregate`` with mean, median and trimmed_mean on the
        device; every other method takes the host path unchanged."""
        from distributedvolunteercomputing_tpu_torch.ops import robust

        if method not in ("mean", "median", "trimmed_mean") or stack.ndim != 2:
            self.ops_host += 1
            return robust.aggregate(stack, method, **kw)
        n = stack.shape[0]
        trim = None
        if method == "trimmed_mean":
            trim = int(kw.get("trim", 1))
            if 2 * trim >= n:
                raise ValueError(f"trim={trim} too large for n={n}")
            if trim == 0:
                method, kw = "mean", {}
        if method == "mean" and n == 1:
            self.ops_host += 1  # degenerate window: the device buys nothing
            return robust.aggregate(stack, method, **kw)

        def dev() -> np.ndarray:
            s = self._put(np.asarray(stack, np.float32))
            if method == "mean":
                w = kw.get("weights")
                wn = (
                    np.asarray(w, np.float64) / np.asarray(w, np.float64).sum()
                    if w is not None
                    else np.full(n, 1.0 / n)
                ).astype(np.float32)
                return (s * self._put(wn)[:, None]).sum(dim=0).cpu().numpy()
            return _window_fold(s, method, trim).cpu().numpy()

        return self._run(dev, lambda: robust.aggregate(stack, method, **kw))

    def aggregate_bits(self, bits_stack: np.ndarray, method: str, **kw) -> np.ndarray:
        """Window fold from bf16 wire bits [n, T]: widen, then ``aggregate``."""
        from distributedvolunteercomputing_tpu_torch import native
        from distributedvolunteercomputing_tpu_torch.ops import robust

        def host() -> np.ndarray:
            dec = np.stack([native.bf16_to_f32(row) for row in bits_stack])
            return robust.aggregate(dec, method, **kw)

        if not self.active:
            self.ops_host += 1
            return host()
        dec = self._device(
            lambda: widen_bf16(self._put(np.asarray(bits_stack, np.uint16).view(np.int16))).cpu().numpy()
        )
        return self.aggregate(dec, method, **kw)

    # -- streaming mean folder --------------------------------------------

    def mean_folder(
        self, n_elems: int, tile_elems: int, n_tiles: int, wire: str
    ) -> Optional["MeshMeanFolder"]:
        """A device mean folder for one round, or None on the host backend."""
        if not self.active:
            return None
        return MeshMeanFolder(self, n_elems, tile_elems, n_tiles, wire)


def _window_fold(s: torch.Tensor, method: str, trim: Optional[int]) -> torch.Tensor:
    """Median or trimmed mean over the peer axis of [n, T].

    NaN -> +inf first (the reference's rule, ``mesh_codec.py`` ``_build_window``):
    one NaN-filled byzantine row must not poison every row of a coordinate;
    +inf sorts it last, so trimming drops it as the host path would, and a
    NaN count beyond the trim yields inf. Rows are summed in sorted order,
    one after the other, as the reference's unrolled network does."""
    n = s.shape[0]
    rows = torch.sort(torch.where(torch.isnan(s), torch.inf, s), dim=0).values
    if method == "median":
        return (rows[(n - 1) // 2] + rows[n // 2]) * 0.5
    kept = rows[trim : n - trim]
    acc = kept[0].clone()
    for r in kept[1:]:
        acc += r
    return acc / float(len(kept))


class MeshMeanFolder:
    """Device-resident mean accumulator for one streaming round.

    Arriving wire chunks stage as raw bytes (no decode on the frame-reader
    thread) and fold in batches of ``FOLDER_FLUSH_BYTES``: one host-to-device
    copy of the batch, then, on the bf16 wire, one K5 launch per chunk, in
    staging order, on the accumulator row ``acc[tile, :len]`` — the
    reference's ``a.at[t].add(w * widen(x))`` with duplicate tiles folded one
    after the other. The f32 wire and dense feeds are ``acc.add_(x, alpha=w)``.
    Per-tile weight tallies stay in the aggregator. ``result()`` flushes the
    tail and pulls the accumulator to the host once. A failed fold raises
    (from the flush worker, so the aggregator's finalize fails the round)."""

    kind = "staged"

    def __init__(self, codec: MeshCodec, n_elems: int, tile_elems: int, n_tiles: int, wire: str):
        if wire not in ("f32", "bf16"):
            raise ValueError(f"mean folder needs an elementwise wire, got {wire!r}")
        self.codec = codec
        self.n_elems = int(n_elems)
        self.tile_elems = int(tile_elems)
        self.n_tiles = int(n_tiles)
        self.wire = wire
        self.esz = 4 if wire == "f32" else 2
        self._lock = threading.Lock()
        self._staged: List[Tuple[int, float, bytes]] = []
        self._staged_bytes = 0
        # High-water of raw wire bytes held between flushes (the aggregator
        # adds it to its peak-held gauge).
        self.peak_staged_bytes = 0
        self.flush_bytes = FOLDER_FLUSH_BYTES
        self._acc: Optional[torch.Tensor] = None  # device [n_tiles, tile_elems] f32, lazy
        self.flushes = 0

    # -- staging (called under the aggregator's lock) ----------------------

    def add(self, tile: int, weight: float, data: bytes) -> bool:
        """Stage one verified wire chunk; True when a flush is due."""
        with self._lock:
            self._staged.append((tile, float(weight), data))
            self._staged_bytes += len(data)
            if self._staged_bytes > self.peak_staged_bytes:
                self.peak_staged_bytes = self._staged_bytes
            return self._staged_bytes >= self.flush_bytes

    def add_dense(self, buf: np.ndarray, weight: float) -> None:
        """Fold a complete dense f32 contribution (leader's own / parked)."""
        buf = np.ascontiguousarray(buf, np.float32).ravel()
        if buf.size != self.n_elems:
            raise ValueError(f"dense feed size {buf.size} != {self.n_elems}")

        def dev() -> None:
            x = self.codec._put(buf)
            with self._lock:
                self._device_acc().view(-1)[: self.n_elems].add_(x, alpha=float(weight))

        self.codec._device(dev)

    # -- device plumbing ---------------------------------------------------

    def _device_acc(self) -> torch.Tensor:
        if self._acc is None:
            self._acc = torch.zeros(
                (self.n_tiles, self.tile_elems), dtype=torch.float32, device=self.codec.device
            )
        return self._acc

    # -- folding -----------------------------------------------------------

    def _pop_staged(self) -> List[Tuple[int, float, bytes]]:
        with self._lock:
            batch, self._staged = self._staged, []
            self._staged_bytes = 0
        return batch

    def _flush_dev(self, batch: List[Tuple[int, float, bytes]]) -> None:
        """One copy of the batch to the device ([k, row] rows, each chunk at
        the start of its own row so every row is 16-byte aligned), then one
        fold per chunk in staging order."""
        row_bytes = self.tile_elems * self.esz
        raw = np.zeros((len(batch), row_bytes), np.uint8)
        for i, (_, _, data) in enumerate(batch):
            raw[i, : len(data)] = np.frombuffer(data, np.uint8)
        rows = self.codec._put(raw).view(torch.int16 if self.wire == "bf16" else torch.float32)
        with self._lock:
            acc = self._device_acc()
            for i, (tile, w, data) in enumerate(batch):
                n = len(data) // self.esz
                dst = acc[tile, :n]
                if self.wire == "bf16":
                    bf16_decode_axpy(dst, rows[i, :n], w, out=dst)
                else:
                    dst.add_(rows[i, :n], alpha=w)

    def flush(self) -> None:
        """Fold every staged chunk (worker-thread context)."""
        batch = self._pop_staged()
        if not batch:
            return
        self.flushes += 1
        self.codec._device(lambda: self._flush_dev(batch))

    def result(self) -> np.ndarray:
        """Flush the tail and return the flat RAW accumulator [n_elems]
        (per-tile re-normalization stays with the aggregator)."""
        self.flush()
        with self._lock:
            if self._acc is None:
                return np.zeros(self.n_elems, np.float32)
            out = self._acc.view(-1)[: self.n_elems].cpu().numpy().copy()
            self._acc = None
            return out

    @property
    def device_bytes(self) -> int:
        return self.n_tiles * self.tile_elems * 4


# ---------------------------------------------------------------------------
# process-wide default (one codec per volunteer process)
# ---------------------------------------------------------------------------

_default: Optional[MeshCodec] = None
_default_lock = threading.Lock()


def get_default() -> MeshCodec:
    """The process's codec: the one ``configure`` selected, else one built
    on first use on the card with auto backend selection (raises without a
    card, as every entry point of the port does unless asked for the CPU)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = MeshCodec()
    return _default


def configure(device: DeviceLike = None, backend: str = "auto") -> MeshCodec:
    """Select this volunteer's codec at startup, on its device (``None`` =
    the card). Builds the kernels when the codec resolves to a CUDA device."""
    global _default
    codec = MeshCodec(device=device, backend=backend)
    with _default_lock:
        _default = codec
    return codec


def reset() -> None:
    """Drop the process default (tests)."""
    global _default
    with _default_lock:
        _default = None

