"""The swarm data path on the volunteer's card: the bf16 wire codec and the
leader's mean fold (ported from ``distributedvolunteercomputing_tpu/ops/mesh_codec.py``).

Two hand-written CUDA kernels (``csrc/bf16_codec.cu``) replace the reference's
Pallas TPU kernels; everything else here is plain PyTorch, as the reference
left it to XLA outside any Pallas kernel:

=====  ==========================  ==================================================
kernel TPU kernel it replaces       wrapper / plain version
=====  ==========================  ==================================================
K4     ``_enc_kernel``              ``bf16_encode`` / ``encode_bf16_plain``
K5     ``_dec_axpy_kernel``         ``bf16_fold_chunks`` / ``fold_chunks_plain`` (a
                                    staged batch into accumulator rows, the folder's
                                    flush) and ``bf16_decode_axpy`` /
                                    ``decode_axpy_plain`` (flat buffers)
=====  ==========================  ==================================================

PowerSGD's power iteration and reconstruction (``low_rank_iterate``,
``lowrank_reconstruct``) are ``torch.linalg.qr`` and matmuls in f32 on the
codec's device, as the reference computes them in jnp outside any kernel.

Both are bound by bytes on an H100 (K4 ~223 us over the 124.4 M floats of
gpt2_small, K5 ~25 us per 16 MiB flush of 1 MiB chunks); the source's header
says more and PERF.md has the measured times. K5 folds a whole staged batch
in one launch, its chunk table passed by value in the kernel's parameter
block (``fold_plan``: a batch whose table does not fit is split into
launches of whole tiles). A wrapper given CPU tensors computes the plain
version; given CUDA tensors it launches its kernel or raises — there is no
fallback. ``LAUNCHES`` counts kernel launches.

Encode semantics: round to nearest even on the bits, subnormals included; a
NaN encodes as its sign | ``0x7fc0`` (the XLA convert's canonical quiet NaN).
The host codec (``native.f32_to_bf16``) agrees on every finite value, on
±inf and on the canonical NaNs; it keeps the top payload bits of other NaNs.

``MeshCodec`` keeps the reference's names and contract for the copied
``swarm/agg_stream.py`` and ``swarm/averager.py``:

- ``backend``: ``"device"`` (the reference's ``"mesh"``) runs the codec ops as
  torch on the codec's ranks — the kernels on CUDA devices, the plain
  versions on the CPU (how the CPU tests drive the folder logic); ``"host"``
  delegates to ``native`` / ``ops.robust`` numpy; ``"auto"`` is device on CUDA
  and host otherwise. Chosen by argument only: no environment variable is read.
- Ranks: one device by default (``device``, the card unless "cpu" is asked
  for), or one rank per device of the volunteer's ``mesh``
  (``parallel/mesh.py``), flattened as the reference's ``_ensure_mesh``
  flattens it. A mesh may name a card more than once (ranks that share it).
  Flat buffers split over the ranks as the reference's ``_put_flat`` splits
  them: K4 runs once per rank on its slice, and the window folds on column
  slices. The mean folder keeps its accumulator element-split,
  ``[n_tiles, tile_elems / nd]`` on each rank. ``collective``: "ring" folds a
  bf16 round through ``ops/mesh_collective.py`` (K6/K7, ranks pull from their
  ring neighbour, one CUDA stream each), "off" keeps the staged folder, and
  "auto" means ring when the codec has two or more CUDA ranks. One rank is
  the one-device codec: no extra stream, everything on the current one.
- No degrade: the backend is fixed at construction. A device op that fails
  (a kernel that does not launch, a failed copy, ``inject_failure``, the chaos
  hook) raises out of the op, so the round fails and the trainer keeps its
  local params; the next round runs on the device again. The reference
  instead moves a failed codec to the host for good. A failed build, or two
  cards of a ring that cannot reach each other, raises from ``configure``.
"""

from __future__ import annotations

import array
import itertools
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.utils.torchenv import DeviceLike, resolve_device

# Stage this many raw wire bytes before a MeshMeanFolder flush (the
# reference's value): big enough to amortize one host-to-device copy over
# many chunks, small enough that folding stays overlapped with arrival.
FOLDER_FLUSH_BYTES = 16 << 20

LAUNCHES: Dict[str, int] = {"bf16_encode": 0, "bf16_fold_chunks": 0}
# PowerSGD's low-rank ops run on the device as library calls (QR and matmul,
# as the reference runs them in jnp outside any Pallas kernel): counted per
# device call, apart from the kernels, and reported beside them in
# ``MeshCodec.stats()["launches"]``.
LOW_RANK_CALLS: Dict[str, int] = {"low_rank_iterate": 0, "lowrank_reconstruct": 0}
_launch_lock = threading.Lock()  # the codec launches from several worker threads
# K5's chunk table per launch (csrc/bf16_codec.cu kFoldWords), int32 words:
# 3 per tile, 3 per chunk and one more. Must equal the kernel's: the launcher
# refuses anything larger.
FOLD_WORDS = 2032


def reset_launch_counts() -> None:
    with _launch_lock:
        for counts in (LAUNCHES, LOW_RANK_CALLS):
            for name in counts:
                counts[name] = 0


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


def fold_chunks_plain(
    acc: torch.Tensor, bits_rows: torch.Tensor, tiles: Sequence[int], weights: Sequence[float],
    lens: Sequence[int], col0: int,
) -> None:
    """K5's batched function, in place on ``acc`` [n_tiles, shard]: chunk i
    folds ``bits_rows[i, col0 : col0 + lens[i]]`` with weight ``weights[i]``
    into ``acc[tiles[i], :lens[i]]``, one chunk after the other in staging
    order (``decode_axpy_plain`` per chunk)."""
    _check_fold(acc, bits_rows, tiles, weights, lens, col0)
    for i, (t, w, n) in enumerate(zip(tiles, weights, lens)):
        if n > 0:
            dst = acc[int(t), :n]
            dst.copy_(decode_axpy_plain(dst, bits_rows[i, col0 : col0 + n], float(w)))


def _check_fold(acc, bits_rows, tiles, weights, lens, col0) -> None:
    """K5's batch: acc f32 [n_tiles, shard] and bits_rows int16 [k, width],
    rows contiguous, on one device; per chunk a tile in range and a length
    within the shard and within its bits row from ``col0``."""
    for name, x, dtype in (("acc", acc, torch.float32), ("bits_rows", bits_rows, torch.int16)):
        if x.dtype != dtype or x.dim() != 2 or x.stride(1) != 1:
            raise ValueError(f"fold_chunks: {name} must be {dtype} [rows, cols] with contiguous rows, "
                             f"got {x.dtype} {tuple(x.shape)}")
    if bits_rows.device != acc.device:
        raise ValueError(f"fold_chunks: tensors on {bits_rows.device} and {acc.device}")
    k, width = bits_rows.shape
    n_tiles, shard = acc.shape
    if not len(tiles) == len(weights) == len(lens) == k:
        raise ValueError(f"fold_chunks: {k} bits rows, {len(tiles)} tiles, {len(weights)} weights, {len(lens)} lens")
    if col0 < 0:
        raise ValueError(f"fold_chunks: negative column offset {col0}")
    if shard >= 1 << 31:
        raise ValueError(f"fold_chunks: {shard} columns past the chunk table's int32 lengths")
    for t, n in zip(tiles, lens):
        if not 0 <= t < n_tiles:
            raise ValueError(f"fold_chunks: tile {t} out of [0, {n_tiles})")
        if not 0 <= n <= shard:
            raise ValueError(f"fold_chunks: length {n} past the shard of {shard} columns")
        if col0 + n > width:
            raise ValueError(f"fold_chunks: length {n} from column {col0} past the bits row of {width}")


def fold_plan(
    tiles: Sequence[int], weights: Sequence[float], lens: Sequence[int]
) -> List[Tuple[array.array, int, int]]:
    """K5's chunk tables for one batch: (int32 words, tiles, chunks) per
    launch. The batch's tiles in order of first arrival, each with its chunks
    of non-zero length in staging order; a launch's table is row [U] | cols
    [U] (its chunks' longest length) | ptr [U + 1] | chunk row [K] | weight
    bits [K] | len [K] and holds at most ``FOLD_WORDS`` words. A batch whose
    table does not fit is split into launches of whole tiles, so every
    element still folds its chunks in staging order; a tile whose chunks
    alone need more words raises."""
    by_tile: Dict[int, List[int]] = {}
    for i, (t, n) in enumerate(zip(tiles, lens)):
        if n > 0:
            by_tile.setdefault(int(t), []).append(i)
    groups: List[List[Tuple[int, List[int]]]] = []
    words = FOLD_WORDS
    for t, idx in by_tile.items():
        need = 3 + 3 * len(idx)
        if 1 + need > FOLD_WORDS:
            raise ValueError(f"fold_chunks: the {len(idx)} chunks of tile {t} need more than {FOLD_WORDS} table words")
        if words + need > FOLD_WORDS:
            groups.append([])
            words = 1
        groups[-1].append((t, idx))
        words += need
    wbits = np.asarray(weights, np.float32).view(np.int32).tolist()
    tables = []
    for group in groups:
        chunks = [i for _, idx in group for i in idx]
        table = [t for t, _ in group]
        table += [max(lens[i] for i in idx) for _, idx in group]
        table += itertools.accumulate([0] + [len(idx) for _, idx in group])
        table += chunks
        table += [wbits[i] for i in chunks]
        table += [lens[i] for i in chunks]
        tables.append((array.array("i", table), len(group), len(chunks)))
    return tables


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch(name: str, device: torch.device, *args, counts: Optional[Dict[str, int]] = None) -> None:
    """Launch ``dvc_<name>`` on ``device``'s current stream and count it in
    ``counts`` (this module's ``LAUNCHES`` by default)."""
    from distributedvolunteercomputing_tpu_torch.ops import _build

    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"dvc_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.dvc_error_string(err).decode()}")
    counts = LAUNCHES if counts is None else counts
    with _launch_lock:
        counts[name] += 1


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
    """K5 on flat buffers. acc + w * widen(bits) in f32; ``out`` may be
    ``acc`` (in place). On the card, one ``bf16_fold_chunks`` launch of one
    tile and one chunk on ``out``, a copy of ``acc`` unless it is ``acc``."""
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
    n = acc.numel()
    if not n == bits.numel() == out.numel():
        raise ValueError(f"bf16_decode_axpy: sizes differ: acc {n}, bits {bits.numel()}, out {out.numel()}")
    if out.data_ptr() != acc.data_ptr():
        out.copy_(acc)
    if n:
        bf16_fold_chunks(out.view(1, n), bits.view(1, n), [0], [w], [n], 0)
    return out


def bf16_fold_chunks(
    acc: torch.Tensor, bits_rows: torch.Tensor, tiles: Sequence[int], weights: Sequence[float],
    lens: Sequence[int], col0: int,
) -> int:
    """K5 on a staged batch, in place: ``fold_chunks_plain``'s function in one
    launch per ``fold_plan`` table (one for any batch whose table fits).
    ``tiles``, ``weights`` and ``lens`` are host values. Returns the launches
    made (0 on the CPU)."""
    if acc.device.type == "cpu":
        fold_chunks_plain(acc, bits_rows, tiles, weights, lens, col0)
        return 0
    if acc.device.type != "cuda":
        raise ValueError(f"bf16_fold_chunks: expected CUDA or CPU tensors, got {acc.device}")
    _check_fold(acc, bits_rows, tiles, weights, lens, col0)
    plan = fold_plan(tiles, weights, lens)
    for words, n_tiles, n_chunks in plan:
        _launch(
            "bf16_fold_chunks", acc.device,
            bits_rows.data_ptr(), acc.data_ptr(), bits_rows.stride(0), acc.stride(0), col0,
            words.buffer_info()[0], len(words), n_tiles, n_chunks,
        )
    return len(plan)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


class MeshCodec:
    """One volunteer's codec and fold engine on its ranks (or the host).

    ``device``: the volunteer's ``torch.device`` when it has no mesh (``None``
    = the card, as everywhere in the port). ``mesh``: the volunteer's
    ``parallel.mesh.Mesh``; its devices, flattened, are the codec's ranks.
    ``backend``: "auto" | "device" | "host". ``collective``: "auto" | "ring"
    | "off"."""

    def __init__(
        self,
        device: DeviceLike = None,
        backend: str = "auto",
        mesh: Optional[Any] = None,
        collective: str = "auto",
    ):
        if backend not in ("auto", "device", "host"):
            raise ValueError(f"unknown mesh-codec backend {backend!r}")
        if collective not in ("auto", "ring", "off"):
            raise ValueError(f"unknown mesh collective {collective!r}")
        self._lock = threading.Lock()
        if mesh is None:
            self.ranks: List[torch.device] = [resolve_device(device)]
        else:
            self.ranks = [_indexed(resolve_device(d)) for d in mesh.flat()]
            if device is not None and _indexed(resolve_device(device)) != self.ranks[0]:
                raise ValueError(f"device {device} is not the mesh's first device {self.ranks[0]}")
            if len({d.type for d in self.ranks}) != 1:
                raise ValueError(f"a codec mesh mixes device types: {self.ranks}")
        self.device = self.ranks[0]
        self.nd = len(self.ranks)
        cuda = self.device.type == "cuda"
        if backend == "auto":
            backend = "device" if cuda else "host"
        self.backend = backend
        if collective == "auto":
            collective = "ring" if cuda and self.nd >= 2 else "off"
        self.collective = collective
        # One stream per rank for the ring's steps; a one-rank codec runs
        # everything on the current stream.
        self.streams: List[Optional[torch.cuda.Stream]] = [
            torch.cuda.Stream(device=d) if cuda and self.nd >= 2 else None for d in self.ranks
        ]
        if backend == "device" and cuda:
            from distributedvolunteercomputing_tpu_torch.ops import _build

            _build.load_library()  # a failed build raises here, not mid-round
            if collective == "ring":
                _enable_ring_peers(self.ranks)
        self._fail_injected = 0
        # This codec's device low-rank calls (``LOW_RANK_CALLS`` counts the
        # process's, over every codec).
        self.low_rank_calls = dict.fromkeys(LOW_RANK_CALLS, 0)
        self.ops_mesh = 0
        self.ops_host = 0
        self.device_s = 0.0
        # Ring gauges (ops/mesh_collective.py): flushes folded on K6 and
        # results gathered on K7, over every folder of this codec.
        self.ring_flushes = 0
        self.ring_results = 0

    @property
    def active(self) -> bool:
        """True when the codec ops run on the device."""
        return self.backend == "device"

    def stats(self) -> dict:
        return {
            "backend": self.backend,
            "device": str(self.device),
            "devices": self.nd,
            "collective": self.collective,
            "ops_mesh": int(self.ops_mesh),
            "ops_host": int(self.ops_host),
            "device_s": round(self.device_s, 6),
            "ring_flushes": int(self.ring_flushes),
            "ring_results": int(self.ring_results),
            # K4/K5 launches of this process (``LAUNCHES``) and its device
            # low-rank calls (``LOW_RANK_CALLS``), as a report shows them.
            "launches": {**LAUNCHES, **LOW_RANK_CALLS},
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

    def _put(self, arr: np.ndarray, rank: int = 0) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        with warnings.catch_warnings():
            # Wire bytes arrive as read-only buffers; the codec only reads them.
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            return torch.from_numpy(arr).to(self.ranks[rank])

    def _splits(self, n: int) -> List[Tuple[int, int]]:
        """Rank r's slice [lo, hi) of n elements: ceil(n / nd) each, the
        last ones short or empty (the reference's ``_put_flat`` padding)."""
        per = -(-n // self.nd)
        return [(min(r * per, n), min((r + 1) * per, n)) for r in range(self.nd)]

    def _map_cols(self, arr: np.ndarray, fn: Callable[..., torch.Tensor], *more: np.ndarray) -> np.ndarray:
        """``fn`` on each rank's slice of ``arr``'s last axis (and of each
        array of ``more``, of the same width, as further arguments), the
        results joined on the host along the last axis (the reference's
        ``shard_map`` over the codec axis). Every rank's op is queued before
        the first result is fetched."""
        outs = [
            fn(self._put(arr[..., lo:hi], r), *(self._put(m[..., lo:hi], r) for m in more))
            for r, (lo, hi) in enumerate(self._splits(arr.shape[-1]))
            if hi > lo or r == 0
        ]
        parts = [o.cpu().numpy() for o in outs]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=-1)

    # -- bf16 wire codec ---------------------------------------------------

    def encode_bf16(self, buf: np.ndarray) -> np.ndarray:
        """float32 [n] -> uint16 [n] bf16 bit patterns (K4 on each rank's slice)."""
        from distributedvolunteercomputing_tpu_torch import native

        buf = np.ascontiguousarray(buf, np.float32).ravel()
        return self._run(
            lambda: self._map_cols(buf, bf16_encode).view(np.uint16), lambda: native.f32_to_bf16(buf)
        )

    def decode_bf16(self, bits: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        """uint16 bf16 bit patterns -> float32 (exact: bf16 ⊂ f32)."""
        from distributedvolunteercomputing_tpu_torch import native

        bits = np.ascontiguousarray(bits, np.uint16).ravel()

        def dev() -> np.ndarray:
            res = self._map_cols(bits.view(np.int16), widen_bf16)
            if out is not None:
                out[: res.size] = res
                return out[: res.size]
            return res

        return self._run(dev, lambda: native.bf16_to_f32(bits, out=out))

    def decode_axpy(self, acc: np.ndarray, bits: np.ndarray, w: float) -> np.ndarray:
        """acc + w · widen(bits) in one fused pass (K5 on each rank's slice).
        Returns the new accumulator; the host backend mutates ``acc`` in
        place and returns it — callers must use the return value either way."""
        from distributedvolunteercomputing_tpu_torch import native

        acc = np.ascontiguousarray(acc, np.float32).ravel()
        bits = np.ascontiguousarray(bits, np.uint16).ravel()
        if acc.size != bits.size:
            raise ValueError(f"decode_axpy size mismatch: {acc.size} vs {bits.size}")

        def host() -> np.ndarray:
            native.weighted_sum_inplace(acc, native.bf16_to_f32(bits), float(w))
            return acc

        return self._run(
            lambda: self._map_cols(acc, lambda a, b: bf16_decode_axpy(a, b, float(w)), bits.view(np.int16)), host
        )

    # -- window folds ------------------------------------------------------

    def aggregate(self, stack: np.ndarray, method: str, **kw) -> np.ndarray:
        """``ops.robust.aggregate`` with mean, median and trimmed_mean on the
        device, each rank folding its column slice; every other method takes
        the host path unchanged."""
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
            s = np.asarray(stack, np.float32)
            if method == "mean":
                w = kw.get("weights")
                wn = torch.from_numpy(
                    (
                        np.asarray(w, np.float64) / np.asarray(w, np.float64).sum()
                        if w is not None
                        else np.full(n, 1.0 / n)
                    ).astype(np.float32)
                )
                return self._map_cols(s, lambda x: (x * wn.to(x.device)[:, None]).sum(dim=0))
            return self._map_cols(s, lambda x: _window_fold(x, method, trim))

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
            lambda: self._map_cols(np.asarray(bits_stack, np.uint16).view(np.int16), widen_bf16)
        )
        return self.aggregate(dec, method, **kw)

    # -- PowerSGD ----------------------------------------------------------

    def _count_low_rank(self, name: str) -> None:
        with _launch_lock:
            LOW_RANK_CALLS[name] += 1
            self.low_rank_calls[name] += 1

    def low_rank_iterate(self, mat: np.ndarray, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One PowerSGD power iteration: P = QR-orthonormalize(M·Q), Q' = Mᵀ·P
        (Q' carries the scale). On the device in f32 on the codec's first
        rank; a column of P may differ in sign from the host's QR, and Q'
        with it, so P·Q'ᵀ does not change."""

        def dev() -> Tuple[np.ndarray, np.ndarray]:
            m_ = self._put(np.ascontiguousarray(mat, np.float32))
            q_ = self._put(np.ascontiguousarray(q, np.float32))
            p_ = torch.linalg.qr(m_ @ q_, mode="reduced").Q
            q_new = m_.T @ p_
            self._count_low_rank("low_rank_iterate")
            return (
                np.ascontiguousarray(p_.cpu().numpy(), np.float32),
                np.ascontiguousarray(q_new.cpu().numpy(), np.float32),
            )

        def host() -> Tuple[np.ndarray, np.ndarray]:
            p, _ = np.linalg.qr((mat @ q).astype(np.float32, copy=False))
            p = np.ascontiguousarray(p, np.float32)
            return p, mat.T @ p

        return self._run(dev, host)

    def lowrank_reconstruct(self, p: np.ndarray, q: np.ndarray) -> np.ndarray:
        """Dense rank-r reconstruction (P·Qᵀ).ravel(), the decoder's matmul."""

        def dev() -> np.ndarray:
            out = self._put(np.ascontiguousarray(p, np.float32)) @ self._put(np.ascontiguousarray(q, np.float32)).T
            self._count_low_rank("lowrank_reconstruct")
            return out.cpu().numpy().ravel()

        return self._run(dev, lambda: (p @ q.T).ravel())

    # -- streaming mean folder --------------------------------------------

    def mean_folder(
        self, n_elems: int, tile_elems: int, n_tiles: int, wire: str
    ) -> Optional["MeshMeanFolder"]:
        """A device mean folder for one round: None on the host backend or
        when a tile does not split over the ranks; the ring folder
        (``ops/mesh_collective.py``) on the bf16 wire with the ring selected
        and two or more ranks; the staged folder otherwise."""
        if not self.active or tile_elems % self.nd:
            return None
        if self.collective == "ring" and wire == "bf16" and self.nd >= 2:
            from distributedvolunteercomputing_tpu_torch.ops import mesh_collective

            return mesh_collective.RingMeanFolder(self, n_elems, tile_elems, n_tiles, wire)
        return MeshMeanFolder(self, n_elems, tile_elems, n_tiles, wire)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so ranks compare by card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _enable_ring_peers(ranks: List[torch.device]) -> None:
    """Let each rank read its left neighbour's memory when the two are
    distinct cards (K6/K7 pull from the left); raises when they cannot."""
    from distributedvolunteercomputing_tpu_torch.ops import _build

    lib = _build.load_library()
    for d, dev in enumerate(ranks):
        left = ranks[d - 1]
        if left != dev:
            err = lib.dvc_enable_peer_access(dev.index, left.index)
            if err != 0:
                raise RuntimeError(
                    f"{dev} cannot read {left} over peer memory (CUDA error {err}: "
                    f"{lib.dvc_error_string(err).decode()}); the ring needs peer access"
                )


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

    The accumulator is element-split over the codec's ranks: rank r holds
    ``[n_tiles, shard]`` (``shard = tile_elems / nd``), the columns
    ``[r * shard, (r + 1) * shard)`` of every tile. Arriving wire chunks
    stage as raw bytes (no decode on the frame-reader thread) and fold in
    batches of ``FOLDER_FLUSH_BYTES``: one host-to-device copy of each rank's
    column slice of the batch, then, on the bf16 wire, one K5 launch per
    rank (``bf16_fold_chunks``; one per whole-tile group when the batch's
    chunk table does not fit one launch) that folds every chunk into its
    accumulator row ``acc_r[tile, :len]`` in staging order — the
    reference's ``a.at[t].add(w * widen(x))`` with duplicate tiles folded
    one after the other. The f32 wire and dense feeds are
    ``acc.add_(x, alpha=w)``. Per-tile weight tallies stay in the
    aggregator. ``result()`` flushes the tail and gathers the shards to the
    host. A failed fold raises (from the flush worker, so the aggregator's
    finalize fails the round)."""

    kind = "staged"

    def __init__(self, codec: MeshCodec, n_elems: int, tile_elems: int, n_tiles: int, wire: str):
        if wire not in ("f32", "bf16"):
            raise ValueError(f"mean folder needs an elementwise wire, got {wire!r}")
        if tile_elems % codec.nd:
            raise ValueError(f"tile_elems {tile_elems} does not split over {codec.nd} ranks")
        self.codec = codec
        self.n_elems = int(n_elems)
        self.tile_elems = int(tile_elems)
        self.n_tiles = int(n_tiles)
        self.nd = codec.nd
        self.shard = self.tile_elems // self.nd
        self.wire = wire
        self.esz = 4 if wire == "f32" else 2
        self._lock = threading.Lock()
        self._staged: List[Tuple[int, float, bytes]] = []
        self._staged_bytes = 0
        # High-water of raw wire bytes held between flushes (the aggregator
        # adds it to its peak-held gauge).
        self.peak_staged_bytes = 0
        self.flush_bytes = FOLDER_FLUSH_BYTES
        self._accs: Optional[List[torch.Tensor]] = None  # per rank [n_tiles, shard] f32, lazy
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
            if self.nd == 1:
                xs = [self.codec._put(buf)]
            else:
                x = np.zeros(self.n_tiles * self.tile_elems, np.float32)
                x[: self.n_elems] = buf
                x = x.reshape(self.n_tiles, self.tile_elems)
                xs = [self.codec._put(x[:, r * self.shard : (r + 1) * self.shard], r) for r in range(self.nd)]
            with self._lock:
                for acc, xr in zip(self._device_accs(), xs):
                    dst = acc.view(-1)[: self.n_elems] if self.nd == 1 else acc
                    dst.add_(xr, alpha=float(weight))

        self.codec._device(dev)

    # -- device plumbing ---------------------------------------------------

    def _device_accs(self) -> List[torch.Tensor]:
        if self._accs is None:
            self._accs = [
                torch.zeros((self.n_tiles, self.shard), dtype=torch.float32, device=dev)
                for dev in self.codec.ranks
            ]
        return self._accs

    # -- folding -----------------------------------------------------------

    def _pop_staged(self) -> List[Tuple[int, float, bytes]]:
        with self._lock:
            batch, self._staged = self._staged, []
            self._staged_bytes = 0
        return batch

    def _raw_rows(self, batch: List[Tuple[int, float, bytes]]) -> np.ndarray:
        """The batch as [k, tile_elems * esz] bytes, each chunk at the start
        of its own row (zero-padded), so every row is 16-byte aligned."""
        raw = np.zeros((len(batch), self.tile_elems * self.esz), np.uint8)
        for i, (_, _, data) in enumerate(batch):
            raw[i, : len(data)] = np.frombuffer(data, np.uint8)
        return raw

    def _flush_dev(self, batch: List[Tuple[int, float, bytes]]) -> None:
        """One copy of each rank's column slice of the batch to its device,
        then the fold: on the bf16 wire one K5 launch per rank for the whole
        batch, on the f32 wire one ``add_`` per chunk per rank, each in
        staging order."""
        rows = self._raw_rows(batch)
        width = self.shard * self.esz
        dtype = torch.int16 if self.wire == "bf16" else torch.float32
        parts = [self.codec._put(rows[:, r * width : (r + 1) * width], r).view(dtype) for r in range(self.nd)]
        tiles = [tile for tile, _, _ in batch]
        weights = [w for _, w, _ in batch]
        with self._lock:
            for r, acc in enumerate(self._device_accs()):
                lo = r * self.shard
                # Each chunk's columns within this rank's slice: a short tail
                # chunk may end before it.
                lens = [min(max(len(data) // self.esz - lo, 0), self.shard) for _, _, data in batch]
                if self.wire == "bf16":
                    bf16_fold_chunks(acc, parts[r], tiles, weights, lens, 0)
                else:
                    for i, (tile, w, n) in enumerate(zip(tiles, weights, lens)):
                        if n > 0:
                            acc[tile, :n].add_(parts[r][i, :n], alpha=w)

    def flush(self) -> None:
        """Fold every staged chunk (worker-thread context)."""
        batch = self._pop_staged()
        if not batch:
            return
        self.flushes += 1
        self.codec._device(lambda: self._flush_dev(batch))

    def _take_accs(self) -> Optional[List[torch.Tensor]]:
        with self._lock:
            accs, self._accs = self._accs, None
        return accs

    def result(self) -> np.ndarray:
        """Flush the tail and return the flat RAW accumulator [n_elems]
        (per-tile re-normalization stays with the aggregator)."""
        self.flush()
        accs = self._take_accs()
        if accs is None:
            return np.zeros(self.n_elems, np.float32)
        if self.nd == 1:
            return accs[0].view(-1)[: self.n_elems].cpu().numpy().copy()
        full = np.concatenate([a.cpu().numpy() for a in accs], axis=1)
        return full.reshape(-1)[: self.n_elems].copy()

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


def configure(
    device: DeviceLike = None, backend: str = "auto", mesh: Optional[Any] = None, collective: str = "auto"
) -> MeshCodec:
    """Select this volunteer's codec at startup, on its device (``None`` =
    the card) or its mesh's ranks. Builds the kernels when the codec resolves
    to CUDA devices, and enables peer access for a ring across cards."""
    global _default
    codec = MeshCodec(device=device, backend=backend, mesh=mesh, collective=collective)
    with _default_lock:
        _default = codec
    return codec


def reset() -> None:
    """Drop the process default (tests)."""
    global _default
    with _default_lock:
        _default = None

