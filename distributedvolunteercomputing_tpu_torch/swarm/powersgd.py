"""PowerSGD low-rank gradient compression for the WAN wire.

Vogels et al., "PowerSGD: Practical Low-Rank Gradient Compression for
Distributed Optimization" (NeurIPS 2019): a gradient matrix M [n, m] is
shipped as the rank-r pair (P = MQ orthonormalized, Q' = MᵀP) — (n+m)·r
floats instead of n·m — with one warm-started power iteration per round, and
the truncation error handled by the same error-feedback residual the top-k
wire uses (``AveragerBase._commit_ef``).

Fit to this framework (reference parity: the GradientAverager's compressed
wire, SURVEY.md §2):

- The averager's WAN payloads are ONE flat f32 buffer per tree
  (utils/pytree.flatten_to_buffer). The codec re-views each >=2D leaf as a
  matrix (leading dims flattened), compresses those worth compressing, and
  ships small/1D leaves dense — self-describing container format, so the
  decoder needs no out-of-band schema.
- Unlike the original all-reduce formulation (which shares one Q across
  workers and averages P — brittle under volunteer churn, where a rejoiner
  has no synchronized Q), every contribution carries its own (P, Q') pair
  and the receiver reconstructs the DENSE rank-r estimate before
  aggregation. Linearity is not required, so this composes with the
  byzantine-robust estimators: reconstructions are dense vectors, exactly
  what krum/trimmed-mean/bulyan expect — something the sparse top-k wire
  cannot offer (robust stats over near-disjoint supports collapse to zero;
  see the averager's topk validation).
- Warm start: each encoder keeps its own Q per tensor across rounds; the
  power iteration then tracks the slowly-rotating top singular subspace of
  the gradient stream, which is what makes rank-4 usable in practice.

Host-side numpy throughout: WAN payload prep is host work by design (the
averager runs it off the event loop in worker threads), and n·m·r matmuls
at WAN cadence are BLAS-cheap next to the round's network time.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Container magic. Bump the suffix on any layout change: the magic is the
# only cross-peer versioning (payloads also sit behind the averager's
# schema hash, which folds in the wire tag + rank).
MAGIC = b"PSG1"
_DENSE = 0
_LOWRANK = 1


def _orthonormalize(a: np.ndarray) -> np.ndarray:
    """Thin-QR orthonormal basis of a's columns (f32, [n, r])."""
    q, _ = np.linalg.qr(a.astype(np.float32, copy=False))
    return np.ascontiguousarray(q, dtype=np.float32)


class PowerSGDCodec:
    """Stateful encoder / stateless decoder for one averager's buffers.

    ``specs`` is the averager's TensorSpec list (shapes of the flat
    buffer's leaves, in order). ``rank`` is the target rank; tensors where
    low-rank wouldn't save bytes (1D leaves, tiny matrices) ship dense.
    """

    def __init__(self, specs: Sequence, rank: int = 4, seed: int = 0, mesh_codec=None):
        if rank < 1:
            raise ValueError(f"powersgd rank must be >= 1, got {rank}")
        self.rank = int(rank)
        self.seed = int(seed)
        # On-mesh power iteration (ops.mesh_codec): the per-tensor
        # QR(M·Q) / MᵀP matmuls run on the volunteer's local device mesh
        # when the codec is active; None/inactive keeps host BLAS.
        self.mesh_codec = mesh_codec
        # Per-leaf plan: (offset, size, (n, m, r_eff) | None). A leaf is
        # compressed as [n=prod(shape[:-1]), m=shape[-1]] when that strictly
        # saves floats at its effective rank.
        self.plan: List[Tuple[int, int, Optional[Tuple[int, int, int]]]] = []
        off = 0
        for spec in specs:
            size = spec.size
            lowrank = None
            if len(spec.shape) >= 2 and size > 0:
                m = int(spec.shape[-1])
                n = size // m
                r = min(self.rank, n, m)
                if (n + m) * r < n * m:
                    lowrank = (n, m, r)
            self.plan.append((off, size, lowrank))
            off += size
        self.total = off
        self._warm_q: Dict[int, np.ndarray] = {}

    # -- encode ------------------------------------------------------------

    def _init_q(self, idx: int, m: int, r: int) -> np.ndarray:
        q = self._warm_q.get(idx)
        if q is not None and q.shape == (m, r):
            return _orthonormalize(q)
        rng = np.random.default_rng((self.seed * 1_000_003 + idx) & 0x7FFFFFFF)
        return _orthonormalize(rng.standard_normal((m, r)).astype(np.float32))

    def encode(self, buf: np.ndarray) -> bytes:
        """One warm-started power iteration per planned tensor; updates the
        warm Q state. Returns the self-describing container."""
        if buf.size != self.total:
            raise ValueError(f"buffer size {buf.size} != plan total {self.total}")
        parts = [MAGIC, struct.pack("<I", len(self.plan))]
        for idx, (off, size, lowrank) in enumerate(self.plan):
            chunk = buf[off : off + size]
            if lowrank is None:
                parts.append(struct.pack("<BI", _DENSE, size))
                parts.append(np.ascontiguousarray(chunk, np.float32).tobytes())
                continue
            n, m, r = lowrank
            mat = chunk.reshape(n, m)
            q = self._init_q(idx, m, r)
            mc = self.mesh_codec
            if mc is not None and mc.active:
                p, q_new = mc.low_rank_iterate(mat, q)
            else:
                p = _orthonormalize(mat @ q)  # [n, r]
                q_new = mat.T @ p  # [m, r] — NOT orthonormalized (carries scale)
            self._warm_q[idx] = q_new
            parts.append(struct.pack("<BIIH", _LOWRANK, n, m, r))
            parts.append(p.tobytes())
            parts.append(np.ascontiguousarray(q_new, np.float32).tobytes())
        return b"".join(parts)

    def encode_dense(self, buf: np.ndarray) -> bytes:
        """The same container with every tensor dense — used for round
        RESULTS, which must carry no extra truncation error (no error
        feedback exists on the result path; mirrors the top-k wire's
        dense-results policy)."""
        if buf.size != self.total:
            raise ValueError(f"buffer size {buf.size} != plan total {self.total}")
        return b"".join(
            [
                MAGIC,
                struct.pack("<I", 1),
                struct.pack("<BI", _DENSE, buf.size),
                np.ascontiguousarray(buf, np.float32).tobytes(),
            ]
        )


def _parse_entries(
    payload: bytes, max_floats: Optional[int] = None
) -> List[Tuple[int, tuple]]:
    """[(kind, data)] per entry: dense -> (values,), lowrank -> (n, m, r, P, Q).

    Raises ValueError on ANY malformation (including short reads, which
    struct/numpy report as their own exception types) — the averagers'
    round error containment catches ValueError, and a malicious payload
    must never escape it.

    ``max_floats`` bounds the CUMULATIVE dense-reconstruction size of the
    parsed entries — a low-rank entry counts as its n·m expansion, not its
    (n+m)·r wire floats — and it is enforced HERE, per entry as the walk
    advances, so every consumer of the parse (decode's reconstruction,
    merge's Q·Rᵀ densification) inherits the same resource-exhaustion
    guard. A hostile entry past the cap is rejected before any n·m
    intermediate exists."""
    if len(payload) < 8 or payload[:4] != MAGIC:
        raise ValueError("not a powersgd payload (bad magic)")
    out: List[Tuple[int, tuple]] = []
    total = 0
    try:
        (count,) = struct.unpack_from("<I", payload, 4)
        off = 8
        for _ in range(count):
            (kind,) = struct.unpack_from("<B", payload, off)
            if kind == _DENSE:
                (size,) = struct.unpack_from("<I", payload, off + 1)
                off += 5
                total += size
                if max_floats is not None and total > max_floats:
                    raise ValueError(
                        f"powersgd payload reconstructs to >{max_floats} floats "
                        f"(resource-exhaustion guard)"
                    )
                out.append(
                    (kind, (np.frombuffer(payload, np.float32, count=size, offset=off),))
                )
                off += size * 4
            elif kind == _LOWRANK:
                n, m, r = struct.unpack_from("<IIH", payload, off + 1)
                off += 11
                total += n * m
                if max_floats is not None and total > max_floats:
                    raise ValueError(
                        f"powersgd payload reconstructs to >{max_floats} floats "
                        f"(resource-exhaustion guard)"
                    )
                p = np.frombuffer(payload, np.float32, count=n * r, offset=off).reshape(n, r)
                off += n * r * 4
                q = np.frombuffer(payload, np.float32, count=m * r, offset=off).reshape(m, r)
                off += m * r * 4
                out.append((kind, (n, m, r, p, q)))
            else:
                raise ValueError(f"unknown powersgd entry kind {kind}")
    except struct.error as err:  # short read past the payload end
        raise ValueError(f"malformed powersgd payload: {err}") from err
    except ValueError as err:  # numpy short frombuffer, bad kind, bad reshape
        raise ValueError(f"malformed powersgd payload: {err}") from err
    if off != len(payload):
        raise ValueError(f"trailing bytes in powersgd payload ({len(payload) - off})")
    return out


# Absolute reconstruction ceiling when the receiver doesn't yet know its
# schema (early pushes before the first pack): 2^29 floats = 2 GiB, matching
# the transport's MAX_PAYLOAD for a dense f32 frame. A low-rank entry
# RECONSTRUCTS to n*m floats from only (n+m)*r on the wire, so without a cap
# a 400 KB container declaring n=m=50000 would allocate 10 GB on decode.
MAX_DECODE_FLOATS = 1 << 29


def decode(
    payload: bytes, max_floats: int = MAX_DECODE_FLOATS, mesh_codec=None
) -> np.ndarray:
    """Reconstruct the flat f32 buffer. Self-describing: no specs needed,
    so receivers can decode contributions that arrive before their own
    first pack (the averager accepts early pushes by design).

    ``max_floats`` bounds the TOTAL reconstruction size — callers that know
    their schema pass the exact expected size, so an attacker can't buy a
    multi-GB allocation with a few-KB container (low-rank entries expand
    (n+m)*r wire floats into n*m). The bound is enforced inside
    ``_parse_entries``, per entry, BEFORE any reconstruction intermediate
    is allocated. ``mesh_codec`` (ops.mesh_codec, when active) runs the
    P·Qᵀ reconstruction matmuls on the local device mesh."""
    entries = _parse_entries(payload, max_floats)
    out: List[np.ndarray] = []
    for kind, data in entries:
        if kind == _DENSE:
            out.append(data[0].copy())
        else:
            _, _, _, p, q = data
            if mesh_codec is not None and mesh_codec.active:
                out.append(mesh_codec.lowrank_reconstruct(p, q))
            else:
                out.append((p @ q.T).ravel())
    return np.concatenate(out) if out else np.zeros((0,), np.float32)


def merge(
    weighted_payloads: Sequence[Tuple[float, bytes]],
    max_floats: int = MAX_DECODE_FLOATS,
) -> bytes:
    """The EXACT weighted mean of powersgd payloads, as a powersgd payload.

    By linearity, mean_i(w_i · P_i Q_iᵀ) == P_cat Q_catᵀ where P_cat stacks
    the (w_i/Σw)-scaled P_i columns and Q_cat stacks the Q_i columns — so a
    sync leader can serve the round RESULT in factored form with no new
    truncation error (the dense-results policy exists to avoid uncorrected
    error; a factored EXACT mean needs no such correction). Per tensor, the
    factored form is kept only while it beats dense bytes (concatenated rank
    k·r approaches n·m at large groups); dense entries and oversized
    concatenations are merged densely. Only meaningful for method='mean' —
    robust estimators are nonlinear, and the caller keeps dense results.

    ``max_floats`` bounds EACH payload's dense-reconstruction size (the
    mixed-kind fallback below densifies low-rank entries via P·Qᵀ): the
    sync leader merges containers received from the wire, so an entry
    declaring a huge n·m must be rejected at parse, exactly as in decode.
    """
    if not weighted_payloads:
        raise ValueError("merge of zero payloads")
    total_w = float(sum(w for w, _ in weighted_payloads))
    if total_w <= 0:
        raise ValueError(f"non-positive total weight {total_w}")
    parsed = [
        (w / total_w, _parse_entries(p, max_floats)) for w, p in weighted_payloads
    ]
    n_entries = len(parsed[0][1])
    if any(len(entries) != n_entries for _, entries in parsed):
        raise ValueError("powersgd merge: payloads disagree on entry count")
    parts = [MAGIC, struct.pack("<I", n_entries)]
    for i in range(n_entries):
        col = [(w, entries[i]) for w, entries in parsed]
        if all(kind == _LOWRANK for _, (kind, _) in col):
            n, m = col[0][1][1][0], col[0][1][1][1]
            if any((d[0], d[1]) != (n, m) for _, (_, d) in col):
                raise ValueError("powersgd merge: lowrank shape mismatch")
            r_cat = sum(d[2] for _, (_, d) in col)
            if (n + m) * r_cat < n * m and r_cat <= 0xFFFF:
                p_cat = np.concatenate(
                    [np.float32(w) * d[3] for w, (_, d) in col], axis=1
                )
                q_cat = np.concatenate([d[4] for _, (_, d) in col], axis=1)
                parts.append(struct.pack("<BIIH", _LOWRANK, n, m, r_cat))
                parts.append(np.ascontiguousarray(p_cat, np.float32).tobytes())
                parts.append(np.ascontiguousarray(q_cat, np.float32).tobytes())
                continue
        # Mixed kinds / dense / oversized concat: weighted-sum densely.
        acc = None
        for w, (kind, d) in col:
            dense = d[0].astype(np.float32) if kind == _DENSE else (d[3] @ d[4].T).ravel()
            acc = np.float32(w) * dense if acc is None else acc + np.float32(w) * dense
        parts.append(struct.pack("<BI", _DENSE, acc.size))
        parts.append(np.ascontiguousarray(acc, np.float32).tobytes())
    return b"".join(parts)
