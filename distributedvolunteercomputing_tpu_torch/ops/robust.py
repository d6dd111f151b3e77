"""Robust (Byzantine-tolerant) aggregation — host-side numpy.

Reference parity: "Byzantine-tolerant aggregation" (BASELINE.json:5,:11),
prescribed to stay on host (BASELINE.json:5 "Keep the coordinator/DHT
peer-discovery and Byzantine-tolerant aggregation on the host"). Inputs are
the flattened float32 param buffers from utils.pytree — one row per peer.

Estimators (standard robust-aggregation menu, cf. Krum/trimmed-mean
literature):
- mean            — baseline (not robust), supports per-peer weights
- coordinate median — breaks down at 50% adversaries, cheap
- trimmed mean    — drop the b largest/smallest per coordinate
- krum            — select the contribution closest to its n-f-2 neighbours
- geometric median — Weiszfeld iterations, strong + smooth
- bulyan          — Multi-Krum selection then per-coordinate trimmed mean
                    over the selected set (El Mhamdi et al.): Krum's
                    selection bounds WHO aggregates, the trim bounds each
                    COORDINATE — defends the leeway a single Krum pick
                    leaves in high dimensions
- centered_clip   — iterative L2-clipped averaging (Karimireddy et al.):
                    bounds each peer's PULL in L2 per iteration, closing
                    the spread-over-many-coordinates evasion that
                    coordinate-wise trims leave open

All run in O(n^2 D) worst case (krum/geomedian) with n = volunteers in the
round (reference scale: 4, BASELINE.json:2) — cheap next to the WAN transfer
(SURVEY.md §7 hard part d).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def mean(stack: np.ndarray, weights: Optional[np.ndarray] = None) -> np.ndarray:
    if weights is None:
        return stack.mean(axis=0)
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    return (stack * w[:, None].astype(stack.dtype)).sum(axis=0)


# Below this size the numpy paths win (thread spawn isn't free); above it the
# native threaded column-sort beats numpy's full-matrix sort ~2x.
_NATIVE_CUTOFF = 1 << 16


def coordinate_median(stack: np.ndarray) -> np.ndarray:
    if stack.dtype == np.float32 and stack.size >= _NATIVE_CUTOFF:
        from distributedvolunteercomputing_tpu_torch import native

        if native.available():
            return native.coordinate_median(np.ascontiguousarray(stack))
    return np.median(stack, axis=0).astype(stack.dtype)


def trimmed_mean(stack: np.ndarray, trim: int = 1) -> np.ndarray:
    n = stack.shape[0]
    if 2 * trim >= n:
        raise ValueError(f"trim={trim} too large for n={n}")
    if stack.dtype == np.float32 and stack.size >= _NATIVE_CUTOFF:
        from distributedvolunteercomputing_tpu_torch import native

        if native.available():
            return native.trimmed_mean(np.ascontiguousarray(stack), trim)
    srt = np.sort(stack, axis=0)
    return srt[trim : n - trim].mean(axis=0)


def pairwise_sq_dists(stack: np.ndarray) -> np.ndarray:
    """[n, n] pairwise squared L2 distances between rows. d² is a plain sum
    over coordinates, which is what lets the streaming leader accumulate it
    tile-by-tile as contributions arrive (swarm/agg_stream.py) instead of
    paying the O(n²·D) pass at commit time."""
    return ((stack[:, None, :] - stack[None, :, :]) ** 2).sum(axis=-1)


def _krum_scores(d2: np.ndarray, n_byzantine: int) -> np.ndarray:
    """Krum score per row of a pairwise squared-distance matrix: sum of the
    m - f - 2 smallest neighbour distances (clamped to >= 1 defensively —
    at zero neighbours every score is 0.0 and selection degrades to an
    arbitrary index-order pick)."""
    m = d2.shape[0]
    d2 = d2.copy()
    np.fill_diagonal(d2, np.inf)
    n_neighbors = max(m - n_byzantine - 2, 1)
    return np.sort(d2, axis=1)[:, :n_neighbors].sum(axis=1)


def krum(
    stack: np.ndarray,
    n_byzantine: int = 1,
    multi: int = 1,
    d2: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(Multi-)Krum: average the ``multi`` contributions with the smallest
    sum of squared distances to their n - f - 2 nearest neighbours.
    ``d2`` may carry a precomputed pairwise squared-distance matrix (the
    streaming leader accumulates it tile-wise during arrival)."""
    n = stack.shape[0]
    if n < n_byzantine + 3:
        # Not enough honest mass for Krum's guarantee; degrade to median.
        return coordinate_median(stack)
    if d2 is None or d2.shape != (n, n):
        d2 = pairwise_sq_dists(stack)
    scores = _krum_scores(d2, n_byzantine)
    chosen = np.argsort(scores)[:multi]
    return stack[chosen].mean(axis=0)


def geometric_median(stack: np.ndarray, iters: int = 32, eps: float = 1e-8) -> np.ndarray:
    """Weiszfeld algorithm; robust to <50% arbitrary corruption.

    Starts from the coordinate median, not the mean: a mean start under large
    outliers puts z so far out that convergence needs many more iterations.
    """
    z = coordinate_median(stack).astype(np.float64)
    for _ in range(iters):
        dist = np.linalg.norm(stack - z[None, :], axis=1)
        dist = np.maximum(dist, eps)
        w = 1.0 / dist
        z_new = (stack * w[:, None]).sum(axis=0) / w.sum()
        if np.linalg.norm(z_new - z) < eps * (1 + np.linalg.norm(z)):
            z = z_new
            break
        z = z_new
    return z.astype(stack.dtype)


def bulyan(
    stack: np.ndarray, n_byzantine: int = 1, d2: Optional[np.ndarray] = None
) -> np.ndarray:
    """Bulyan (El Mhamdi, Guerraoui, Rouault 2018): Multi-Krum repeatedly
    SELECTS the n - 2f contributions closest to their neighbour sets, then a
    per-coordinate trimmed mean (trim f) over the selected set. Needs
    n >= 4f + 3 for its guarantee; below that it degrades to the geometric
    median (the strongest estimator that stays sound at small n), matching
    krum's small-n degradation policy."""
    n = stack.shape[0]
    f = n_byzantine
    if n < 4 * f + 3:
        return geometric_median(stack)
    if d2 is not None and d2.shape != (n, n):
        d2 = None
    # Single-pass Multi-Krum selection: score once on the full set (with
    # n >= 4f + 3 the neighbour count is n - f - 2 >= 3f + 1, never
    # degenerate) and keep the n - 2f best. Iterative select-remove-rescore
    # — the other common formulation — degenerates at its late iterations
    # (m shrinks to f + 2 where the neighbour count hits zero, and the
    # 1-NN clamp then ties symmetric pairs exactly, making the selected
    # SET depend on peer row order; observed before this was changed).
    if d2 is None:
        d2 = pairwise_sq_dists(stack)
    selected = np.argsort(_krum_scores(d2, f))[: n - 2 * f]
    chosen = stack[selected]
    # Bulyan's second phase: per coordinate, keep the (n - 2f) - 2f values
    # closest to the coordinate median of the selected set and average them
    # (El Mhamdi et al.'s beta = theta - 2f).
    med = np.median(chosen, axis=0)
    order = np.argsort(np.abs(chosen - med[None, :]), axis=0)
    keep = order[: len(selected) - 2 * f]
    return np.take_along_axis(chosen, keep, axis=0).mean(axis=0).astype(stack.dtype)


def centered_clip(
    stack: np.ndarray,
    clip_tau: float = 0.0,
    iters: int = 5,
) -> np.ndarray:
    """CenteredClip (Karimireddy, He, Jaggi 2021, "Learning from History
    for Byzantine Robust Optimization"): iterate
        v <- v + mean_i( clip(x_i - v, tau) )
    where clip rescales each peer's deviation to norm <= tau. Honest
    contributions near the center pass through untouched; a byzantine row's
    pull is bounded by tau per iteration REGARDLESS of its magnitude — and
    unlike coordinate-wise trims, the bound is in L2, so a colluding
    attacker can't hide a large vector behind many small coordinates.

    ``clip_tau=0`` (the default) self-tunes per iteration to the median
    peer deviation norm — the scale-free variant: honest radii pass,
    outliers clip. Starts from the coordinate median (a robust seed rather
    than the mean, which an unbounded row could drag arbitrarily before
    the first clip)."""
    if iters < 1:
        raise ValueError(f"centered_clip iters must be >= 1, got {iters}")
    if clip_tau < 0:
        raise ValueError(f"clip_tau must be >= 0, got {clip_tau}")
    # Drop non-finite rows FIRST: an inf deviation would clip to scale 0 but
    # inf * 0 = NaN, and the unclipped mean would adopt it — a single
    # inf-filled byzantine row must cost its sender influence, not poison
    # the aggregate (the coordinate-wise estimators survive this input; the
    # L2 form must too).
    finite = np.isfinite(stack).all(axis=1)
    if not finite.all():
        if not finite.any():
            return np.zeros(stack.shape[1], stack.dtype)
        stack = stack[finite]
    v = np.median(stack, axis=0)
    for _ in range(iters):
        dev = stack - v[None, :]
        norms = np.sqrt((dev * dev).sum(axis=1))
        tau = clip_tau if clip_tau > 0 else max(float(np.median(norms)), 1e-12)
        scale = np.minimum(1.0, tau / np.maximum(norms, 1e-12))
        v = v + (dev * scale[:, None]).mean(axis=0)
    return v.astype(stack.dtype)


AGGREGATORS = {
    "mean": mean,
    "median": coordinate_median,
    "trimmed_mean": trimmed_mean,
    "krum": krum,
    "geometric_median": geometric_median,
    "bulyan": bulyan,
    "centered_clip": centered_clip,
}


def aggregate(stack: np.ndarray, method: str = "mean", **kw) -> np.ndarray:
    if method not in AGGREGATORS:
        raise KeyError(f"unknown aggregator {method!r}; known: {sorted(AGGREGATORS)}")
    if stack.ndim != 2:
        raise ValueError(f"expected [n_peers, D] stack, got shape {stack.shape}")
    return AGGREGATORS[method](stack, **kw)


# -- streaming / tiled aggregation support (swarm/agg_stream.py) ------------
#
# How each estimator decomposes over a column partition (tiles), which is
# what decides the leader's streaming mode and its memory bound:
#
# - "mean":     linear — accumulate w·x per tile, O(D) total state.
# - "window":   COORDINATE-WISE estimators (per-coordinate sort/median/trim
#               touch no other coordinate), so aggregating each [n, tile]
#               window independently is EXACTLY the dense result — only the
#               in-flight window is held, O(n·tile).
# - "d2_dense": selection needs full vectors, but the selection STATISTIC
#               (pairwise d²) is a sum over coordinates and accumulates
#               tile-by-tile; rows stay dense, the O(n²·D) distance pass
#               overlaps arrival.
# - "dense":    genuinely coupled across coordinates (Weiszfeld's per-row
#               L2 norms, centered_clip's full-vector clip radii): tiling
#               would change the estimator, so these keep the dense path.
_TILE_MODES = {
    "mean": "mean",
    "median": "window",
    "trimmed_mean": "window",
    "krum": "d2_dense",
    "bulyan": "d2_dense",
    "geometric_median": "dense",
    "centered_clip": "dense",
}


def tile_mode(method: str) -> str:
    """Streaming decomposition class for ``method`` (see table above);
    unknown methods conservatively report "dense"."""
    return _TILE_MODES.get(method, "dense")
