"""Edge-detection quality: best-threshold precision/recall/F1.

Counterpart of ``wembed_tpu/eval/edge_detection.py`` (numpy, the same
random draws in the same order): a vectorized re-design of the reference's
EdgeSampler/EdgeDetection
(reference: src/evaluationLib/src/metrics/EdgeSampler.cpp:7-63,
EdgeDetection.cpp:6-73): build a histogram of similarities over all edges
plus randomly sampled non-edges, sweep the sorted histogram for the
threshold maximizing F1.

The non-edge sample count follows the reference's expectation
(each non-edge kept with probability min(1, scale*M/noM)); pairs are drawn
by uniform rejection instead of geometric jumps — same distribution,
vectorized.
"""

from __future__ import annotations

import numpy as np

from ..graphs.csr import CSRGraph
from .spaces import Space


def sample_histogram(
    g: CSRGraph,
    space: Space,
    sampling_scale: float = 10.0,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Returns (similarities, is_edge flags — both sorted by similarity,
    num_edges_sampled, num_non_edges_sampled)."""
    rng = rng or np.random.default_rng()
    n = g.num_vertices
    m = g.num_edges
    max_m = n * (n - 1) // 2
    no_m = max_m - m

    el = g.edge_list()
    edge_sims = space.pairs(el[:, 0], el[:, 1])

    p = min(1.0, sampling_scale * m / no_m) if no_m > 0 else 0.0
    target = rng.binomial(no_m, p) if no_m > 0 else 0
    non_pairs = _sample_non_edges(g, target, rng)
    non_sims = space.pairs(non_pairs[:, 0], non_pairs[:, 1])

    sims = np.concatenate([edge_sims, non_sims])
    flags = np.concatenate(
        [np.ones(edge_sims.shape[0], bool), np.zeros(non_sims.shape[0], bool)]
    )
    order = np.argsort(sims, kind="stable")
    return sims[order], flags[order], edge_sims.shape[0], non_sims.shape[0]


def _sample_non_edges(g: CSRGraph, count: int, rng: np.random.Generator) -> np.ndarray:
    """Uniformly sample ``count`` distinct unordered non-edge pairs.

    Fully vectorized: rejection by ``searchsorted`` against the sorted
    edge-key array and ``np.isin``/``np.unique`` dedup — no per-element
    Python set membership.  Emits a warning if the target count cannot be
    reached (dense graphs where non-edges are scarce)."""
    n = g.num_vertices
    got: list[np.ndarray] = []
    seen = np.empty(0, dtype=np.int64)  # sorted keys already taken
    total = 0
    attempts = 0
    over = 1.4  # adaptive oversampling: doubles when a round yields < 50%,
    # so the number of rounds (each paying an O(|seen|) union) stays
    # logarithmic even on dense graphs with high rejection rates
    while total < count and attempts < 50:
        attempts += 1
        k = int((count - total) * over) + 16
        a = rng.integers(0, n, size=k)
        b = rng.integers(0, n, size=k)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        ok = lo != hi
        lo, hi = lo[ok], hi[ok]
        keys = lo.astype(np.int64) * n + hi
        if g.edge_keys.shape[0] > 0:
            pos = np.searchsorted(g.edge_keys, keys)
            pos = np.minimum(pos, g.edge_keys.shape[0] - 1)
            ok = g.edge_keys[pos] != keys
            lo, hi, keys = lo[ok], hi[ok], keys[ok]
        if seen.shape[0] > 0:
            ok = ~np.isin(keys, seen, assume_unique=False)
            lo, hi, keys = lo[ok], hi[ok], keys[ok]
        # dedupe within batch
        keys, idx = np.unique(keys, return_index=True)
        lo, hi = lo[idx], hi[idx]
        take = min(count - total, lo.shape[0])
        got.append(np.stack([lo[:take], hi[:take]], axis=1))
        seen = np.union1d(seen, keys[:take])
        total += take
        if take * 2 < k:
            over = min(over * 2.0, 64.0)
    if total < count:
        import warnings

        warnings.warn(
            f"non-edge sampling undersampled: got {total} of {count} requested "
            f"pairs after {attempts} rounds (graph too dense?); edge-detection "
            "metrics will extrapolate from the smaller sample",
            stacklevel=2,
        )
    if not got:
        return np.empty((0, 2), dtype=np.int64)
    return np.concatenate(got, axis=0)


def edge_detection_metrics(
    g: CSRGraph,
    space: Space,
    sampling_scale: float = 10.0,
    rng: np.random.Generator | None = None,
) -> dict[str, float]:
    """Best-F1 threshold sweep (EdgeDetection.cpp:6-73): estimates
    population-level TP/FP from sampled fractions, exactly as the
    reference extrapolates wrongEdgesPercent/wrongNonEdgesPercent."""
    n = g.num_vertices
    m = g.num_edges
    no_m = n * (n - 1) // 2 - m

    _, flags, num_edges, num_non = sample_histogram(g, space, sampling_scale, rng)
    if flags.size == 0 or num_edges == 0:
        return {"precision": 0.0, "recall": 0.0, "edgeF1": 0.0}

    cum_edges = np.cumsum(flags)
    cum_non = np.cumsum(~flags)
    tp = (cum_edges / num_edges) * m
    fp = (cum_non / max(num_non, 1)) * no_m
    retrieved = tp + fp
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(retrieved > 0, tp / retrieved, 0.0)
        recall = tp / m
        f1 = np.where(precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0)
    best = int(np.argmax(f1))
    return {
        "precision": float(precision[best]),
        "recall": float(recall[best]),
        "edgeF1": float(f1[best]),
    }
