"""Projection helpers of the span candidate index.

Counterpart of four functions of ``wembed_tpu/core/candidates.py``: the
doubling weight classes of the reference's weighted radius index
(src/embeddingLib/src/spacialQuery/WeightedIndex.cpp:51-63) and the power
iteration that finds the first two principal axes of centred rows, or the
first three.  Same arithmetic in the input's dtype: 12 iterations from the
perturbed all-ones start vector, then deflation and re-orthogonalisation
for each further axis; the covariance is a torch product, the rest one
launch of ``kernels/span_build.py:principal_axes`` (its plain version on
the CPU).  The span builds (``kernels/span_sparse.py:
build_span_structures``, ``kernels/span_compact.py:build_cell_structures``)
take the axes and projections from the positions in one call of
``kernels/span_build.py:principal_frame`` instead, whose mean and
covariance are pairwise trees.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import span_build


def doubling_weight_buckets(weights: np.ndarray, doubling_factor: float) -> np.ndarray:
    """Bucket thresholds min*f, min*f^2, ... < max
    (reference WeightedIndex.cpp:51-63)."""
    wmin, wmax = float(np.min(weights)), float(np.max(weights))
    buckets = []
    current = wmin * doubling_factor
    while current < wmax:
        buckets.append(current)
        current *= doubling_factor
    return np.asarray(buckets, dtype=np.float64)


def _principal_axes2(x_centered: torch.Tensor, iters: int = span_build.ITERS):
    """(v1, v2): the first two principal axes of centred rows — v1 by power
    iteration on the covariance, v2 by power iteration on the deflated
    covariance (cov - lambda1 v1 v1^T), re-orthogonalised against v1
    (``kernels/span_build.py:principal_axes``)."""
    v1, v2 = span_build.principal_axes(x_centered.T @ x_centered, 2, iters)
    return v1, v2


def _principal_axes3(x_centered: torch.Tensor, iters: int = span_build.ITERS):
    """(v1, v2, v3): ``_principal_axes2``'s two axes (the same operations,
    so the same bits) and a third by power iteration on the twice-deflated
    covariance (cov1 - lambda2 v2 v2^T), re-orthogonalised against v1 and
    v2.  The cell layout bins on v1 (rows) and v2 (cells) and sorts each
    cell by v3."""
    v1, v2, v3 = span_build.principal_axes(x_centered.T @ x_centered, 3, iters)
    return v1, v2, v3
