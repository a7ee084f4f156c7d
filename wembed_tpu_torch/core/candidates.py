"""Projection helpers of the span candidate index.

Counterpart of four functions of ``wembed_tpu/core/candidates.py``: the
doubling weight classes of the reference's weighted radius index
(src/embeddingLib/src/spacialQuery/WeightedIndex.cpp:51-63) and the power
iteration that finds the first two principal axes the windowed span
structures project on (``kernels/span_sparse.py:build_span_structures``),
or the first three for the cell layout
(``kernels/span_compact.py:build_cell_structures``).  Same arithmetic in
the input's dtype: 12 iterations from the perturbed all-ones start vector,
then deflation and re-orthogonalisation for each further axis.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _power_iteration(cov: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Dominant eigenvector of a (d, d) PSD matrix by power iteration."""
    d = cov.shape[0]
    # the perturbed all-ones start; a Python scalar, so no host-to-device copy
    v = torch.full((d,), 1.0, dtype=cov.dtype, device=cov.device) + torch.arange(
        d, dtype=cov.dtype, device=cov.device
    ) * 1e-3
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = cov @ v
        norm = torch.linalg.vector_norm(w)
        # a zero iterate keeps the previous vector, without a host branch
        v = torch.where(norm > 0, w / torch.where(norm > 0, norm, 1.0), v)
    return v


def _normalised(v: torch.Tensor) -> torch.Tensor:
    """``v`` over its norm, or ``v`` itself when the norm is at most 1e-12
    (a degenerate axis, as at d < 3 for the third)."""
    norm = torch.linalg.vector_norm(v)
    return torch.where(norm > 1e-12, v / torch.where(norm > 0, norm, 1.0), v)


def _principal_axes2(x_centered: torch.Tensor, iters: int = 12):
    """(v1, v2): the first two principal axes of centred rows — v1 by power
    iteration on the covariance, v2 by power iteration on the deflated
    covariance (cov - lambda1 v1 v1^T), re-orthogonalised against v1."""
    v1, v2, _ = _deflated_axes(x_centered, iters)
    return v1, v2


def _principal_axes3(x_centered: torch.Tensor, iters: int = 12):
    """(v1, v2, v3): ``_principal_axes2``'s two axes (the same operations,
    so the same bits) and a third by power iteration on the twice-deflated
    covariance (cov1 - lambda2 v2 v2^T), re-orthogonalised against v1 and
    v2.  The cell layout bins on v1 (rows) and v2 (cells) and sorts each
    cell by v3."""
    v1, v2, cov1 = _deflated_axes(x_centered, iters)
    lam2 = v2 @ (cov1 @ v2)
    v3 = _power_iteration(cov1 - lam2 * torch.outer(v2, v2), iters)
    v3 = _normalised(v3 - (v3 @ v1) * v1 - (v3 @ v2) * v2)
    return v1, v2, v3


def _deflated_axes(x_centered: torch.Tensor, iters: int):
    """(v1, v2, cov - lambda1 v1 v1^T) of centred rows."""
    cov = x_centered.T @ x_centered  # (d, d)
    v1 = _power_iteration(cov, iters)
    lam1 = v1 @ (cov @ v1)
    cov1 = cov - lam1 * torch.outer(v1, v1)
    v2 = _power_iteration(cov1, iters)
    v2 = _normalised(v2 - (v2 @ v1) * v1)
    return v1, v2, cov1
