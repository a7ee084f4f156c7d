"""Vertex weight construction and rescaling.

Counterpart of ``wembed_tpu/core/weights.py``; reference semantics:
  * degree weights clamp degree-0 vertices to 1
    (reference NewWEmbedEmbedder.cpp:394-401)
  * rescale applies the dimension-hint power w^(d/hint) FIRST, then
    normalizes to mean 1 (NewWEmbedEmbedder.cpp:370-392)
  * the embedder caches invExpWeights = w^(-1/d)
    (NewWEmbedEmbedder.cpp:148-152)
"""

from __future__ import annotations

import numpy as np

from ..graphs.csr import CSRGraph
from .options import EmbedderOptions, WeightType


def degree_weights(g: CSRGraph) -> np.ndarray:
    return np.maximum(g.degrees.astype(np.float64), 1.0)


def unit_weights(n: int) -> np.ndarray:
    return np.ones(n, dtype=np.float64)


def rescale_weights(
    dimension_hint: float, embedding_dimension: int, weights: np.ndarray
) -> np.ndarray:
    w = np.asarray(weights, dtype=np.float64)
    if dimension_hint > 0:
        w = w ** (float(embedding_dimension) / float(dimension_hint))
    return w * (w.shape[0] / w.sum())


def initial_weights(g: CSRGraph, opts: EmbedderOptions) -> np.ndarray:
    """Weights as set by the NewWEmbedEmbedder constructor
    (reference NewWEmbedEmbedder.hpp:47-77)."""
    if opts.weight_type is WeightType.DEGREE:
        return rescale_weights(
            opts.dimension_hint, opts.embedding_dimension, degree_weights(g)
        )
    if opts.weight_type is WeightType.UNIT:
        return unit_weights(g.num_vertices)
    raise ValueError(f"weight type {opts.weight_type} needs explicit weights")


def inv_exp_weights(weights: np.ndarray, dim: int) -> np.ndarray:
    """w^(-1/d) — the per-vertex factor of the weighted distance."""
    return np.asarray(weights, dtype=np.float64) ** (-1.0 / dim)
