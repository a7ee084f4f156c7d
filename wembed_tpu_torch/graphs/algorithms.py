"""Host-side graph algorithms, numpy only.

Counterpart of the two functions of ``wembed_tpu/graphs/algorithms.py``
that the GIRG generator needs (reference GraphAlgo,
src/graphLib/src/graph/GraphAlgorithms.cpp:12-99): connected components by
label propagation and the largest component with its vertex mapping.  Same
arithmetic, so the same graph comes out.
"""

from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges


def connected_components(g: CSRGraph) -> tuple[np.ndarray, np.ndarray]:
    """Component id per vertex + component sizes.

    Pointer-jumping label propagation replacing the reference's BFS
    (GraphAlgorithms.cpp:12-60).  Returns (component_id (n,) int64, ids
    compacted in order of each component's smallest vertex, sizes (k,)
    int64)."""
    n = g.num_vertices
    labels = np.arange(n, dtype=np.int64)
    if n == 0:
        return labels, np.empty(0, dtype=np.int64)
    src, dst = g.edge_src.astype(np.int64), g.col_idx.astype(np.int64)
    while True:
        # propagate the min label across each edge, then pointer-jump
        neighbor_min = labels.copy()
        np.minimum.at(neighbor_min, src, labels[dst])
        neighbor_min = np.minimum(neighbor_min, neighbor_min[neighbor_min])
        if np.array_equal(neighbor_min, labels):
            break
        labels = neighbor_min
    _, compact = np.unique(labels, return_inverse=True)
    sizes = np.bincount(compact)
    return compact.astype(np.int64), sizes.astype(np.int64)


def largest_component_with_mapping(g: CSRGraph) -> tuple[CSRGraph, np.ndarray]:
    """Largest connected component relabeled to 0..k-1.

    Returns (subgraph, mapping new_id -> old_id), matching
    getLargestComponentWithMapping (GraphAlgorithms.cpp:62-99)."""
    comp, sizes = connected_components(g)
    if sizes.shape[0] == 0:
        return g, np.empty(0, dtype=np.int64)
    keep = np.flatnonzero(comp == np.argmax(sizes))
    old_to_new = -np.ones(g.num_vertices, dtype=np.int64)
    old_to_new[keep] = np.arange(keep.shape[0])
    src, dst = g.edge_src, g.col_idx
    mask = (old_to_new[src] >= 0) & (src < dst)
    sub = from_edges(
        np.stack([old_to_new[src[mask]], old_to_new[dst[mask]]], axis=1),
        num_vertices=keep.shape[0],
    )
    return sub, keep
