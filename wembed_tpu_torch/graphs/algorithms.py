"""Host-side graph algorithms, numpy only.

Counterpart of the functions of ``wembed_tpu/graphs/algorithms.py`` that
the GIRG generator and the multilevel hierarchy need (reference GraphAlgo,
src/graphLib/src/graph/GraphAlgorithms.cpp:12-143): connected components by
label propagation, the largest component with its vertex mapping, and the
contraction of a graph by cluster ids.  Same arithmetic, so the same graphs
come out.
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


def coarsen_graph(g: CSRGraph, cluster_id: np.ndarray) -> tuple[CSRGraph, np.ndarray]:
    """Contract vertices by cluster id; map old directed edges to new ones.

    Returns (coarse graph, edge_map (2m,) int64: old directed edge index ->
    new directed edge index, or -1 for intra-cluster edges) — the contract of
    GraphAlgo::coarsenGraph (GraphAlgorithms.cpp:107-143).  The coarse
    graph's directed edges are ordered by (src cluster, dst cluster), which
    matches the reference's map<set> construction.
    """
    cluster_id = np.asarray(cluster_id, dtype=np.int64)
    if cluster_id.min(initial=0) < 0 or (
        cluster_id.size and np.unique(cluster_id).shape[0] != cluster_id.max() + 1
    ):
        raise ValueError("cluster ids must be gap-free starting at 0")
    n_coarse = int(cluster_id.max()) + 1 if cluster_id.size else 0

    csrc = cluster_id[g.edge_src]
    cdst = cluster_id[g.col_idx]
    inter = csrc != cdst
    keys = csrc * n_coarse + cdst  # directed coarse edge key per old edge
    unique_keys, inverse = np.unique(keys[inter], return_inverse=True)

    coarse_src = unique_keys // n_coarse
    coarse_dst = (unique_keys % n_coarse).astype(np.int32)
    row_ptr = np.zeros(n_coarse + 1, dtype=np.int64)
    np.add.at(row_ptr, coarse_src + 1, 1)
    np.cumsum(row_ptr, out=row_ptr)
    coarse = CSRGraph(row_ptr, coarse_dst)

    edge_map = -np.ones(g.num_directed_edges, dtype=np.int64)
    edge_map[inter] = inverse  # unique_keys are sorted == coarse CSR order
    return coarse, edge_map
