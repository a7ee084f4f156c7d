"""Size-capped weighted label-propagation coarsening.

Counterpart of ``wembed_tpu/multilevel/label_prop.py``, a re-implementation
of the reference's LabelPropagation
(reference: src/embeddingLib/src/partition/LabelPropagation.cpp:13-239) with
identical sequential semantics: per sweep, each node (in ascending-degree or
random order) moves to the neighbor cluster with the largest summed edge
weight, subject to the cluster-size cap; when a level shrinks by less than
2x, an aggressive pass merges single-child nodes into their heaviest-edge
neighbor and pairs degree-0 nodes, guaranteeing logarithmic hierarchy
height.

The sweeps are inherently order-dependent and sequential, so they run in
host C++ (``csrc/labelprop.cpp``, built with g++ at first use by
``kernels/_build.py``).  A failed build raises; there is no Python
fallback.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np

from ..core.options import PartitionerOptions
from ..graphs import algorithms
from ..graphs.csr import CSRGraph
from ..kernels import _build
from ..utils import rng as rng_mod


@dataclass
class CoarseningResult:
    """Parent-pointer tree: per layer, node -> cluster id in the next layer
    (the reference's ParentPointerTree, Partitioner.hpp:18).  Following the
    reference, the last two entries are the all-into-one mapping and the
    terminal {-1} (LabelPropagation.cpp:47-55)."""

    parent_pointers: list[np.ndarray]
    graphs: list[CSRGraph] = field(default_factory=list)
    edge_weights: list[np.ndarray] = field(default_factory=list)


def label_propagation_order(g: CSRGraph, order_type: int, rng: np.random.Generator) -> np.ndarray:
    """Visit order (LabelPropagation.cpp:181-200): 0 = ascending degree
    (stable), 1 = random permutation."""
    if order_type == 0:
        return np.argsort(g.degrees, kind="stable").astype(np.int32)
    if order_type == 1:
        return rng.permutation(g.num_vertices).astype(np.int32)
    raise ValueError(f"unknown order type {order_type}")


def _configure(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.wembed_label_propagation.argtypes = [
        ctypes.c_int64, i64p, i32p, f64p, i32p, ctypes.c_int32, ctypes.c_int32, i32p,
    ]
    lib.wembed_label_propagation.restype = None
    lib.wembed_aggressive_propagation.argtypes = [
        ctypes.c_int64, i64p, i32p, f64p, i32p, ctypes.c_int64, i32p,
    ]
    lib.wembed_aggressive_propagation.restype = None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _csr_arrays(g: CSRGraph, ew: np.ndarray):
    """The graph and its edge weights as the contiguous arrays the native
    entry points read; validated here, since C++ checks nothing."""
    ew = np.ascontiguousarray(ew, dtype=np.float64)
    if ew.shape != (g.num_directed_edges,):
        raise ValueError(f"edge weights have shape {ew.shape}, expected ({g.num_directed_edges},)")
    row_ptr = np.ascontiguousarray(g.row_ptr, dtype=np.int64)
    col = np.ascontiguousarray(g.col_idx, dtype=np.int32)
    return row_ptr, col, ew


def _run_label_propagation(
    g: CSRGraph, ew: np.ndarray, order: np.ndarray, opts: PartitionerOptions
) -> np.ndarray:
    lib = _build.load("labelprop", _configure)
    n = g.num_vertices
    row_ptr, col, eww = _csr_arrays(g, ew)
    orderc = np.ascontiguousarray(order, dtype=np.int32)
    if orderc.shape != (n,) or (n and (orderc.min() < 0 or orderc.max() >= n)):
        raise ValueError("order must be a permutation-sized array of vertex ids")
    out = np.empty(n, dtype=np.int32)
    lib.wembed_label_propagation(
        n, _ptr(row_ptr, ctypes.c_int64), _ptr(col, ctypes.c_int32),
        _ptr(eww, ctypes.c_double), _ptr(orderc, ctypes.c_int32),
        opts.max_iterations, opts.max_cluster_size, _ptr(out, ctypes.c_int32),
    )
    return out


def _run_aggressive(g: CSRGraph, ew: np.ndarray, prev_parents: np.ndarray) -> np.ndarray:
    lib = _build.load("labelprop", _configure)
    n = g.num_vertices
    row_ptr, col, eww = _csr_arrays(g, ew)
    prev = np.ascontiguousarray(prev_parents, dtype=np.int32)
    if prev.size and (prev.min() < 0 or prev.max() >= n):
        raise ValueError("prev_parents must hold vertex ids of this graph")
    out = np.empty(n, dtype=np.int32)
    lib.wembed_aggressive_propagation(
        n, _ptr(row_ptr, ctypes.c_int64), _ptr(col, ctypes.c_int32),
        _ptr(eww, ctypes.c_double), _ptr(prev, ctypes.c_int32), prev.shape[0],
        _ptr(out, ctypes.c_int32),
    )
    return out


def compact_cluster_ids(cluster: np.ndarray) -> np.ndarray:
    """Renumber clusters to 0..k-1 in order of first appearance in vertex
    order (LabelPropagation.cpp:203-221), by unique + argsort of first
    indices."""
    _, first_idx, inverse = np.unique(cluster, return_index=True, return_inverse=True)
    order = np.argsort(np.argsort(first_idx))
    return order[inverse]


def calculate_new_edge_weights(old_weights: np.ndarray, edge_map: np.ndarray) -> np.ndarray:
    """Aggregate fine edge weights onto coarse edges
    (LabelPropagation.cpp:223-239)."""
    keep = edge_map >= 0
    num_new = int(edge_map.max()) + 1 if keep.any() else 0
    out = np.zeros(num_new)
    np.add.at(out, edge_map[keep], old_weights[keep])
    return out


def coarsen_all_layers(
    g: CSRGraph,
    edge_weights: np.ndarray | None = None,
    opts: PartitionerOptions | None = None,
    rng: np.random.Generator | None = None,
) -> CoarseningResult:
    """The reference's coarsenAllLayers loop (LabelPropagation.cpp:13-56)."""
    opts = opts or PartitionerOptions()
    rng = rng or rng_mod.host_rng()
    if edge_weights is None:
        edge_weights = np.ones(g.num_directed_edges)

    parent_pointers: list[np.ndarray] = []
    graphs = [g]
    weights_per_layer = [np.asarray(edge_weights, dtype=np.float64)]
    shrink = 0.0  # always do a normal propagation first

    while graphs[-1].num_vertices > opts.final_graph_size and graphs[-1].num_edges > 0:
        current = graphs[-1]
        ew = weights_per_layer[-1]
        if shrink < 0.5:
            order = label_propagation_order(current, opts.order_type, rng)
            raw = _run_label_propagation(current, ew, order, opts)
        else:
            raw = _run_aggressive(current, ew, parent_pointers[-1])
        mapping = compact_cluster_ids(raw)
        coarse, edge_map = algorithms.coarsen_graph(current, mapping)
        parent_pointers.append(mapping.astype(np.int64))
        graphs.append(coarse)
        weights_per_layer.append(calculate_new_edge_weights(ew, edge_map))
        shrink = coarse.num_vertices / current.num_vertices

    # terminal mappings (LabelPropagation.cpp:47-55)
    parent_pointers.append(np.zeros(graphs[-1].num_vertices, dtype=np.int64))
    parent_pointers.append(np.asarray([-1], dtype=np.int64))
    return CoarseningResult(parent_pointers, graphs, weights_per_layer)
