"""Static undirected graph in CSR form, host-side numpy arrays.

Counterpart of ``wembed_tpu/graphs/csr.py`` (the reference's Graph,
src/graphLib/include/graph/Graph.hpp:11-85, src/graphLib/src/graph/Graph.cpp),
carried into the port because importing anything from ``wembed_tpu`` imports
jax.  The graph is a pair of flat numpy arrays (``row_ptr``, ``col_idx``)
plus color classes.  Each undirected edge is stored twice (once per
direction), matching the reference's convention (Graph.cpp:9-28).
Construction symmetrizes the input, drops self-loops and duplicate edges,
and fills in missing vertex ids (Graph.cpp:85-140).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Iterable, Sequence

import numpy as np


@dataclass(frozen=True)
class CSRGraph:
    """Immutable undirected graph: CSR offsets + flat neighbor array.

    Attributes:
      row_ptr: (n+1,) int64 — neighbor-range offsets per vertex.
      col_idx: (2m,) int32 — flattened, per-row-sorted neighbor ids.
      colors:  (n,) int32 — color classes; vertices in the same class never
               repel (reference Graph.cpp:85).  Default: unique colors
               (reference Graph.cpp:152-157), i.e. no pair is filtered.
    """

    row_ptr: np.ndarray
    col_idx: np.ndarray
    colors: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        object.__setattr__(self, "row_ptr", np.asarray(self.row_ptr, dtype=np.int64))
        object.__setattr__(self, "col_idx", np.asarray(self.col_idx, dtype=np.int32))
        if self.colors is None:
            object.__setattr__(self, "colors", np.arange(self.num_vertices, dtype=np.int32))
        else:
            colors = np.asarray(self.colors, dtype=np.int32)
            if colors.shape != (self.num_vertices,):
                raise ValueError(
                    f"colors has shape {colors.shape}, expected ({self.num_vertices},)"
                )
            object.__setattr__(self, "colors", colors)

    # ------------------------------------------------------------------ sizes
    @property
    def num_vertices(self) -> int:
        return int(self.row_ptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        """Number of undirected edges (each stored twice in col_idx)."""
        return int(self.col_idx.shape[0] // 2)

    @property
    def num_directed_edges(self) -> int:
        return int(self.col_idx.shape[0])

    # ------------------------------------------------------------- adjacency
    @cached_property
    def degrees(self) -> np.ndarray:
        """(n,) int32 vertex degrees."""
        return np.diff(self.row_ptr).astype(np.int32)

    @cached_property
    def edge_src(self) -> np.ndarray:
        """(2m,) int32 source vertex of each directed edge (CSR row id)."""
        return np.repeat(
            np.arange(self.num_vertices, dtype=np.int32), self.degrees
        )

    @cached_property
    def edge_keys(self) -> np.ndarray:
        """(2m,) int64 sorted keys src*n+dst for O(log m) membership tests.

        Neighbor membership is a vectorized ``searchsorted`` over these
        keys, in place of the reference's linear adjacency scan
        (Graph.cpp:67-83).
        """
        keys = self.edge_src.astype(np.int64) * self.num_vertices + self.col_idx
        return np.sort(keys)

    def neighbors(self, v: int) -> np.ndarray:
        return self.col_idx[self.row_ptr[v] : self.row_ptr[v + 1]]

    def num_neighbors(self, v: int) -> int:
        return int(self.row_ptr[v + 1] - self.row_ptr[v])

    def are_neighbors(self, v: int, u: int) -> bool:
        key = np.int64(v) * self.num_vertices + u
        i = np.searchsorted(self.edge_keys, key)
        return bool(i < self.edge_keys.shape[0] and self.edge_keys[i] == key)

    def same_color(self, v: int, u: int) -> bool:
        return bool(self.colors[v] == self.colors[u])

    # ------------------------------------------------------------- edge list
    def edge_list(self) -> np.ndarray:
        """(m, 2) int32 undirected edge list, src < dst, each edge once."""
        mask = self.edge_src < self.col_idx
        return np.stack([self.edge_src[mask], self.col_idx[mask]], axis=1)

    def with_colors(self, colors: np.ndarray) -> "CSRGraph":
        return CSRGraph(self.row_ptr, self.col_idx, np.asarray(colors))

    def __repr__(self) -> str:
        return f"CSRGraph(n={self.num_vertices}, m={self.num_edges})"


def from_edges(
    edges: Iterable[Sequence[int]] | np.ndarray,
    num_vertices: int | None = None,
    colors: np.ndarray | None = None,
) -> CSRGraph:
    """Build a CSRGraph from an iterable/array of (u, v) pairs.

    Semantics match the reference's edge-pair constructor
    (Graph.cpp:140-150 via constructFromMap): symmetrize, drop self-loops,
    dedupe, fill missing ids up to max id (or ``num_vertices``).
    """
    arr = np.asarray(list(edges) if not isinstance(edges, np.ndarray) else edges)
    if arr.size == 0:
        n = int(num_vertices or 0)
        return CSRGraph(np.zeros(n + 1, dtype=np.int64), np.empty(0, dtype=np.int32), colors)
    arr = arr.reshape(-1, 2).astype(np.int64)
    if arr.min() < 0:
        raise ValueError("vertex ids must be non-negative")

    n = int(arr.max()) + 1
    if num_vertices is not None:
        if num_vertices < n:
            raise ValueError(f"num_vertices={num_vertices} < max id + 1 = {n}")
        n = int(num_vertices)

    # symmetrize, drop self loops, dedupe via sorted unique keys
    both = np.concatenate([arr, arr[:, ::-1]], axis=0)
    both = both[both[:, 0] != both[:, 1]]
    keys = np.unique(both[:, 0] * n + both[:, 1])
    src = (keys // n).astype(np.int64)
    dst = (keys % n).astype(np.int32)

    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(row_ptr, src + 1, 1)
    np.cumsum(row_ptr, out=row_ptr)
    # keys are sorted by (src, dst) so dst is already per-row sorted
    return CSRGraph(row_ptr, dst, colors)
