"""Graph and embedding file I/O.

Counterpart of ``wembed_tpu/graphs/io.py``, numpy only.  Formats are
byte-compatible with the reference:
  * edge lists — whitespace-delimited pairs, '#' comments
    (reference src/graphLib/src/graphIO/GraphIO.cpp:10-126)
  * coordinate CSVs — 'id,c1,...,cd[,weight]' rows, '%' comments; values are
    written with Python ``repr`` (shortest round-trip representation), which
    preserves every bit like the reference's 17-significant-digit printf
    (reference src/embeddingLib/src/embeddingIO/EmbeddingIO.cpp:110-222)
"""

from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges


def read_edge_list(path: str, comment: str = "#", delimiter: str | None = None) -> CSRGraph:
    """Read an undirected edge list file into a CSRGraph.

    ``delimiter=None`` splits on any whitespace (the reference uses a single
    space, GraphIO.cpp:10; whitespace-splitting is a superset).  Lines with
    fewer than two integer tokens are skipped.
    """
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(comment):
                continue
            tokens = line.split(delimiter)
            if len(tokens) < 2:
                continue
            try:
                pairs.append((int(tokens[0]), int(tokens[1])))
            except ValueError:
                continue
    return from_edges(np.asarray(pairs, dtype=np.int64).reshape(-1, 2))


def read_coordinates(path: str, comment: str = "%", delimiter: str = ",") -> np.ndarray:
    """Read a coordinate CSV: one 'id,c1,...,ck' row per vertex.

    Returns (n, k) float64 rows ordered by vertex id.  Ids must be
    consecutive from 0 (EmbeddingIO.cpp:110-162).  The last column may be a
    weight — callers split it.
    """
    rows: dict[int, list[float]] = {}
    width = -1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(comment):
                continue
            tokens = line.split(delimiter)
            vid = int(tokens[0])
            coord = [float(t) for t in tokens[1:]]
            if width == -1:
                width = len(coord)
            elif width != len(coord):
                raise ValueError(f"inconsistent coordinate width on line {line!r}")
            rows[vid] = coord
    n = len(rows)
    for i in range(n):
        if i not in rows:
            raise ValueError(f"vertex {i} is missing from {path!r}")
    return np.asarray([rows[i] for i in range(n)], dtype=np.float64)


def write_coordinates(
    path: str, positions: np.ndarray, weights: np.ndarray | None = None
) -> None:
    """Write 'id,c1,...,cd[,weight]' rows; ``repr`` emits the shortest
    round-trip decimal, bit-preserving like the reference's 17-digit
    output (EmbeddingIO.cpp:194-222)."""
    positions = np.asarray(positions)
    with open(path, "w") as f:
        for i in range(positions.shape[0]):
            row = ",".join(repr(float(c)) for c in positions[i])
            if weights is not None:
                f.write(f"{i},{row},{float(weights[i])!r}\n")
            else:
                f.write(f"{i},{row}\n")
