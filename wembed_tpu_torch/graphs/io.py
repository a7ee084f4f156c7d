"""Graph and embedding file I/O.

Counterpart of ``wembed_tpu/graphs/io.py``, numpy only.  Formats are
byte-compatible with the reference:
  * edge lists — whitespace-delimited pairs, '#' comments
    (reference src/graphLib/src/graphIO/GraphIO.cpp:10-126)
  * bipartite edge lists — '#psizes a b' header, colors 0/1
    (GraphIO.cpp:66-126)
  * coordinate CSVs — 'id,c1,...,cd[,weight]' rows, '%' comments; values are
    written with Python ``repr`` (shortest round-trip representation), which
    preserves every bit like the reference's 17-significant-digit printf
    (reference src/embeddingLib/src/embeddingIO/EmbeddingIO.cpp:110-222)
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .csr import CSRGraph, from_edges


def read_edge_list(path: str, comment: str = "#", delimiter: str | None = None) -> CSRGraph:
    """Read an undirected edge list file into a CSRGraph.

    ``delimiter=None`` splits on any whitespace (the reference uses a single
    space, GraphIO.cpp:10; whitespace-splitting is a superset).  Lines with
    fewer than two integer tokens are skipped.

    As in the JAX package, whitespace-delimited files with a one-character
    comment go through the native parser (``csrc/labelprop.cpp``,
    ``wembed_parse_edge_list``, built with g++ at first use): the Python
    loop takes minutes at 100M edges (reference parser:
    src/graphLib/src/graphIO/GraphIO.cpp:10-51, C++).  Another delimiter or
    a longer comment takes the Python loop.  A failed build or an
    unreadable file raises; nothing falls back.
    """
    if delimiter is None and len(comment) == 1:
        pairs = _read_pairs_native(path, comment)
    else:
        pairs = _read_pairs_python(path, comment, delimiter)
    return from_edges(pairs)


def _read_pairs_python(path: str, comment: str, delimiter: str | None) -> np.ndarray:
    """(k, 2) int64 edge pairs, a line at a time."""
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
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def _configure_parser(lib: ctypes.CDLL) -> None:
    lib.wembed_parse_edge_list.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.wembed_parse_edge_list.restype = ctypes.c_int64


def _read_pairs_native(path: str, comment: str) -> np.ndarray:
    """(k, 2) int64 edge pairs from the native parser, in one pass: every
    parsed line takes at least 4 bytes ("a b\n"; the last line 3), so
    size // 4 + 1 pairs bound the count."""
    from ..kernels import _build

    capacity = os.path.getsize(path) // 4 + 1
    buf = np.empty((capacity, 2), dtype=np.int64)
    lib = _build.load("labelprop", _configure_parser)
    count = lib.wembed_parse_edge_list(
        os.fsencode(path), comment.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        capacity,
    )
    if count < 0:
        raise OSError(f"the native edge-list parser cannot read {path!r}")
    if count > capacity:
        raise RuntimeError(f"{path!r}: {count} pairs overran the parser's bound of {capacity}")
    return buf[:count].copy()


def write_edge_list(path: str, g: CSRGraph) -> None:
    """Write each undirected edge once as 'src dst' with src < dst."""
    with open(path, "w") as f:
        for u, v in g.edge_list():
            f.write(f"{u} {v}\n")


def read_bipartite_edge_list(path: str, comment: str = "#", delimiter: str | None = None) -> CSRGraph:
    """Read a bipartite edge list with a '#psizes a b' first line.

    Vertices 0..a-1 get color 0, the rest color 1 (GraphIO.cpp:66-126); the
    embedder never repels same-color pairs.
    """
    with open(path) as f:
        header = f.readline().split(delimiter)
        if len(header) != 3 or header[0] != "#psizes":
            raise ValueError(f"invalid bipartite header in {path!r}: {header}")
        a, b = int(header[1]), int(header[2])
        pairs = []
        for line in f:
            line = line.strip()
            if not line or line.startswith(comment):
                continue
            tokens = line.split(delimiter)
            if len(tokens) != 2:
                continue
            pairs.append((int(tokens[0]), int(tokens[1])))
    g = from_edges(np.asarray(pairs, dtype=np.int64).reshape(-1, 2), num_vertices=a + b)
    if g.num_vertices != a + b:
        raise ValueError("number of vertices does not match partition sizes")
    colors = (np.arange(a + b) >= a).astype(np.int32)
    return g.with_colors(colors)


def read_coordinates(path: str, comment: str = "%", delimiter: str = ",") -> np.ndarray:
    """Read a coordinate CSV: one 'id,c1,...,ck' row per vertex.

    Returns (n, k) float64 rows ordered by vertex id.  Ids must be
    consecutive from 0 (EmbeddingIO.cpp:110-162).  The last column may be a
    weight — callers split it (see ``split_last_column``).
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


def split_last_column(coords: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split (n, k) rows into ((n, k-1) positions, (n,) weights)
    (EmbeddingIO.cpp:164-178)."""
    return coords[:, :-1], coords[:, -1]


def split_first_column(coords: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split (n, k) rows into ((n,) first column, (n, k-1) rest)
    (EmbeddingIO.cpp:180-192)."""
    return coords[:, 0], coords[:, 1:]
