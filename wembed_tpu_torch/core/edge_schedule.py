"""The span edge pass kernel's schedule of a src-sorted directed edge set.

``csrc/edge_pass.cu:segment_pass_kernel`` walks the edges segment by
segment (a segment: one source vertex's edges).  Its grid is this
schedule, built once on the host from the CSR offsets, in three parts:

  heavy segments   more than ``HEAVY`` edges: one CTA each, first in the
                   grid, the longest first (a power-law graph's hubs, up to
                   ~10,000 edges on girg100k, start before anything else)
  medium segments  more than ``LIGHT`` and at most ``HEAVY`` edges: one
                   warp each, 32 edges a round, the longest first,
                   ``WARPS`` of them a CTA
  light groups     runs of consecutive vertices whose segments are at most
                   ``LIGHT`` edges long, at most ``LIGHT`` vertices and
                   ``LIGHT`` edges a run: one warp each, a lane an edge and
                   a lane a vertex; ``WARPS`` of them a CTA

Every vertex is in exactly one segment entry or one light group, empty
segments included (a share's clipped offsets, ``core/forces.py:
edge_share``, leave most of them empty), so the kernel writes every row of
its output.  The table is (heavy + medium + groups, 4) int64, an entry a
heavy segment, a medium segment, then a light group, in this order: its
(first) vertex, its vertices (1 for a segment), its first edge and its
edges, so that a warp issues its edges' loads without waiting on the CSR
offsets.  Beside it, each edge's dst as int32 (the kernel reads no source
index: a segment's source is its vertex).

``EdgeSchedules`` keeps the schedules of one edge set and of its shares,
each built on first use.  The embedders hold one beside each edge set (the
span index's device tables, ``DeviceGraph``), so a schedule is built in
the eager warm-up step before any capture (``core/step.py:StepGraph``)
and a new edge set comes with a new one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LIGHT = 32  # longest light segment, and the vertices and edges of a light group (a warp's lanes)
HEAVY = 256  # longest medium segment: a longer one takes a CTA
WARPS = 8  # medium segments or light groups a CTA: its warps


class EdgeSchedule(NamedTuple):
    table: torch.Tensor  # (heavy + medium + groups, 4) i64: vertex, vertices, first edge, edges
    dst: torch.Tensor  # (E,) i32 each edge's dst
    heavy: int  # segments of more than HEAVY edges
    medium: int  # segments of more than LIGHT and at most HEAVY edges
    groups: int  # light groups
    n: int  # vertices
    num_edges: int

    @property
    def ctas(self) -> int:
        """The kernel's grid: a CTA a heavy segment and one for every
        ``WARPS`` medium segments and every ``WARPS`` light groups."""
        return self.heavy + -(-self.medium // WARPS) + -(-self.groups // WARPS)


def schedule_table(row_ptr: np.ndarray) -> tuple[np.ndarray, int, int, int]:
    """(table, heavy, medium, groups) of the CSR offsets ``row_ptr``
    (n + 1,): the heavy segments (more than HEAVY edges) and the medium
    ones (more than LIGHT), each by length descending (ties by
    vertex), then the light groups, packed greedily in vertex order; an
    entry (vertex, vertices, first edge, edges) each."""
    row_ptr = np.asarray(row_ptr, np.int64)
    deg = np.diff(row_ptr)

    def longest_first(mask):
        v = np.flatnonzero(mask)
        return v[np.argsort(-deg[v], kind="stable")]

    heavy = longest_first(deg > HEAVY)
    medium = longest_first((deg > LIGHT) & (deg <= HEAVY))
    first, count = [], []
    start = verts = edges = 0
    for v, k in enumerate(deg.tolist()):
        if k > LIGHT:
            if verts:
                first.append(start)
                count.append(verts)
                verts = 0
            continue
        if verts and (verts == LIGHT or edges + k > LIGHT):
            first.append(start)
            count.append(verts)
            verts = 0
        if verts == 0:
            start, edges = v, 0
        verts += 1
        edges += k
    if verts:
        first.append(start)
        count.append(verts)
    v = np.concatenate([heavy, medium, np.asarray(first, np.int64)])
    verts = np.concatenate([np.ones(heavy.shape[0] + medium.shape[0], np.int64), np.asarray(count, np.int64)])
    table = np.stack([v, verts, row_ptr[v], row_ptr[v + verts] - row_ptr[v]], axis=1)
    return table, int(heavy.shape[0]), int(medium.shape[0]), len(first)


def edge_schedule(row_ptr: np.ndarray, dst: torch.Tensor) -> EdgeSchedule:
    """The schedule of the edges ``dst`` (E,) with host CSR offsets
    ``row_ptr`` (n + 1,) into them, on ``dst``'s device."""
    row_ptr = np.asarray(row_ptr, np.int64)
    n, num_edges = row_ptr.shape[0] - 1, int(dst.shape[0])
    if n < 1 or row_ptr[0] != 0 or row_ptr[-1] != num_edges or np.any(np.diff(row_ptr) < 0):
        raise ValueError("row_ptr must run from 0 to the edge count, nondecreasing, over at least one vertex")
    if n >= 2**31:
        raise ValueError(f"the edge pass schedule holds vertex ids as int32, got n = {n}")
    table, heavy, medium, groups = schedule_table(row_ptr)
    return EdgeSchedule(
        table=torch.as_tensor(table, device=dst.device),
        dst=dst.to(torch.int32).contiguous(),
        heavy=heavy, medium=medium, groups=groups, n=n, num_edges=num_edges,
    )


class EdgeSchedules:
    """The schedules of one src-sorted edge set (host CSR offsets
    ``row_ptr``, ``dst`` on its device) and of its shares' ranges
    [lo, hi), each built once, on first use."""

    def __init__(self, row_ptr: np.ndarray, dst: torch.Tensor):
        self.row_ptr = np.asarray(row_ptr, np.int64)
        self.dst = dst
        self._built: dict[tuple[int, int], EdgeSchedule] = {}

    def get(self, lo: int = 0, hi: int | None = None) -> EdgeSchedule:
        """The schedule of edges [lo, hi) (default: all), the segment
        offsets clipped to the range as ``core/forces.py:edge_share``
        clips them."""
        hi = int(self.dst.shape[0]) if hi is None else int(hi)
        key = (int(lo), hi)
        got = self._built.get(key)
        if got is None:
            got = edge_schedule(np.clip(self.row_ptr, lo, hi) - lo, self.dst[lo:hi])
            self._built[key] = got
        return got
