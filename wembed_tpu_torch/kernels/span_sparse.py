"""The span path's repulsion: candidate windows over projected, sorted
weight groups, swept by one kernel, plus one edge pass.

Counterpart of ``wembed_tpu/kernels/span_sparse.py`` (the reference's
per-iteration weighted radius index, WeightedIndex.cpp:10-100 over the SNN
projected-sort index, snn.cpp:97-160):

  1. ``SpanIndex`` (numpy, built once per embedder and on every window
     resize): vertices are split into merged doubling weight groups, each
     group into ROWS of equal population by rank along the first principal
     axis.  Windows live per (query block of 256, target row) and are
     ``blk_t[i, g]`` tiles of 256 members wide; grow, resize and shrink size
     them from measured needs with the JAX package's arithmetic.
  2. ``build_span_structures`` (every step): project on the first two
     principal axes, sort by (group, first axis) then (row, second axis),
     lay out the member and query records, place each window by a binary
     search on the second axis, and report the per-window need and the
     overflow (in-radius members beyond the windows).  The principal
     frame (mean, covariance, axes and projections), the records and the
     windows are CUDA kernels (``kernels/span_build.py``,
     ``csrc/span_build.cu``); the sorts are torch.
  3. ``kernels/span_sweep.py``: the sweep of every window (the CUDA kernel),
     in work items of at most ``WORK_ITEM_TILES`` tiles that the index cuts
     from its windows (``SpanIndex.work_items``).
  4. One pass over the directed edges (``kernels/edge_pass.py``, the
     CUDA kernel ``csrc/edge_pass.cu``): attraction, and the removal of
     the repulsion that the sweep applied to graph neighbours (the
     reference never repels neighbours, NewWEmbedEmbedder.cpp:328).  Its
     inclusion test repeats the sweep's own tests in the same f32
     operations, so the removal cancels exactly what the sweep added.

A partial index (``index_size < 1``, the reference's IndexSize,
NewWEmbedEmbedder.cpp:271-285) inserts only a sample of the members each
step: ``SpanIndex.draw_members`` draws ``max(1, ceil(n_b * index_size))``
vertices of every doubling weight class (the JAX package's strata,
``wembed_tpu/core/candidates.py:193-196,312-323``), and the structures
build gives the others the member sentinel and a zero radius factor, so
no pair with them passes the sweep's radius test.  Every vertex still
queries.  The sort order, the rows and the windows do not change.

One rank's share of the replicated multi-device step (``core/step.py:
Share``) is a contiguous slice of the sweep's work items and a contiguous
range of the directed, src-sorted edges; the structures build stays whole
on every rank, as in the JAX package.  A halo rank
(``distributed/halo.py``) sweeps such a slice too (in resident mode the
items of its range of query blocks, ``block_items``), and its index holds
only its chunk of the correction edges.

The cell layout (``kernels/span_compact.py``) shares steps 3 and 4: its
index and structures have this module's surface (``structures``,
``tensors``, ``work_items``, ``covers``), so ``_sweep``,
``span_fused_forces`` and ``span_repulsion_forces`` take either layout.

What the TPU layout needed and the port drops: the flattened, bucketed
work-tile list and its scalar-prefetch tables (the CUDA kernel reads the
(NB, R) ``blk_t`` and ``start_tile`` tables and a work-item table built
once per window change), the dummy query
block, the transposed (C, NPA) lanes, packed gathers and bitcast channels,
and the host needs mirror (needs come from this module's build, always).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import NamedTuple

import numpy as np
import torch

from ..core.candidates import doubling_weight_buckets
from ..core.edge_schedule import EdgeSchedules
from ..core.forces import edge_share, normal_rows
from . import edge_pass as edges
from . import span_build
from .span_sweep import Q as _Q, ST as _ST, span_sweep, work_items

_GROUP_MIN = 2048  # merge doubling classes until a group has this many


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ----------------------------------------------------------------- skeleton


def _merge_weight_groups(weights: np.ndarray, opts):
    """Merged doubling weight groups: consecutive doubling classes
    (WeightedIndex.cpp:51-63) greedily merged until a group holds
    >= _GROUP_MIN members.  Returns (group_of (n,) i32, group_sizes (B,)
    i64, bmaxpow (B,) f32 = groupmax^(1/d), class_bm2 (n,) f32 = per-CLASS
    max^(2/d), B)."""
    d = int(opts.embedding_dimension)
    thresholds = doubling_weight_buckets(weights, opts.doubling_factor)
    assignment = np.searchsorted(thresholds, weights, side="right")
    class_max = np.concatenate([thresholds, [float(np.max(weights))]])
    num_classes = thresholds.shape[0] + 1
    class_sizes = np.bincount(assignment, minlength=num_classes)

    class_group = np.zeros(num_classes, np.int32)
    sizes, maxes = [], []
    acc = 0
    for c in range(num_classes):
        if acc >= _GROUP_MIN and sizes:
            sizes.append(0)
            acc = 0
        if not sizes:
            sizes.append(0)
        class_group[c] = len(sizes) - 1
        sizes[-1] += int(class_sizes[c])
        acc += int(class_sizes[c])
        if len(maxes) < len(sizes):
            maxes.append(0.0)
        if class_sizes[c]:
            maxes[-1] = float(class_max[c])
        else:
            maxes[-1] = max(maxes[-1], float(class_max[c]))
    # drop empty groups (possible when trailing classes are empty)
    keep = [i for i, s in enumerate(sizes) if s > 0]
    remap = {old: new for new, old in enumerate(keep)}
    group_sizes = np.asarray([sizes[i] for i in keep], np.int64)
    bmaxpow = np.asarray([maxes[i] ** (1.0 / d) for i in keep], np.float32)
    b = len(keep)
    group_of = np.asarray([remap[class_group[c]] for c in assignment], np.int32)
    class_bm2 = (class_max[assignment] ** (2.0 / d)).astype(np.float32)
    return group_of, group_sizes, bmaxpow, class_bm2, b, assignment


def _edge_tables(n: int, edge_src, edge_dst, class_bm2: np.ndarray):
    """The neighbour correction's directed edges in CSR (src-sorted) order:
    (src (E,) i64, dst (E,) i64, class_bm2 of each dst (E,) f32, row
    pointers (n+1,) i64).  Shared by both span layouts."""
    esrc = np.asarray(edge_src, np.int64)
    edst = np.asarray(edge_dst, np.int64)
    row_ptr = np.searchsorted(esrc, np.arange(n + 1)).astype(np.int64)
    return esrc, edst, class_bm2[edst], row_ptr


class SpanTensors(NamedTuple):
    """The index's position-independent tables on one device."""

    group_of: torch.Tensor  # (n,) i32, the first sort's key (32 bits: half the radix passes of 64)
    class_bm2: torch.Tensor  # (n,) f32
    row_key: torch.Tensor  # (n,) i32 row of each sorted rank, the second sort's key
    # int32 slot maps, read by the records (and src_of_q by the windows)
    sorted_moff: torch.Tensor  # (n,) i32
    sorted_shift_q: torch.Tensor  # (n,) i32
    src_of_pad: torch.Tensor  # (NPA,) i32, n = sentinel
    src_of_q: torch.Tensor  # (NQ,) i32, n = sentinel
    max_row: int  # the longest row's size
    blk_first: torch.Tensor  # (NB,) i64
    blk_last: torch.Tensor  # (NB,) i64
    row_lo: torch.Tensor  # (R,) i64 first sorted rank of each row
    row_hi: torch.Tensor  # (R,) i64 last sorted rank of each row
    row_tiles: torch.Tensor  # (R,) i64
    tile_off: torch.Tensor  # (R,) i32 first tile of each row's padded range
    bmax_row: torch.Tensor  # (R,) f32 group bmax^(1/d) of each row
    edge_src: torch.Tensor  # (2m,) i64 src-sorted directed edges
    edge_dst: torch.Tensor  # (2m,) i64
    edge_bm2: torch.Tensor  # (2m,) f32 class_bm2 of each edge's dst
    edge_row_ptr: torch.Tensor  # (n+1,) i64 CSR offsets
    edge_schedules: EdgeSchedules  # the edge pass kernel's schedules of these edges and their shares
    class_of: torch.Tensor  # (n,) i64 doubling class
    class_start: torch.Tensor  # (C,) i64 first position of each class in class order
    class_take: torch.Tensor  # (C,) i64 members a step of each class


@dataclass(frozen=True)
class SpanIndex:
    """Static skeleton of the span index (host-built once per embedder and
    per window resize).  Every field is numpy or python: nothing here
    depends on positions.

    Two-level layout: each merged weight group is split into ROWS, equal-
    population bins of the group's members by rank along the FIRST
    principal axis, every row size a multiple of 512 except the group's
    last.  Per step, members are binned by first-axis rank (row membership
    is a static function of that rank) and sorted within each row by the
    SECOND principal axis; windows live per (query block, target row): rows
    outside the conservative first-axis reach get none, in-reach rows a
    second-axis window.  Row population is sqrt(_Q * group_size) rounded
    to 512, the minimiser of swept members per block for uniform density."""

    n: int
    d: int
    num_groups: int  # B: merged weight groups (radius semantics)
    num_rows: int  # R: total rows (window granularity)
    nb: int  # NB: total query blocks
    w: int  # total work tiles, sum of blk_t
    # row tables (R,)
    row_group: np.ndarray
    row_sizes: np.ndarray
    row_moff: np.ndarray  # member offset of row in sorted order
    row_qoff: np.ndarray  # query offset (padded to _Q blocks)
    row_pad_off: np.ndarray  # member offset in the ST-padded layout
    row_tiles: np.ndarray
    # group tables (B,)
    bmaxpow: np.ndarray  # f32 bmax_g^(1/d)
    # per-vertex static
    group_of: np.ndarray  # (n,) int32
    class_bm2: np.ndarray  # (n,) f32 per-DOUBLING-CLASS max^(2/d): the
    # reference's candidate radius factor (WeightedIndex.cpp:65-81), so the
    # counted candidate set is the per-class one; merging only widens windows
    class_of: np.ndarray  # (n,) int32 doubling class of each vertex
    class_sizes: np.ndarray  # (C,) vertices of each class
    class_take: np.ndarray  # (C,) members inserted a step, per class (all of
    # it unless index_size < 1)
    # sorted-order static vectors (n,)
    row_of_sorted: np.ndarray
    sorted_moff: np.ndarray
    sorted_shift_q: np.ndarray  # q_off - m_off per sorted position
    # padded-slot -> sorted-rank gather maps (rank n = sentinel)
    src_of_pad: np.ndarray  # (NPA,)
    src_of_q: np.ndarray  # (NQ,) = (NB * _Q,)
    # per-block static member-rank extents (first/last rank in block)
    blk_first: np.ndarray
    blk_last: np.ndarray
    blk_t: np.ndarray  # (NB, R) window width in tiles of each (block, row)
    blk_row: np.ndarray  # (NB,) query row of each block
    # directed edges in CSR (src-sorted) order, unpadded
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_bm2: np.ndarray  # (2m,) f32 class_bm2 of each edge's dst
    edge_row_ptr: np.ndarray  # (n+1,)
    span_scale: float
    # device copies of the static tables, shared by every resized index
    _tensors: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def npa(self) -> int:  # padded member array length
        return int(self.row_pad_off[-1] + self.row_tiles[-1] * _ST)

    @property
    def nq(self) -> int:  # padded query array length
        return int(self.nb * _Q)

    def tensors(self, device: torch.device) -> SpanTensors:
        """The static tables on ``device``, built once per skeleton."""
        key = str(device)
        cached = self._tensors.get(key)
        if cached is None:
            def i64(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=device)

            def f32(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=device)

            def i32(a):
                return torch.as_tensor(np.asarray(a, np.int32), device=device)

            edge_dst = i64(self.edge_dst)
            cached = SpanTensors(
                group_of=i32(self.group_of),
                class_bm2=f32(self.class_bm2),
                row_key=i32(self.row_of_sorted),
                sorted_moff=i32(self.sorted_moff),
                sorted_shift_q=i32(self.sorted_shift_q),
                src_of_pad=i32(self.src_of_pad),
                src_of_q=i32(self.src_of_q),
                max_row=int(np.max(self.row_sizes)),
                blk_first=i64(self.blk_first),
                blk_last=i64(self.blk_last),
                row_lo=i64(self.row_moff),
                row_hi=i64(self.row_moff + self.row_sizes - 1),
                row_tiles=i64(self.row_tiles),
                tile_off=i32(self.row_pad_off // _ST),
                bmax_row=f32(self.bmaxpow[self.row_group]),
                edge_src=i64(self.edge_src),
                edge_dst=edge_dst,
                edge_bm2=f32(self.edge_bm2),
                edge_row_ptr=i64(self.edge_row_ptr),
                edge_schedules=EdgeSchedules(self.edge_row_ptr, edge_dst),
                class_of=i64(self.class_of),
                class_start=i64(np.cumsum(self.class_sizes) - self.class_sizes),
                class_take=i64(self.class_take),
            )
            self._tensors[key] = cached
        return cached

    def lwpow(self, weights: torch.Tensor, dtype: torch.dtype, edge_length: float) -> torch.Tensor:
        """(n,) L * w^(1/d) in ``dtype``: made once for a weights tensor and
        kept beside the device tables (new weights make a new tensor, and
        drop a captured step, whose first eager step makes this one)."""
        key = ("lwpow", str(weights.device))
        hit = self._tensors.get(key)
        if hit is None or hit[0] is not weights or hit[1] != (weights._version, dtype, edge_length):
            lw = edge_length * torch.pow(weights.to(dtype), 1.0 / self.d)
            hit = (weights, (weights._version, dtype, edge_length), lw)
            self._tensors[key] = hit
        return hit[2]

    def vertex_records(self, weights: torch.Tensor, inv_w: torch.Tensor, colors: torch.Tensor,
                       dtype: torch.dtype, edge_length: float) -> torch.Tensor:
        """(n, 8) ``span_build.vertex_records`` in ``dtype``, made once for
        these weights, inverse weights and colours (by identity and
        in-place version) and kept beside ``lwpow``."""
        lw = self.lwpow(weights, dtype, edge_length)
        key = ("vertex_records", str(weights.device))
        sources = (lw, inv_w, colors)
        stamp = tuple(t._version for t in sources)
        hit = self._tensors.get(key)
        if hit is None or any(a is not b for a, b in zip(hit[0], sources)) or hit[1] != stamp:
            rec = span_build.vertex_records(inv_w, lw, colors, self.tensors(weights.device).class_bm2)
            hit = (sources, stamp, rec)
            self._tensors[key] = hit
        return hit[2]

    @property
    def partial(self) -> bool:
        """True when a step inserts only a sample of the members
        (``index_size < 1``)."""
        return bool(np.any(self.class_take < self.class_sizes))

    def draw_members(self, generator: torch.Generator) -> torch.Tensor | None:
        """(n,) bool: this step's inserted members, or None for a whole
        index.  One ``torch.rand(n)`` key from ``generator`` (f64, so ties
        are negligible); a stable sort by (class, key) puts each class's
        vertices in a uniformly random order, and the first ``class_take``
        of each class are kept: an exact-size, uniform sample without
        replacement of every class.  The JAX package draws a
        ``jax.random.permutation`` a class (``candidates.py:320-321``),
        which torch cannot reproduce."""
        if not self.partial:
            return None
        t = self.tensors(generator.device)
        key = torch.rand(self.n, generator=generator, device=generator.device, dtype=torch.float64)
        order = _argsort_by(key, t.class_of)
        cls = t.class_of[order]
        pos = torch.arange(self.n, device=generator.device) - t.class_start[cls]
        inside = torch.empty((self.n,), dtype=torch.bool, device=generator.device)
        inside[order] = pos < t.class_take[cls]
        return inside

    def structures(self, positions, inv_w, weights, colors, opts, blk_t=None, in_index=None):
        """This step's structures (``build_span_structures``)."""
        return build_span_structures(positions, inv_w, weights, colors, self, opts, blk_t, in_index)

    def blk_t_tensor(self, device: torch.device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.blk_t, np.int32), device=device)

    def work_items(self, device: torch.device) -> torch.Tensor:
        """The sweep's (items, 4) int32 work-item table of these windows
        (``span_sweep.work_items``) on ``device``."""
        return torch.as_tensor(work_items(self.blk_t), device=device)

    def can_grow(self) -> bool:
        """False once every (query block, target row) window already
        scans the whole target row — growth could not add candidates."""
        return bool(np.any(self.blk_t < self.row_tiles[None, :]))

    def grow_from_needs(
        self, needs: np.ndarray, headroom: float = 1.3
    ) -> "SpanIndex | None":
        """Widen each starved (query block, target row) window to its own
        measured need (``SpanStructures.need``, (NB, R) members).  Each
        growth takes ``headroom`` slack and at least doubles the starved
        window, so growth events per window are O(log tiles); windows
        exactly at capacity get one spare tile.  Returns the regrown index,
        or None if nothing changes."""
        needs = np.asarray(needs, np.int64)
        # zero-need windows need zero tiles; otherwise ceil(need / ST)
        min_tiles = np.where(needs > 0, -(-needs // _ST), 0)
        starved = min_tiles > self.blk_t
        # +2 margin tiles: needs rise through the expansion phase, and every
        # starvation costs a loop exit and a host round trip
        need_tiles = -(-(needs * headroom).astype(np.int64) // _ST) + 2
        tight = (min_tiles == self.blk_t) & (self.blk_t > 0)
        t_new = np.where(
            starved,
            np.maximum(need_tiles, 2 * self.blk_t),
            np.where(tight, self.blk_t + 1, self.blk_t),
        )
        t_new = np.minimum(t_new, self.row_tiles[None, :])
        if np.array_equal(t_new, self.blk_t):
            return None
        return self._with_blk_t(t_new)

    def grow_all(self, needs: np.ndarray | None = None) -> "SpanIndex | None":
        """Widen every LIVE window (nonzero width or nonzero measured need)
        by one tile: the escalation after repeated overflow that the
        measured needs call covered.  Additive and restricted to live
        windows, so it never resurrects empty ones."""
        live = self.blk_t > 0
        if needs is not None:
            live = live | (np.asarray(needs) > 0)
        t_new = np.minimum(
            self.blk_t.astype(np.int64) + live.astype(np.int64),
            self.row_tiles[None, :],
        )
        if np.array_equal(t_new, self.blk_t):
            return None
        return self._with_blk_t(t_new)

    def resize_to_needs(
        self, needs: np.ndarray, headroom: float = 1.3
    ) -> "SpanIndex | None":
        """Two-sided resize at presize time: every window to its measured
        need, zero-need windows to 0 tiles.  A window that later needs more
        reports overflow and regrows."""
        needs = np.asarray(needs, np.int64)
        t_new = np.where(
            needs > 0,
            -(-(needs * headroom).astype(np.int64) // _ST),
            0,
        )
        t_new = np.minimum(t_new, self.row_tiles[None, :])
        if np.array_equal(t_new, self.blk_t):
            return None
        return self._with_blk_t(t_new)

    def shrink_to_needs(
        self, needs: np.ndarray, headroom: float = 1.5, slack: int = 2
    ) -> "SpanIndex | None":
        """One-sided shrink at segment boundaries: windows more than
        ``slack`` tiles above the growth sizing drop to it, zero-need
        windows drop to 0.  Healthy and starved windows are untouched, and
        a freshly grown window sits exactly at the shrink target, so shrink
        and growth do not fight."""
        needs = np.asarray(needs, np.int64)
        target = np.where(
            needs > 0,
            -(-(needs * headroom).astype(np.int64) // _ST) + 1,
            0,
        )
        target = np.minimum(target, self.row_tiles[None, :])
        t_new = np.where(
            needs == 0,
            0,
            np.where(self.blk_t > target + slack, target, self.blk_t),
        )
        if np.array_equal(t_new, self.blk_t):
            return None
        return self._with_blk_t(t_new)

    def _with_blk_t(self, blk_t: np.ndarray) -> "SpanIndex":
        """Same row skeleton (and device tables), new window widths."""
        blk_t = np.asarray(blk_t, np.int64)
        return replace(self, blk_t=blk_t.astype(np.int32), w=int(blk_t.sum()))

    @staticmethod
    def build(
        weights: np.ndarray,
        opts,
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        span_scale: float = 1.0,
    ) -> "SpanIndex":
        n = int(weights.shape[0])
        d = int(opts.embedding_dimension)
        L = float(opts.edge_length)
        group_of, group_sizes, bmaxpow, class_bm2, b, class_of = _merge_weight_groups(weights, opts)
        class_sizes = np.bincount(class_of)
        class_take = class_sizes.copy()
        if opts.index_size < 1.0:  # the JAX package's per-class sample (candidates.py:194-196)
            take = np.asarray([max(1, int(np.ceil(c * opts.index_size))) for c in class_sizes])
            class_take = np.where(class_sizes > 0, take, 0)

        # ---- split each group into equal-population ROWS (first-axis rank
        # bins) of ~sqrt(_Q * group_size) rounded to 512; the last row of a
        # group takes the remainder.  d == 1 has no second axis: one row per
        # group.
        row_group_l, row_sizes_l = [], []
        for g in range(b):
            sz = int(group_sizes[g])
            if d >= 2 and sz > 1024:
                pop = _round_up(max(512, int(np.sqrt(_Q * sz))), 512)
            else:
                pop = _round_up(max(sz, 1), 512)
            k = max(1, _cdiv(sz, pop))
            for r in range(k):
                row_group_l.append(g)
                row_sizes_l.append(pop if r < k - 1 else sz - (k - 1) * pop)
        rr = len(row_sizes_l)
        row_group = np.asarray(row_group_l, np.int32)
        row_sizes = np.asarray(row_sizes_l, np.int64)
        row_moff = np.concatenate([[0], np.cumsum(row_sizes)[:-1]])
        row_tiles = np.maximum(1, -(-row_sizes // _ST))
        row_pad_off = np.concatenate([[0], np.cumsum(row_tiles * _ST)[:-1]])
        q_blocks = np.maximum(1, -(-row_sizes // _Q))
        row_qoff = np.concatenate([[0], np.cumsum(q_blocks * _Q)[:-1]])
        nb = int(np.sum(q_blocks))
        blk_row = np.repeat(np.arange(rr, dtype=np.int32), q_blocks)

        # ---- initial window sizing (expected block overlap + base window +
        # conservative-radius fraction of the target row); it knows nothing
        # of the first-axis row pruning and over-provisions, so the presize
        # protocol resizes it to measured needs right away
        spread = max(float(n) ** (1.0 / d), 1e-9)
        qg = row_group[blk_row]
        frac = np.minimum(
            1.0,
            2.0 * L * bmaxpow[qg][:, None].astype(np.float64)
            * bmaxpow[row_group][None, :].astype(np.float64) / spread,
        )
        s_target = span_scale * (
            3.0 * _Q * row_sizes[None, :] / max(n, 1)
            + opts.window_capacity
            + frac * row_sizes[None, :]
        )
        blk_t = np.minimum(
            np.maximum(1, -(-np.ceil(s_target).astype(np.int64) // _ST)),
            row_tiles[None, :],
        )

        row_of_sorted = np.repeat(np.arange(rr, dtype=np.int32), row_sizes)
        sorted_moff = np.repeat(row_moff, row_sizes).astype(np.int32)
        sorted_shift_q = np.repeat(row_qoff - row_moff, row_sizes).astype(np.int32)
        npa = int(row_pad_off[-1] + row_tiles[-1] * _ST)
        src_of_pad = np.full(npa, n, np.int64)
        src_of_q = np.full(nb * _Q, n, np.int64)
        blk_first_l, blk_last_l = [], []
        for r in range(rr):
            o, sz = int(row_moff[r]), int(row_sizes[r])
            po, qo = int(row_pad_off[r]), int(row_qoff[r])
            src_of_pad[po : po + sz] = np.arange(o, o + sz)
            src_of_q[qo : qo + sz] = np.arange(o, o + sz)
            for li in range(_cdiv(sz, _Q)):
                blk_first_l.append(o + li * _Q)
                blk_last_l.append(o + min((li + 1) * _Q, sz) - 1)
        assert len(blk_first_l) == nb

        esrc, edst, edge_bm2, edge_row_ptr = _edge_tables(n, edge_src, edge_dst, class_bm2)
        return SpanIndex(
            n=n,
            d=d,
            num_groups=b,
            num_rows=rr,
            nb=nb,
            w=int(blk_t.sum()),
            row_group=row_group,
            row_sizes=row_sizes,
            row_moff=row_moff.astype(np.int64),
            row_qoff=row_qoff.astype(np.int64),
            row_pad_off=row_pad_off.astype(np.int64),
            row_tiles=row_tiles.astype(np.int64),
            bmaxpow=bmaxpow,
            group_of=group_of,
            class_bm2=class_bm2,
            class_of=class_of.astype(np.int32),
            class_sizes=class_sizes.astype(np.int64),
            class_take=class_take.astype(np.int64),
            row_of_sorted=row_of_sorted,
            sorted_moff=sorted_moff,
            sorted_shift_q=sorted_shift_q,
            src_of_pad=src_of_pad,
            src_of_q=src_of_q,
            blk_first=np.asarray(blk_first_l, np.int32),
            blk_last=np.asarray(blk_last_l, np.int32),
            blk_t=blk_t.astype(np.int32),
            blk_row=blk_row,
            edge_src=esrc,
            edge_dst=edst,
            edge_bm2=edge_bm2,
            edge_row_ptr=edge_row_ptr,
            span_scale=float(span_scale),
        )


# ----------------------------------------------------- per-step structures


class SpanStructures(NamedTuple):
    """Per-step sorted structures (the reference's updateIndex + SnnModel
    construction: projection and sort, NewWEmbedEmbedder.cpp:258-286,
    snn.cpp:97-147) and the kernel's inputs."""

    qrec: torch.Tensor  # (NQ, d+3) [pos(d), invw, lw^2, 1/invw]
    qcol: torch.Tensor  # (NQ,) i32
    srec: torch.Tensor  # (NPA, d+3) [pos(d), invw, bm2, 1/invw]
    scol: torch.Tensor  # (NPA,) i32
    blk_t: torch.Tensor  # (NB, R) i32 window widths the structures were built for
    start_tile: torch.Tensor  # (NB, R) i32 row-local window start tiles
    rank_of: torch.Tensor  # (n,) i64 local sorted rank within own row
    block_of: torch.Tensor  # (n,) i64 query block per vertex
    slot_of: torch.Tensor  # (n,) i64 query slot per vertex
    row_of: torch.Tensor  # (n,) i64 row of each vertex (dynamic per step)
    lwpow: torch.Tensor  # (n,) L * w^(1/d)
    overflow: torch.Tensor  # i64 scalar, in-radius members beyond the windows
    need: torch.Tensor  # (NB, R) i64 window members needed, from the tile-aligned start

    def covers(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """Whether the sweep of src's query block visits member dst: dst's
        row-local rank lies in the block's window on dst's row."""
        pair = self.block_of[src] * self.blk_t.shape[1] + self.row_of[dst]
        lo = self.start_tile.reshape(-1)[pair].to(torch.int64) * _ST
        hi = lo + self.blk_t.reshape(-1)[pair].to(torch.int64) * _ST
        rank = self.rank_of[dst]
        return (rank >= lo) & (rank < hi)


def _argsort_by(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """The permutation sorting by (major, minor), ties in index order: two
    stable sorts, the order ``jnp.lexsort((minor, major))`` gives."""
    o = torch.argsort(minor, stable=True)
    return o[torch.argsort(major[o], stable=True)]


class BuildSteps(NamedTuple):
    """What ``build_span_structures`` hands its records and windows
    kernels."""

    records_args: tuple  # span_records's: (order, positions, vrec, x, y, t, in_index)
    records: span_build.SpanRecords  # their outputs
    windows_args: tuple  # span_windows's: (sorted values, y, order1, t, blk_t as int32)


def build_steps(
    positions: torch.Tensor,
    inv_w: torch.Tensor,
    weights: torch.Tensor,
    colors: torch.Tensor,
    idx: SpanIndex,
    opts,
    blk_t: torch.Tensor | None = None,
    in_index: torch.Tensor | None = None,
) -> BuildSteps:
    """The build up to its windows: the principal frame, both sorts and the
    records, with the windows' arguments (``build_span_structures``)."""
    d = positions.shape[1]
    dtype, device = positions.dtype, positions.device
    t = idx.tensors(device)
    if blk_t is None:
        blk_t = idx.blk_t_tensor(device)
    blk_t = blk_t.to(torch.int32).contiguous()

    _, proj = span_build.principal_frame(positions, 2)
    y = proj[0]  # binning axis
    x = proj[1] if d >= 2 else y  # d == 1: search the projection itself

    # sort 1: (group, y) gives each vertex's first-axis rank, hence its row;
    # sort 2: (row, x), composed so no inverse is needed
    order1 = _argsort_by(y, t.group_of)
    order = order1[_argsort_by(x[order1], t.row_key)]

    vrec = idx.vertex_records(weights, inv_w, colors, dtype, float(opts.edge_length))
    records_args = (order, positions, vrec, x, y, t, in_index)
    rec = span_build.span_records(*records_args)
    return BuildSteps(records_args, rec, (rec.sorted, y, order1, t, blk_t))


def build_span_structures(
    positions: torch.Tensor,
    inv_w: torch.Tensor,
    weights: torch.Tensor,
    colors: torch.Tensor,
    idx: SpanIndex,
    opts,
    blk_t: torch.Tensor | None = None,
    in_index: torch.Tensor | None = None,
) -> SpanStructures:
    """Two-level sort: bin every group's members into rows by first-axis
    rank, sort each row by the second axis, and place every (block, row)
    window of ``blk_t`` tiles (default: the index's own) from conservative
    bounds in both axes (rows beyond the first-axis reach get empty
    windows).  Runs in ``positions.dtype`` (f32 or f64).

    ``in_index`` ((n,) bool, ``SpanIndex.draw_members``) leaves the other
    vertices out of the members: their member records get the sentinel
    position and a zero radius factor.  The overflow still counts
    in-radius members beyond the windows whether sampled or not: a
    conservative count, so the windows may grow where the JAX package's
    spans would not, though the sampled set within them is the same."""
    lwpow = idx.lwpow(weights, positions.dtype, float(opts.edge_length))
    steps = build_steps(positions, inv_w, weights, colors, idx, opts, blk_t, in_index)
    rec = steps.records
    start_tile, need, overflow = span_build.span_windows(*steps.windows_args)
    return SpanStructures(
        qrec=rec.qrec,
        qcol=rec.qcol,
        srec=rec.srec,
        scol=rec.scol,
        blk_t=steps.windows_args[4],
        start_tile=start_tile,
        rank_of=rec.inv[:, 0],
        block_of=rec.inv[:, 1],
        slot_of=rec.inv[:, 2],
        row_of=rec.inv[:, 3],
        lwpow=lwpow,
        overflow=overflow,
        need=need,
    )


# -------------------------------------------------------- sweep and edges


def block_items(idx: SpanIndex, b0: int, b1: int) -> tuple[int, int]:
    """The slice [lo, hi) of the index's work-item table
    (``span_sweep.work_items``) that holds the items of query blocks
    [b0, b1): the table is block-major, so one binary search on its block
    column finds it (a halo rank's share in resident mode)."""
    lo, hi = np.searchsorted(work_items(idx.blk_t)[:, 0], [b0, b1])
    return int(lo), int(hi)


def _sweep(s, idx, opts, items: torch.Tensor | None = None, share=None, sweep=None):
    """The kernel's per-slot results back on vertices: (force (n, d),
    rep_loss, candidate count (i64), zero_count (n,) i32), for either
    layout's index and structures.  ``items`` is the work-item table of
    the windows (or capacities) ``s`` was built for (default: the index's,
    copied to the device here), or a contiguous slice of it; ``share``
    sweeps its slice of them.  ``sweep(span_sweep, *args, **kw)``, when
    given, makes the kernel's call (a captured step's,
    ``core/step.py:StepGraph``)."""
    device = s.qrec.device
    t = idx.tensors(device)
    if items is None:
        items = idx.work_items(device)
    if share is not None:
        lo, hi = share.cut(items.shape[0])
        items = items[lo:hi]
    args = (s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off)
    kw = dict(dim=idx.d, L=opts.edge_length, rep_scale=opts.repulsion_scale,
              additive=opts.additive_weights, items=items)
    force_q, loss_q, count_q, zero_q = (
        span_sweep(*args, **kw) if sweep is None else sweep(span_sweep, *args, **kw)
    )
    return (
        force_q[s.slot_of],
        torch.sum(loss_q),
        torch.sum(count_q, dtype=torch.int64),
        zero_q[s.slot_of],
    )


def span_fused_forces(
    positions: torch.Tensor,
    inv_w: torch.Tensor,
    weights: torch.Tensor,
    colors: torch.Tensor,
    idx: SpanIndex,
    opts,
    generator: torch.Generator,
    structures: SpanStructures | None = None,
    blk_t: torch.Tensor | None = None,
    items: torch.Tensor | None = None,
    in_index: torch.Tensor | None = None,
    share=None,
    sweep=None,
):
    """The sweep plus ONE edge pass (``edge_pass.edge_pass``, mode
    "fused") doing attraction and the neighbour correction together: both act along pos_dst - pos_src with a scalar
    coefficient a directed edge, so they share one per-vertex segment sum.
    Attraction pulls src toward dst past the hinge, dist * ws > L
    (NewWEmbedEmbedder.cpp:188-219); removing the sweep's repulsion of a
    neighbour pair is the same-direction pull.  Coincident edge endpoints
    get a random unit kick from ``generator`` instead
    (NewWEmbedEmbedder.cpp:197-200): a raw (E, d) normal draw, whole on
    every rank, a row normalised by the pass where it kicks.

    ``idx`` is a ``SpanIndex`` or a ``span_compact.CellIndex`` (whose
    ``blk_t`` are its (NB, 1) capacities).  ``blk_t`` and ``items``
    (default: the index's windows and work items) go together;
    ``in_index`` is the step's member sample of a partial
    index (``SpanIndex.draw_members``); ``share`` (anything with
    ``cut(total) -> (lo, hi)``, ``core/step.py:Share``) computes one rank's
    partial: its slice of the work items and its range of the edges;
    ``sweep`` makes the kernel's call (``_sweep``).
    Returns (force (n, d), att_loss, rep_loss, rep_count, overflow,
    zero_count (n,) i32)."""
    d = positions.shape[1]
    if structures is None:
        structures = idx.structures(positions, inv_w, weights, colors, opts, blk_t, in_index)
    force_k, rep_loss, rep_count, zero_count = _sweep(structures, idx, opts, items, share, sweep)
    t = idx.tensors(positions.device)
    lo, hi, row_ptr = edge_share(t.edge_row_ptr, t.edge_src.shape[0], share)
    # kicks are drawn every step and selected by mask, so that no host
    # branch (and no synchronisation) decides whether any edge needs one;
    # the pass normalises the raw draw's rows at the edges it kicks
    kicks = normal_rows(generator, idx.edge_src.shape[0], d, positions.dtype)
    e = edges.edge_pass(
        "fused", positions, inv_w, t.edge_src[lo:hi], t.edge_dst[lo:hi], row_ptr, opts,
        kicks=kicks[lo:hi], schedule=t.edge_schedules.get(lo, hi), structures=structures,
        colors=colors, bm2=t.edge_bm2[lo:hi],
        in_index=in_index, force=force_k, zero_count=zero_count,
    )
    return (
        e.force,
        e.att_loss,
        rep_loss - e.corr_loss,
        rep_count - e.corr_count,
        structures.overflow,
        e.zero_count,
    )


def span_repulsion_forces(
    positions: torch.Tensor,
    inv_w: torch.Tensor,
    weights: torch.Tensor,
    colors: torch.Tensor,
    idx: SpanIndex,
    opts,
    structures: SpanStructures | None = None,
    blk_t: torch.Tensor | None = None,
    items: torch.Tensor | None = None,
    in_index: torch.Tensor | None = None,
):
    """Repulsion alone: the sweep and the O(E) neighbour correction over
    the index's directed edges (all of them, or a halo rank's chunk of
    them), for either layout's index, with ``in_index`` as in
    ``span_fused_forces``.  ``items`` may be a slice of the work items.

    Returns (force (n, d), rep_loss, rep_count, overflow, zero_count (n,)
    i32).  The count uses each member's per-doubling-class radius, so it is
    the reference's per-class candidate count when no window truncates."""
    if structures is None:
        structures = idx.structures(positions, inv_w, weights, colors, opts, blk_t, in_index)
    force_k, loss, count, zero_count = _sweep(structures, idx, opts, items)
    t = idx.tensors(positions.device)
    e = edges.edge_pass(
        "correction", positions, inv_w, t.edge_src, t.edge_dst, t.edge_row_ptr, opts,
        schedule=t.edge_schedules.get(), structures=structures, colors=colors, bm2=t.edge_bm2,
        in_index=in_index,
        force=force_k, zero_count=zero_count,
    )
    return e.force, loss - e.corr_loss, count - e.corr_count, structures.overflow, e.zero_count
