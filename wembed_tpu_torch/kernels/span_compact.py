"""The cell span layout: three-level binning and per-block compaction of
the window members, swept by the span kernel.

Counterpart of ``wembed_tpu/kernels/span_compact.py`` (the JAX package's
answer, for d >= 3, to the windowed layout's pruning on two axes only; in
the reference's terms an output-sensitive filter, src/SNN/src/snn.cpp:
149-160):

  1. ``CellIndex`` (numpy, built once per embedder and on every capacity
     change): the merged weight groups of the windowed layout, each split
     into equal-population ROWS by first-axis rank, each row into
     equal-population CELLS by second-axis rank, level populations on the
     geometric ladder size -> size/rho -> size/rho^2 with
     rho = (size/256)^(1/3).  Query blocks are 256-slot chunks of a cell.
     Each block has a capacity ``cap_t`` of 256-member tiles; grow, resize
     and shrink size it from measured needs with the JAX package's
     arithmetic.
  2. ``build_cell_structures`` (torch, every step): project on the first
     three principal axes (``span_build.principal_frame``, three CUDA
     kernels on the card), three stable sorts ((group, y), (row, x),
     (cell, z)), and per (query block, cell) a window: none for a cell
     whose row or cell extent lies beyond the block's reach on the first
     or second axis, else a searchsorted on the cell's third-axis values.
     Each block's window members, cell-major and z-ascending within a
     cell, are COMPACTED into its slice of one member array, cut at
     ``cap_t * 256`` slots; the cut members are the overflow.
  3. The sweep is ``kernels/span_sweep.py`` unchanged: the compact array is
     a windowed layout of one row, with ``blk_t = cap_t[:, None]``,
     ``start_tile`` each block's first compact tile and ``tile_off = [0]``,
     and work items cut from ``cap_t[:, None]`` on the host once per
     capacity change.  Capacity tiles past a block's kept members hold
     sentinel members: the JAX package's in-trace work list skips them,
     this port sweeps them (no per-step work list).
  4. The neighbour correction is the windowed path's one edge pass
     (``span_sparse.span_fused_forces`` / ``span_repulsion_forces``); only
     its coverage test is the layout's, ``CellStructures.covers``.

The layout runs where the JAX package runs it: ``span_layout="cells"``, f32,
a whole index, no negative sampling, one device
(``EmbedderOptions.resolve_span_layout``; the multi-device embedders keep
windows).  The structures run in ``positions.dtype`` all the same.

What the TPU layout needed and the port drops: the bucketed work-list
length ``w_pad`` with its recompile ladder, the dummy query block, the
in-trace ``qblk``/``stile``/``first`` work list, the packed and bitcast
gathers, the transposed gather (``gather_rows_transposed``), and the host
needs mirror (``measure_cell_needs_host``, ``_host_axes3``): needs come
from this module's build, presize included.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import NamedTuple

import numpy as np
import torch

from ..core.edge_schedule import EdgeSchedules
from . import span_build, span_sparse
from .span_build import _Q_SENTINEL, _S_SENTINEL, _with_record_sentinel, _with_sentinel
from .span_sparse import _argsort_by, _cdiv
from .span_sweep import Q as _Q, ST as _ST, work_items

_CELL_MIN = 512  # groups up to this size stay one row of one cell


def _level_populations(sz: int) -> tuple[int, int]:
    """(row population, cell population) of a group of ``sz`` members:
    the geometric ladder sz -> row -> cell -> _Q of ratio
    rho = (sz / _Q)^(1/3)."""
    rho = max((sz / _Q) ** (1.0 / 3.0), 1.0)
    row_pop = int(np.clip(round(sz / rho), _Q, sz))
    cell_pop = int(np.clip(round(sz / (rho * rho)), _Q, row_pop))
    return row_pop, cell_pop


class CellTensors(NamedTuple):
    """The index's position-independent tables on one device."""

    group_of: torch.Tensor  # (n,) i64
    class_bm2: torch.Tensor  # (n,) f32
    row_of_sorted1: torch.Tensor  # (n,) i64 row of each sort-1 rank
    cell_of_sorted2: torch.Tensor  # (n,) i64 cell of each sort-2 (and sort-3) rank
    cell_moff_of_sorted: torch.Tensor  # (n,) i64 first rank of each rank's cell
    sorted_shift_q: torch.Tensor  # (n,) i64 query slot minus sorted rank
    src_of_q: torch.Tensor  # (NQ,) i64 sorted rank of each query slot, n = sentinel
    blk_first: torch.Tensor  # (NB,) i64 first sorted rank of each block
    blk_last: torch.Tensor  # (NB,) i64
    row_lo: torch.Tensor  # (R,) i64 first sort-1 rank of each row
    row_hi: torch.Tensor  # (R,) i64 last
    cell_lo: torch.Tensor  # (CE,) i64 first sort-2 rank of each cell
    cell_hi: torch.Tensor  # (CE,) i64 last
    cell_row: torch.Tensor  # (CE,) i64
    cell_grid: torch.Tensor  # (CE, max cell size) i64 sorted rank, n = past the cell
    bmax_cell: torch.Tensor  # (CE,) f32 group bmax^(1/d) of each cell
    tile_off: torch.Tensor  # (1,) i32 zero: the compact array is one row
    edge_src: torch.Tensor  # (2m,) i64 src-sorted directed edges
    edge_dst: torch.Tensor  # (2m,) i64
    edge_bm2: torch.Tensor  # (2m,) f32 class_bm2 of each edge's dst
    edge_row_ptr: torch.Tensor  # (n+1,) i64 CSR offsets
    edge_schedules: EdgeSchedules  # the edge pass kernel's schedules of these edges and their shares


@dataclass(frozen=True)
class CellIndex:
    """Static skeleton of the cell index.  Every field is numpy or python:
    nothing here depends on positions.  The growth state is ``cap_t``, the
    capacity of each query block in tiles of 256 members."""

    n: int
    d: int
    num_groups: int  # B
    num_rows: int  # R
    num_cells: int  # CE
    nb: int  # NB query blocks
    # row tables (R,)
    row_group: np.ndarray
    row_sizes: np.ndarray
    row_moff: np.ndarray  # first rank of each row
    # cell tables (CE,)
    cell_row: np.ndarray
    cell_group: np.ndarray
    cell_sizes: np.ndarray
    cell_moff: np.ndarray
    # group tables (B,)
    bmaxpow: np.ndarray  # f32 bmax_g^(1/d)
    # per-vertex static
    group_of: np.ndarray
    class_bm2: np.ndarray  # (n,) f32 per doubling class max^(2/d), as SpanIndex's
    # sorted-rank static vectors (n,)
    row_of_sorted1: np.ndarray
    cell_of_sorted2: np.ndarray
    cell_moff_of_sorted: np.ndarray
    sorted_shift_q: np.ndarray
    # query side
    src_of_q: np.ndarray  # (NQ,) = (NB * _Q,)
    blk_first: np.ndarray  # (NB,) first sorted rank of each block
    blk_last: np.ndarray  # (NB,)
    cap_t: np.ndarray  # (NB,) i64 capacity tiles of each block
    # directed edges in CSR (src-sorted) order, as SpanIndex's
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_bm2: np.ndarray
    edge_row_ptr: np.ndarray
    # device copies of the static tables, shared by every resized index
    _tensors: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def w(self) -> int:
        """Capacity tiles, swept every step."""
        return int(self.cap_t.sum())

    @property
    def nq(self) -> int:
        return int(self.nb * _Q)

    def tensors(self, device: torch.device) -> CellTensors:
        """The static tables on ``device``, built once per skeleton."""
        key = str(device)
        cached = self._tensors.get(key)
        if cached is None:
            max_sz = int(np.max(self.cell_sizes))
            k = np.arange(max_sz)[None, :]
            grid = np.where(k < self.cell_sizes[:, None], self.cell_moff[:, None] + k, self.n)

            def i64(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=device)

            def f32(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=device)

            edge_dst = i64(self.edge_dst)
            cached = CellTensors(
                group_of=i64(self.group_of),
                class_bm2=f32(self.class_bm2),
                row_of_sorted1=i64(self.row_of_sorted1),
                cell_of_sorted2=i64(self.cell_of_sorted2),
                cell_moff_of_sorted=i64(self.cell_moff_of_sorted),
                sorted_shift_q=i64(self.sorted_shift_q),
                src_of_q=i64(self.src_of_q),
                blk_first=i64(self.blk_first),
                blk_last=i64(self.blk_last),
                row_lo=i64(self.row_moff),
                row_hi=i64(self.row_moff + self.row_sizes - 1),
                cell_lo=i64(self.cell_moff),
                cell_hi=i64(self.cell_moff + self.cell_sizes - 1),
                cell_row=i64(self.cell_row),
                cell_grid=i64(grid),
                bmax_cell=f32(self.bmaxpow[self.cell_group]),
                tile_off=torch.zeros((1,), dtype=torch.int32, device=device),
                edge_src=i64(self.edge_src),
                edge_dst=edge_dst,
                edge_bm2=f32(self.edge_bm2),
                edge_row_ptr=i64(self.edge_row_ptr),
                edge_schedules=EdgeSchedules(self.edge_row_ptr, edge_dst),
            )
            self._tensors[key] = cached
        return cached

    def structures(self, positions, inv_w, weights, colors, opts, blk_t=None, in_index=None):
        """This step's structures (``build_cell_structures``)."""
        if in_index is not None:
            raise ValueError("a cell index inserts every vertex (index_size >= 1)")
        return build_cell_structures(positions, inv_w, weights, colors, self, opts, blk_t)

    def draw_members(self, generator: torch.Generator) -> None:
        """None: a cell index is always whole, so a step draws no sample."""
        return None

    def blk_t_tensor(self, device: torch.device) -> torch.Tensor:
        """The capacities as the sweep's (NB, 1) int32 window widths."""
        return torch.as_tensor(np.asarray(self.cap_t, np.int32)[:, None], device=device)

    def work_items(self, device: torch.device) -> torch.Tensor:
        """The sweep's (items, 4) int32 work-item table of the capacities
        (``span_sweep.work_items`` of the one-row layout) on ``device``."""
        return torch.as_tensor(work_items(self.cap_t[:, None]), device=device)

    # ---- the capacity protocol, the windowed layout's rules per block
    # (needs in members a block; ``core/span_driver.py``)
    def can_grow(self) -> bool:
        return bool(np.any(self.cap_t < _cdiv(self.n, _ST)))

    def grow_from_needs(self, needs: np.ndarray, headroom: float = 1.3) -> "CellIndex | None":
        """``SpanIndex.grow_from_needs`` per block: starved capacities at
        least double and take ``headroom`` plus 2 margin tiles; a capacity
        exactly at its need gets one spare tile."""
        needs = np.asarray(needs, np.int64)
        min_tiles = np.where(needs > 0, -(-needs // _ST), 0)
        starved = min_tiles > self.cap_t
        need_tiles = -(-(needs * headroom).astype(np.int64) // _ST) + 2
        tight = (min_tiles == self.cap_t) & (self.cap_t > 0)
        t_new = np.where(
            starved,
            np.maximum(need_tiles, 2 * self.cap_t),
            np.where(tight, self.cap_t + 1, self.cap_t),
        )
        return self._changed(np.minimum(t_new, _cdiv(self.n, _ST)))

    def grow_all(self, needs: np.ndarray | None = None) -> "CellIndex | None":
        """One more tile for every live block (nonzero capacity or need)."""
        live = self.cap_t > 0
        if needs is not None:
            live = live | (np.asarray(needs) > 0)
        return self._changed(np.minimum(self.cap_t + live.astype(np.int64), _cdiv(self.n, _ST)))

    def resize_to_needs(self, needs: np.ndarray, headroom: float = 1.3) -> "CellIndex | None":
        """Presize: every capacity to its need times ``headroom``."""
        needs = np.asarray(needs, np.int64)
        t_new = np.where(needs > 0, -(-(needs * headroom).astype(np.int64) // _ST), 0)
        return self._changed(np.minimum(t_new, _cdiv(self.n, _ST)))

    def shrink_to_needs(
        self, needs: np.ndarray, headroom: float = 1.5, slack: int = 2
    ) -> "CellIndex | None":
        """Capacities more than ``slack`` tiles above the growth sizing drop
        to it; zero-need blocks drop to 0."""
        needs = np.asarray(needs, np.int64)
        target = np.where(needs > 0, -(-(needs * headroom).astype(np.int64) // _ST) + 1, 0)
        target = np.minimum(target, _cdiv(self.n, _ST))
        t_new = np.where(
            needs == 0, 0, np.where(self.cap_t > target + slack, target, self.cap_t)
        )
        return self._changed(t_new)

    def _changed(self, cap_t: np.ndarray) -> "CellIndex | None":
        if np.array_equal(cap_t, self.cap_t):
            return None
        return self._with_caps(cap_t)

    def _with_caps(self, cap_t: np.ndarray) -> "CellIndex":
        """Same skeleton (and device tables), new capacities."""
        return replace(self, cap_t=np.asarray(cap_t, np.int64))

    @staticmethod
    def build(
        weights: np.ndarray,
        opts,
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
    ) -> "CellIndex":
        n = int(weights.shape[0])
        d = int(opts.embedding_dimension)
        group_of, group_sizes, bmaxpow, class_bm2, b, _ = span_sparse._merge_weight_groups(
            weights, opts
        )

        # rows and cells: equal-population splits, no alignment
        row_group_l, row_sizes_l = [], []
        cell_row_l, cell_sizes_l = [], []
        for g in range(b):
            sz = int(group_sizes[g])
            row_pop, cell_pop = (sz, sz) if sz <= _CELL_MIN else _level_populations(sz)
            nrows = max(1, _cdiv(sz, row_pop))
            base, extra = divmod(sz, nrows)
            for r in range(nrows):
                rsz = base + (1 if r < extra else 0)
                row_group_l.append(g)
                row_sizes_l.append(rsz)
                ncells = max(1, _cdiv(rsz, cell_pop))
                cbase, cextra = divmod(rsz, ncells)
                for ci in range(ncells):
                    cell_row_l.append(len(row_sizes_l) - 1)
                    cell_sizes_l.append(cbase + (1 if ci < cextra else 0))
        rr, ce = len(row_sizes_l), len(cell_sizes_l)
        row_group = np.asarray(row_group_l, np.int32)
        row_sizes = np.asarray(row_sizes_l, np.int64)
        row_moff = np.concatenate([[0], np.cumsum(row_sizes)[:-1]])
        cell_row = np.asarray(cell_row_l, np.int32)
        cell_sizes = np.asarray(cell_sizes_l, np.int64)
        cell_moff = np.concatenate([[0], np.cumsum(cell_sizes)[:-1]])

        # query blocks: 256-slot chunks of each cell
        q_blocks = np.maximum(1, -(-cell_sizes // _Q))
        nb = int(q_blocks.sum())
        cell_qoff = np.concatenate([[0], np.cumsum(q_blocks * _Q)[:-1]])
        src_of_q = np.full(nb * _Q, n, np.int64)
        blk_first_l, blk_last_l = [], []
        for c_ in range(ce):
            o, sz, qo = int(cell_moff[c_]), int(cell_sizes[c_]), int(cell_qoff[c_])
            src_of_q[qo : qo + sz] = np.arange(o, o + sz)
            for li in range(max(1, _cdiv(sz, _Q))):
                blk_first_l.append(o + min(li * _Q, max(sz - 1, 0)))
                blk_last_l.append(o + min((li + 1) * _Q, sz) - 1 if sz else o)

        esrc, edst, edge_bm2, edge_row_ptr = span_sparse._edge_tables(n, edge_src, edge_dst, class_bm2)
        return CellIndex(
            n=n,
            d=d,
            num_groups=b,
            num_rows=rr,
            num_cells=ce,
            nb=nb,
            row_group=row_group,
            row_sizes=row_sizes,
            row_moff=row_moff.astype(np.int64),
            cell_row=cell_row,
            cell_group=row_group[cell_row],
            cell_sizes=cell_sizes,
            cell_moff=cell_moff.astype(np.int64),
            bmaxpow=bmaxpow,
            group_of=group_of,
            class_bm2=class_bm2,
            row_of_sorted1=np.repeat(np.arange(rr, dtype=np.int32), row_sizes),
            cell_of_sorted2=np.repeat(np.arange(ce, dtype=np.int32), cell_sizes),
            cell_moff_of_sorted=np.repeat(cell_moff, cell_sizes).astype(np.int32),
            sorted_shift_q=np.repeat(cell_qoff - cell_moff, cell_sizes).astype(np.int32),
            src_of_q=src_of_q,
            blk_first=np.asarray(blk_first_l, np.int64),
            blk_last=np.asarray(blk_last_l, np.int64),
            # a coarse start: the embedder's presize resizes to measured needs
            cap_t=np.full(nb, 4, np.int64),
            edge_src=esrc,
            edge_dst=edst,
            edge_bm2=edge_bm2,
            edge_row_ptr=edge_row_ptr,
        )


class CellStructures(NamedTuple):
    """Per-step sorted structures of the cell layout and the sweep's
    inputs, in the windowed layout's form with one row."""

    qrec: torch.Tensor  # (NQ, d+3) [pos(d), invw, lw^2, 1/invw]
    qcol: torch.Tensor  # (NQ,) i32
    srec: torch.Tensor  # (NCA, d+3) compacted members [pos(d), invw, bm2, 1/invw]
    scol: torch.Tensor  # (NCA,) i32
    blk_t: torch.Tensor  # (NB, 1) i32 capacities in tiles
    start_tile: torch.Tensor  # (NB, 1) i32 first compact tile of each block
    rank_of: torch.Tensor  # (n,) i64 rank within its cell
    block_of: torch.Tensor  # (n,) i64 query block
    slot_of: torch.Tensor  # (n,) i64 query slot
    row_of: torch.Tensor  # (n,) i64 cell of each vertex
    lwpow: torch.Tensor  # (n,) L * w^(1/d)
    overflow: torch.Tensor  # i64 scalar, window members cut by the capacities
    need: torch.Tensor  # (NB,) i64 window members of each block
    start: torch.Tensor  # (NB, CE) i64 cell-local window start
    stop: torch.Tensor  # (NB, CE) i64
    prefix: torch.Tensor  # (NB, CE) i64 members of the block's earlier cells

    def covers(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """Whether the sweep of src's query block visits member dst: dst's
        cell-local rank lies in the block's window on dst's cell, and the
        block's capacity did not cut it (``span_compact.py:815-832``)."""
        blk = self.block_of[src]
        pair = blk * self.start.shape[1] + self.row_of[dst]
        rank = self.rank_of[dst]
        lo = self.start.reshape(-1)[pair]
        return (
            (rank >= lo)
            & (rank < self.stop.reshape(-1)[pair])
            & (self.prefix.reshape(-1)[pair] + (rank - lo) < self.blk_t[blk, 0].to(torch.int64) * _ST)
        )


def build_cell_structures(
    positions: torch.Tensor,
    inv_w: torch.Tensor,
    weights: torch.Tensor,
    colors: torch.Tensor,
    idx: CellIndex,
    opts,
    blk_t: torch.Tensor | None = None,
) -> CellStructures:
    """Three sorts, the per-(block, cell) windows pruned on all three
    leading axes, and the compaction of each block's members.  ``blk_t``
    is the index's capacities as (NB, 1) int32 on the device (default: made
    from ``idx.cap_t``); the compact array has ``idx.w`` tiles.  Runs in
    ``positions.dtype`` (f32 or f64)."""
    n, d = positions.shape
    dtype, device = positions.dtype, positions.device
    t = idx.tensors(device)
    L = float(opts.edge_length)
    nb = idx.nb
    if blk_t is None:
        blk_t = idx.blk_t_tensor(device)

    _, proj = span_build.principal_frame(positions, 3)
    y, x, z = proj  # rows, cells, within a cell

    # stable sorts, so ties go by index as in the JAX package's lexsorts:
    # (group, y) ranks give rows, (row, x) ranks cells, then (cell, z)
    order1 = _argsort_by(y, t.group_of)
    order2 = order1[_argsort_by(x[order1], t.row_of_sorted1)]
    order = order2[_argsort_by(z[order2], t.cell_of_sorted2)]

    lwpow = L * torch.pow(weights.to(dtype), 1.0 / d)
    pos_s = positions[order]
    invw_s = inv_w.to(dtype)[order]
    lwpow_s = lwpow[order]
    col_s = colors[order]
    z_s = z[order]
    rawexp_s = 1.0 / invw_s

    qvals = torch.cat(
        [pos_s, invw_s[:, None], (lwpow_s * lwpow_s)[:, None], rawexp_s[:, None]], dim=1
    )
    qrec = _with_record_sentinel(qvals, _Q_SENTINEL)[t.src_of_q]
    qcol = _with_sentinel(col_s, -2)[t.src_of_q].to(torch.int32)

    # ---- per-block extents: z at static ranks (a block is a z-sorted run
    # of its cell), y, x and the largest radius factor by masked reductions
    minz = z_s[t.blk_first]
    maxz = z_s[t.blk_last]
    qmask = (t.src_of_q < n).view(nb, _Q)
    maxlw = _with_sentinel(lwpow_s, 0.0)[t.src_of_q].view(nb, _Q).amax(dim=1)
    big = torch.finfo(dtype).max

    def block_range(values):
        v = _with_sentinel(values[order], 0.0)[t.src_of_q].view(nb, _Q)
        return torch.where(qmask, v, big).amin(dim=1), torch.where(qmask, v, -big).amax(dim=1)

    ymin_blk, ymax_blk = block_range(y)
    xmin_blk, xmax_blk = block_range(x)
    # row and cell extents at static ranks of sorts 1 and 2
    row_ymin = y[order1[t.row_lo]][t.cell_row]
    row_ymax = y[order1[t.row_hi]][t.cell_row]
    cell_xmin = x[order2[t.cell_lo]]
    cell_xmax = x[order2[t.cell_hi]]

    reach = maxlw[:, None] * t.bmax_cell.to(dtype)[None, :]  # (NB, CE)
    overlap = (
        (ymin_blk[:, None] - reach <= row_ymax[None, :])
        & (ymax_blk[:, None] + reach >= row_ymin[None, :])
        & (xmin_blk[:, None] - reach <= cell_xmax[None, :])
        & (xmax_blk[:, None] + reach >= cell_xmin[None, :])
    )
    lo = minz[:, None] - reach
    hi = maxz[:, None] + reach
    # every bound in one batched search over the cells' sorted z, +inf past
    # each cell's end: cell-local ranks
    zcells = _with_sentinel(z_s, float("inf"))[t.cell_grid]  # (CE, max cell size)
    start = torch.searchsorted(zcells, lo.T.contiguous(), side="left").T
    stop = torch.searchsorted(zcells, hi.T.contiguous(), side="right").T
    start = torch.where(overlap, start, 0)
    stop = torch.where(overlap, stop, 0)
    sizes = stop - start  # (NB, CE)

    cap = blk_t[:, 0].to(torch.int64)
    cap_slots = cap * _ST
    need = torch.sum(sizes, dim=1)
    overflow = torch.sum(torch.clamp_min(need - cap_slots, 0))

    # ---- compaction: segment (block, cell) holds the block's members of
    # that cell's window, placed after the block's earlier cells and cut at
    # its capacity.  Segment starts rise with (block, cell), so each slot's
    # segment is the last start at or before it.
    prefix = torch.cumsum(sizes, dim=1) - sizes
    kept = torch.clamp_min(torch.minimum(sizes, cap_slots[:, None] - prefix), 0).reshape(-1)
    cap_off = torch.cumsum(cap, 0) - cap
    seg_start = (cap_off[:, None] * _ST + torch.minimum(prefix, cap_slots[:, None])).reshape(-1)
    seg_rank = (t.cell_lo[None, :] + start).reshape(-1)  # sorted rank of each segment's first
    slot = torch.arange(idx.w * _ST, device=device)
    seg = torch.searchsorted(seg_start, slot, right=True) - 1
    within = slot - seg_start[seg]
    member = torch.where(within < kept[seg], seg_rank[seg] + within, n)

    bm2_s = t.class_bm2.to(dtype)[order]
    svals = torch.cat([pos_s, invw_s[:, None], bm2_s[:, None], rawexp_s[:, None]], dim=1)
    srec = _with_record_sentinel(svals, _S_SENTINEL)[member]
    scol = _with_sentinel(col_s, -3)[member].to(torch.int32)

    # inverse maps: cell-local rank, query block, query slot and cell of
    # each vertex, one index write through the permutation ``order``
    j = torch.arange(n, device=device)
    q_idx = j + t.sorted_shift_q
    inv = torch.empty((n, 4), dtype=torch.int64, device=device)
    inv[order] = torch.stack([j - t.cell_moff_of_sorted, q_idx // _Q, q_idx, t.cell_of_sorted2], dim=1)

    return CellStructures(
        qrec=qrec.contiguous(),
        qcol=qcol,
        srec=srec.contiguous(),
        scol=scol,
        blk_t=blk_t.to(torch.int32).contiguous(),
        start_tile=cap_off[:, None].to(torch.int32),
        rank_of=inv[:, 0],
        block_of=inv[:, 1],
        slot_of=inv[:, 2],
        row_of=inv[:, 3],
        lwpow=lwpow,
        overflow=overflow,
        need=need,
        start=start,
        stop=stop,
        prefix=prefix,
    )


def cell_fused_forces(positions, inv_w, weights, colors, idx: CellIndex, opts, generator,
                      structures: CellStructures | None = None, blk_t=None, items=None):
    """Counterpart of ``span_compact.py:cell_fused_forces``: the cells sweep
    and the span path's one edge pass of attraction and neighbour
    correction (``span_sparse.span_fused_forces``, which takes either
    layout).  Same returns."""
    return span_sparse.span_fused_forces(
        positions, inv_w, weights, colors, idx, opts, generator, structures, blk_t, items
    )


def cell_repulsion_forces(positions, inv_w, weights, colors, idx: CellIndex, opts,
                          structures: CellStructures | None = None, blk_t=None, items=None):
    """Counterpart of ``span_compact.py:cell_repulsion_forces``: the cells
    sweep and the neighbour correction (``span_sparse.span_repulsion_forces``).
    Returns (force, rep_loss, rep_count, overflow, zero_count)."""
    return span_sparse.span_repulsion_forces(
        positions, inv_w, weights, colors, idx, opts, structures, blk_t, items
    )
