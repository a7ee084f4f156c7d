"""The span edge pass: attraction and the neighbour correction over the
directed edges, each source vertex's edges summed, in one CUDA launch.

Not a port of a TPU kernel.  The JAX package runs this pass as plain jnp
(``wembed_tpu/kernels/span_sparse.py:_edge_sides``, ``_edge_inclusion``,
``span_fused_forces``, ``span_repulsion_forces``;
``wembed_tpu/core/forces.py:attraction_forces``).  The port ran it as
about 90 torch launches behind row gathers and a ``segment_reduce``; that
code is ``edge_pass_reference``, the plain version, and the kernel
(``csrc/edge_pass.cu``) repeats its operations in their order.

Three modes over the src-sorted directed edges (src, dst) that are given
(all of an index's, or a share's contiguous range, with ``row_ptr`` the
CSR offsets into them):

  fused        attraction and the neighbour correction
               (``span_sparse.span_fused_forces``)
  correction   the neighbour correction alone
               (``span_sparse.span_repulsion_forces``)
  attraction   attraction alone (``core/forces.py:attraction_forces``)

Per edge, with diff = pos[dst] - pos[src] and dist2 summed over the
dimensions in ascending order:

  attraction   dist * ws > L pulls src toward dst with attraction_scale *
               ws / dist (NewWEmbedEmbedder.cpp:188-219), loss dist - L/ws;
               where the endpoints coincide the edge's row is its kick: the
               caller's raw normal draw of that edge, normalised
               (``core/edge_geometry.py:unit_rows``)
  correction   a pair the sweep counted (the same radius product, the
               layout's coverage, the colour filter and, under a partial
               index, dst's membership) and repelled (dist2 * ws^2 <= L^2,
               dist2 > 0) gets the sweep's repulsion back as a pull; its
               loss, count and coincident count are taken back as well

The rows are summed per source vertex in edge order, starting from 0
(``torch.segment_reduce``'s order), and added to the given per-vertex
force: the sweep's, in the span modes.

``edge_pass`` launches the kernel for CUDA tensors (f32 or f64, any d)
and runs ``edge_pass_reference`` for CPU tensors; both check their inputs
alike.  A pass is one launch, segment-major over the edge set's schedule
(``core/edge_schedule.py``), with no scratch rows: at d <= 8
``segment_pass_kernel<T, D, C>``, its row in registers; above,
``segment_pass_general_kernel<T, C>``, an edge a lane in rounds of 32 (its
row read ``SLAB`` = 16 f32 columns at a time into registers for dist2, the
row itself staged in shared memory where it fits them), then the rows
folded a lane a column (a heavy segment's CTA: warp 0 folds while 7 warps
compute, up to ``SPLIT_DIM`` columns; the whole CTA folds wider rows).
``edge_pass.launches`` counts every pass the kernel makes,
``edge_pass.launches_general`` those of the general variant.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.edge_geometry import edge_attraction, edge_geometry, segment_sum, unit_rows
from ..core.edge_schedule import LIGHT, WARPS, EdgeSchedule
from . import _build
from .span_sweep import ST as _ST

MODES = ("fused", "correction", "attraction")
MAX_FAST_DIM = 8  # the widest row of segment_pass_kernel; wider rows take the general variant
SLAB = 16  # the general variant: an f32 lane's row slab (f64: 8), and the staged rows' width
SPLIT_DIM = 32  # the widest row whose heavy-segment fold is one warp's beside seven computing warps
_BLOCK = 256  # threads of a CTA in csrc/edge_pass.cu


class EdgePass(NamedTuple):
    """One pass's results; ``None`` where its mode computes nothing."""

    force: torch.Tensor  # (n, d) the given force plus each vertex's edge sum (attraction: the sum)
    zero_count: torch.Tensor | None  # (n,) i32 the given counts less the counted coincident neighbours
    att_loss: torch.Tensor | None  # attraction loss
    corr_loss: torch.Tensor | None  # the sweep's loss over the neighbour pairs it repelled
    corr_count: torch.Tensor | None  # i64 neighbour pairs the sweep counted


# ------------------------------------------------------------ plain version


class _EdgeTerms(NamedTuple):
    diff: torch.Tensor  # (E, d) pos[dst] - pos[src]
    dist2: torch.Tensor
    ws: torch.Tensor
    included: torch.Tensor  # the sweep counted (src, dst) as a candidate
    active_r: torch.Tensor  # ... and repelled it
    l_over_ws: torch.Tensor  # L/ws as the sweep formed it


def _edge_terms(positions, inv_w, colors, s, src, dst, bm2, opts, in_index=None) -> _EdgeTerms:
    """Per directed edge (src, dst): the distance, the weight scale, and
    whether the sweep counted and repelled the pair.  The sweep's query is
    src and its member dst, so every test repeats the sweep's own f32
    operations: dist2 over dimensions in ascending k, the radius test as
    lw_src^2 * bm2_dst, the colour filter, under a partial index dst's
    membership (``wembed_tpu/core/candidates.py:836-837``), and the
    layout's coverage of dst by src's block (``s.covers``: a window of
    ``span_sparse.SpanStructures``, or a cell window and the block's
    capacity of ``span_compact.CellStructures``)."""
    dtype = positions.dtype
    diff, dist2 = edge_geometry(positions, src, dst)
    iw = inv_w.to(dtype)
    iw_s, iw_d = iw[src], iw[dst]
    ws = iw_s + iw_d if opts.additive_weights else iw_s * iw_d
    lw = s.lwpow[src]
    included = (dist2 <= (lw * lw) * bm2.to(dtype)) & s.covers(src, dst) & (colors[src] != colors[dst])
    if in_index is not None:
        included = included & in_index[dst]
    L = float(opts.edge_length)
    active_r = included & (dist2 * (ws * ws) <= L * L) & (dist2 > 0)
    if opts.additive_weights:
        l_over_ws = L / ws
    else:
        l_over_ws = (L * (1.0 / iw_s)) * (1.0 / iw_d)
    return _EdgeTerms(diff, dist2, ws, included, active_r, l_over_ws)


def _correction_tallies(e: _EdgeTerms, dist: torch.Tensor, row_ptr: torch.Tensor):
    """(loss, count, per-vertex zero counts) of the neighbour pairs the sweep
    included, to take back from the sweep's totals."""
    loss = torch.sum(torch.where(e.active_r, e.l_over_ws - dist, 0.0))
    count = torch.sum(e.included, dtype=torch.int64)
    zero = segment_sum((e.included & ~(e.dist2 > 0)).to(dist.dtype), row_ptr)
    return loss, count, zero.to(torch.int32)


def edge_pass_reference(
    mode: str,
    positions: torch.Tensor,
    inv_w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    row_ptr: torch.Tensor,
    opts,
    *,
    kicks: torch.Tensor | None = None,
    schedule: EdgeSchedule | None = None,
    structures=None,
    colors: torch.Tensor | None = None,
    bm2: torch.Tensor | None = None,
    in_index: torch.Tensor | None = None,
    force: torch.Tensor | None = None,
    zero_count: torch.Tensor | None = None,
) -> EdgePass:
    """Plain PyTorch version of the kernel, with ``edge_pass``'s arguments
    and results (it needs no ``schedule``)."""
    if mode == "attraction":
        diff, dist2 = edge_geometry(positions, src, dst)
        iw = inv_w.to(positions.dtype)
        force_e, loss = edge_attraction(diff, dist2, iw[src], iw[dst], opts, kicks)
        return EdgePass(segment_sum(force_e, row_ptr), None, loss, None, None)
    e = _edge_terms(positions, inv_w, colors, structures, src, dst, bm2, opts, in_index)
    dist = torch.sqrt(e.dist2)
    att_loss = None
    if mode == "fused":
        # both act along pos_dst - pos_src with a scalar coefficient an
        # edge, so they share one per-vertex segment sum
        L = float(opts.edge_length)
        inv_dist = 1.0 / torch.clamp_min(dist, 1e-30)
        act_a = dist * e.ws > L
        ca = torch.where(act_a, opts.attraction_scale * e.ws * inv_dist, 0.0)
        att_loss = torch.sum(torch.where(act_a, dist - L / e.ws, 0.0))
        cr = torch.where(e.active_r, opts.repulsion_scale * e.ws * inv_dist, 0.0)
        net_e = (ca + cr)[:, None] * e.diff
        net_e = torch.where((e.dist2 > 0)[:, None], net_e, unit_rows(kicks))
    else:
        cr = torch.where(e.active_r, opts.repulsion_scale * e.ws * (1.0 / dist), 0.0)
        net_e = cr[:, None] * e.diff
    loss_c, count_c, zero_c = _correction_tallies(e, dist, row_ptr)
    return EdgePass(force + segment_sum(net_e, row_ptr), zero_count - zero_c, att_loss, loss_c, count_c)


# ------------------------------------------------------------------ kernel


class _Args(ctypes.Structure):
    """``struct Args`` of csrc/edge_pass.cu, field for field (every field
    8 bytes, so both sides lay it out alike)."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "pos", "inv_w", "row_ptr", "kicks", "bm2", "lwpow", "colors", "in_index",
            "block_of", "row_of", "rank_of", "blk_t", "start_tile", "start", "stop", "prefix",
            "base_force", "base_zero", "sched", "dst32", "part_loss", "part_count", "force",
            "zero", "loss", "count",
        )),
        *((name, ctypes.c_int64) for name in (
            "block_stride", "row_stride", "rank_stride", "blk_s0", "blk_s1", "tile_s0",
            "tile_s1", "start_s0", "start_s1", "stop_s0", "stop_s1", "prefix_s0",
            "prefix_s1", "n", "d", "E", "mode", "layout", "additive", "heavy", "medium", "groups",
        )),
        *((name, ctypes.c_double) for name in ("L", "L2", "att_scale", "rep_scale")),
    ]


_CONSTANTS = {
    "wembed_edge_pass_block": _BLOCK,
    "wembed_edge_pass_tile": _ST,
    "wembed_edge_pass_light": LIGHT,
    "wembed_edge_pass_warps": WARPS,
    "wembed_edge_pass_max_fast_dim": MAX_FAST_DIM,
    "wembed_edge_pass_slab": SLAB,
    "wembed_edge_pass_split_dim": SPLIT_DIM,
}


def _configure(lib: ctypes.CDLL) -> None:
    for name, want in _CONSTANTS.items():
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"csrc/edge_pass.cu and the package disagree on {name}: {fn()} != {want}")
    lib.wembed_edge_pass_error_string.argtypes = [ctypes.c_int]
    lib.wembed_edge_pass_error_string.restype = ctypes.c_char_p
    lib.wembed_edge_pass.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.wembed_edge_pass.restype = ctypes.c_int


def _expect(name, t, dtype, shape, *, strided=False):
    if t is None:
        raise ValueError(f"this mode of the edge pass needs {name}")
    if t.dtype != dtype:
        raise TypeError(f"the edge pass takes {name} as {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not strided and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(mode, positions, inv_w, src, dst, row_ptr, *, kicks, schedule, structures, colors, bm2,
           in_index, force, zero_count) -> None:
    """Raise on what the kernel does not take, on either device."""
    if mode not in MODES:
        raise ValueError(f"edge pass mode {mode!r}, expected one of {MODES}")
    if positions.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the edge pass takes positions as float32 or float64, got {positions.dtype}")
    if positions.dim() != 2 or positions.shape[1] < 1:
        raise ValueError(f"positions must be (n, d) with d >= 1, got {tuple(positions.shape)}")
    n, d = positions.shape
    dtype, num_edges = positions.dtype, src.shape[0]
    expected = [
        ("positions", positions, dtype, (n, d)),
        ("inv_w", inv_w, dtype, (n,)),
        ("src", src, torch.int64, (num_edges,)),
        ("dst", dst, torch.int64, (num_edges,)),
        ("row_ptr", row_ptr, torch.int64, (n + 1,)),
    ]
    if mode != "correction":
        expected.append(("kicks", kicks, dtype, (num_edges, d)))
    strided = []
    if mode != "attraction":
        s = structures
        if s is None:
            raise ValueError("the span modes of the edge pass need the step's structures")
        expected += [
            ("colors", colors, torch.int32, (n,)),
            ("bm2", bm2, torch.float32, (num_edges,)),
            ("force", force, dtype, (n, d)),
            ("zero_count", zero_count, torch.int32, (n,)),
            ("lwpow", s.lwpow, dtype, (n,)),
        ]
        if in_index is not None:
            expected.append(("in_index", in_index, torch.bool, (n,)))
        strided = [(name, getattr(s, name), torch.int64, (n,)) for name in ("block_of", "row_of", "rank_of")]
        nb = s.blk_t.shape[0]
        if hasattr(s, "prefix"):  # the cell layout's structures
            ce = s.start.shape[1]
            strided += [(name, getattr(s, name), torch.int64, (nb, ce)) for name in ("start", "stop", "prefix")]
            strided.append(("blk_t", s.blk_t, torch.int32, (nb, 1)))
        else:
            strided += [(name, getattr(s, name), torch.int32, s.blk_t.shape) for name in ("blk_t", "start_tile")]
    for name, t, want, shape in expected:
        _expect(name, t, want, shape)
    for name, t, want, shape in strided:
        _expect(name, t, want, shape, strided=True)
    if schedule is not None:
        if (schedule.n, schedule.num_edges) != (n, num_edges):
            raise ValueError(f"the schedule is of {schedule.n} vertices and {schedule.num_edges} edges, "
                             f"the pass of {n} and {num_edges}")
        entries = schedule.heavy + schedule.medium + schedule.groups
        for item in (("the schedule's dst", schedule.dst, torch.int32, (num_edges,)),
                     ("the schedule's table", schedule.table, torch.int64, (entries, 4))):
            _expect(*item)
            expected.append(item)
    for name, t, _, _ in [*expected, *strided]:
        if t.device != positions.device:
            raise ValueError(f"{name} is on {t.device}, positions on {positions.device}")


def edge_pass(
    mode: str,
    positions: torch.Tensor,
    inv_w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    row_ptr: torch.Tensor,
    opts,
    *,
    kicks: torch.Tensor | None = None,
    schedule: EdgeSchedule | None = None,
    structures=None,
    colors: torch.Tensor | None = None,
    bm2: torch.Tensor | None = None,
    in_index: torch.Tensor | None = None,
    force: torch.Tensor | None = None,
    zero_count: torch.Tensor | None = None,
) -> EdgePass:
    """One edge pass (``mode``: fused, correction or attraction) over the
    directed edges (``src``, ``dst``), src-sorted, with ``row_ptr`` (n+1,)
    their CSR offsets.  ``inv_w`` is taken in the positions' dtype.

    ``kicks`` (fused, attraction): (E, d) the edges' raw normal draws, a
    row normalised (``unit_rows``) where its edge's endpoints coincide.
    ``schedule``: these edges' schedule (``core/edge_schedule.py``, held
    beside each edge set); the kernel needs it.  The span modes
    take the step's ``structures`` (either layout's), the vertices'
    ``colors`` (i32), ``bm2`` (E,) f32 the radius factor of each edge's dst,
    ``in_index`` (n,) bool the step's members under a partial index (or
    None), and the sweep's per-vertex ``force`` and ``zero_count``.

    CUDA tensors go through the kernel on the current stream, without
    synchronising; CPU tensors through the plain version."""
    kw = dict(kicks=kicks, schedule=schedule, structures=structures, colors=colors, bm2=bm2,
              in_index=in_index, force=force, zero_count=zero_count)
    inv_w = inv_w.to(positions.dtype)
    _check(mode, positions, inv_w, src, dst, row_ptr, **kw)
    if positions.device.type == "cpu":
        return edge_pass_reference(mode, positions, inv_w, src, dst, row_ptr, opts, **kw)
    if positions.device.type != "cuda":
        raise ValueError(f"no edge_pass kernel for device {positions.device}")
    if schedule is None:
        raise ValueError("the edge pass kernel needs the edges' schedule (core/edge_schedule.py)")
    lib = _build.load("edge_pass", _configure)
    n, d = positions.shape
    dtype, device = positions.dtype, positions.device
    span = mode != "attraction"
    part_loss = torch.empty((schedule.ctas, 2), dtype=dtype, device=device)  # one slot a CTA
    part_count = torch.empty((schedule.ctas,), dtype=torch.int64, device=device)
    out = torch.empty((n, d), dtype=dtype, device=device)
    zero = torch.empty((n,), dtype=torch.int32, device=device) if span else None
    loss = torch.empty((2,), dtype=dtype, device=device)
    count = torch.empty((1,), dtype=torch.int64, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    L = float(opts.edge_length)
    a = _Args(
        pos=ptr(positions), inv_w=ptr(inv_w), row_ptr=ptr(row_ptr),
        kicks=ptr(kicks) if mode != "correction" else None, part_loss=ptr(part_loss),
        part_count=ptr(part_count), force=ptr(out), loss=ptr(loss), count=ptr(count),
        n=n, d=d, E=src.shape[0], mode=MODES.index(mode), additive=int(bool(opts.additive_weights)),
        L=L, L2=L * L, att_scale=float(opts.attraction_scale), rep_scale=float(opts.repulsion_scale),
        sched=ptr(schedule.table), dst32=ptr(schedule.dst),
        heavy=schedule.heavy, medium=schedule.medium, groups=schedule.groups,
    )
    if span:  # the span modes' inputs; attraction reads none of them
        s = structures
        a.bm2, a.colors, a.in_index, a.lwpow = ptr(bm2), ptr(colors), ptr(in_index), ptr(s.lwpow)
        a.base_force, a.base_zero, a.zero = ptr(force), ptr(zero_count), ptr(zero)
        for name in ("block", "row", "rank"):
            t = getattr(s, f"{name}_of")
            setattr(a, f"{name}_of", ptr(t))
            setattr(a, f"{name}_stride", t.stride(0))
        a.blk_t = ptr(s.blk_t)
        a.blk_s0, a.blk_s1 = s.blk_t.stride()
        if hasattr(s, "prefix"):
            a.layout = 1
            for name in ("start", "stop", "prefix"):
                t = getattr(s, name)
                setattr(a, name, ptr(t))
                setattr(a, f"{name}_s0", t.stride(0))
                setattr(a, f"{name}_s1", t.stride(1))
        else:
            a.start_tile = ptr(s.start_tile)
            a.tile_s0, a.tile_s1 = s.start_tile.stride()
    rc = lib.wembed_edge_pass(
        ctypes.byref(a), int(dtype == torch.float64), device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        msg = lib.wembed_edge_pass_error_string(rc).decode()
        raise RuntimeError(f"edge_pass kernel launch failed: {msg} (cudaError {rc})")
    edge_pass.launches += 1
    if d > MAX_FAST_DIM:
        edge_pass.launches_general += 1
    if not span:
        return EdgePass(out, None, loss[0], None, None)
    return EdgePass(out, zero, loss[0] if mode == "fused" else None, loss[1], count[0])


edge_pass.launches = 0  # passes the kernel made; the plain version is not counted
edge_pass.launches_general = 0  # of which the general variant's (d > 8)
