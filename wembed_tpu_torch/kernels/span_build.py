"""The span structures build's three hand kernels: the principal axes, the
records and the windows of one step.

Not a port of a TPU kernel.  The JAX package builds the span structures as
plain jnp, which XLA fuses into one program
(``wembed_tpu/kernels/span_sparse.py:917 build_span_structures``, with
``wembed_tpu/core/candidates.py:409 _power_iteration`` and ``:429
_principal_axes2``).  The port ran it as ~300 small torch launches a step;
those torch lines are the plain versions here, and each kernel of
``csrc/span_build.cu`` repeats its plain version's operations in their
order, so it is bitwise its plain version.

  principal_axes   the first K = 2 (windows) or 3 (cells) principal axes of
                   a (d, d) covariance: power iteration, deflation,
                   re-orthogonalisation, in one single-CTA launch
                   (``principal_axes_kernel<T, K>``); the plain version
                   folds every product and norm in ascending k, one
                   multiply and one add a term
  span_records     the query and member records and colours the sweep
                   reads, the four inverse maps and the sorted projections,
                   one thread a slot (``span_records_kernel<T, D>``)
  span_windows     each (query block, row) window's start tile and need,
                   and the overflow, one CTA a query block
                   (``span_windows_kernel<T>``)

Each wrapper launches its kernel for CUDA tensors, on the current stream
without synchronising (a failed build or launch raises), and runs its plain
version (``*_reference``) for CPU tensors.  ``<wrapper>.launches`` counts
the kernel's launches; the plain versions are not counted.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .span_sweep import Q as _Q, ST as _ST

ITERS = 12  # power iterations an axis (the JAX package's)
MAX_FAST_DIM = 8  # span_records_kernel's widest templated row; wider rows take its general instance
_Q_SENTINEL = 1e15  # padded query position (far positive)
_S_SENTINEL = -1e15  # padded member position (far negative; never coincides
# with a query sentinel, so sentinel x padding pairs keep dist2 > 0)
_FLOATS = (torch.float32, torch.float64)


def _with_sentinel(rows: torch.Tensor, value) -> torch.Tensor:
    """``rows`` and one more row ``value`` at index n, which padding slots
    read; made on the device (a host tensor would cost a synchronising
    copy every step)."""
    extra = torch.full((1, *rows.shape[1:]), value, dtype=rows.dtype, device=rows.device)
    return torch.cat([rows, extra])


def _with_record_sentinel(rows: torch.Tensor, position: float) -> torch.Tensor:
    """(n, d+3) records and a sentinel record at index n: far away at
    ``position``, invw 1, radius factor and 1/invw 0."""
    extra = torch.zeros((1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    extra[:, : rows.shape[1] - 3] = position
    extra[:, rows.shape[1] - 3] = 1.0
    return torch.cat([rows, extra])


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _expect(name: str, t, dtype, shape, device) -> None:
    if t is None:
        raise ValueError(f"the span build needs {name}")
    if t.dtype != dtype:
        raise TypeError(f"the span build takes {name} as {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _launch(fn, args, f64: bool, device: torch.device, what: str) -> None:
    rc = fn(ctypes.byref(args), int(f64), device.index, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = _library().wembed_span_build_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


# ------------------------------------------------------------ principal axes


def _fold(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0] * b[0] + a[1] * b[1] + ..., each product rounded alone and the
    sum folded in ascending k (0-dim)."""
    p = a * b
    s = p[0]
    for k in range(1, p.shape[0]):
        s = s + p[k]
    return s


def _matvec(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """c @ v with each row folded in ascending k: w = c[:, 0] * v[0], then
    w + c[:, k] * v[k]."""
    w = c[:, 0] * v[0]
    for k in range(1, c.shape[1]):
        w = w + c[:, k] * v[k]
    return w


def _power_iteration(c: torch.Tensor, iters: int) -> torch.Tensor:
    """Dominant eigenvector of a (d, d) PSD matrix: ``iters`` steps from the
    perturbed all-ones start; a zero iterate keeps the previous vector."""
    d = c.shape[0]
    v = torch.full((d,), 1.0, dtype=c.dtype, device=c.device) + torch.arange(
        d, dtype=c.dtype, device=c.device
    ) * 1e-3
    v = v / torch.sqrt(_fold(v, v))
    for _ in range(iters):
        w = _matvec(c, v)
        norm = torch.sqrt(_fold(w, w))
        v = torch.where(norm > 0, w / torch.where(norm > 0, norm, 1.0), v)
    return v


def _normalised(v: torch.Tensor) -> torch.Tensor:
    """``v`` over its norm, or ``v`` itself when the norm is at most 1e-12
    (a degenerate axis: collinear points, or d < 3 for the third)."""
    norm = torch.sqrt(_fold(v, v))
    return torch.where(norm > 1e-12, v / torch.where(norm > 0, norm, 1.0), v)


def principal_axes_reference(cov: torch.Tensor, k: int, iters: int = ITERS) -> torch.Tensor:
    """Plain version of ``principal_axes``: (k, d) axes, v1 by power
    iteration on ``cov``, v2 on cov1 = cov - lam1 v1 v1^T re-orthogonalised
    against v1, and for k = 3, v3 on cov1 - lam2 v2 v2^T re-orthogonalised
    against v1 and v2 (lam = v . (c v)).  The same arithmetic as the JAX
    package's ``_principal_axes2`` / ``_principal_axes3``, its products and
    norms folded in ascending k."""
    v1 = _power_iteration(cov, iters)
    cov1 = cov - _fold(v1, _matvec(cov, v1)) * torch.outer(v1, v1)
    v2 = _power_iteration(cov1, iters)
    v2 = _normalised(v2 - _fold(v2, v1) * v1)
    axes = [v1, v2]
    if k == 3:
        cov2 = cov1 - _fold(v2, _matvec(cov1, v2)) * torch.outer(v2, v2)
        v3 = _power_iteration(cov2, iters)
        axes.append(_normalised(v3 - _fold(v3, v1) * v1 - _fold(v3, v2) * v2))
    return torch.stack(axes)


class _AxesArgs(ctypes.Structure):
    """``struct AxesArgs`` of csrc/span_build.cu."""

    _fields_ = [("cov", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("d", ctypes.c_int64), ("k", ctypes.c_int64), ("iters", ctypes.c_int64)]


def principal_axes(cov: torch.Tensor, k: int, iters: int = ITERS) -> torch.Tensor:
    """The first ``k`` (2 or 3) principal axes, (k, d) in ``cov``'s dtype,
    of the (d, d) covariance ``cov`` (f32 or f64): one launch of
    ``principal_axes_kernel`` on a CUDA tensor, ``principal_axes_reference``
    on a CPU tensor."""
    if k not in (2, 3):
        raise ValueError(f"principal_axes takes k = 2 or 3, got {k}")
    if cov.dtype not in _FLOATS:
        raise TypeError(f"principal_axes takes float32 or float64, got {cov.dtype}")
    if cov.dim() != 2 or cov.shape[0] != cov.shape[1] or cov.shape[0] < 1:
        raise ValueError(f"principal_axes takes a (d, d) matrix, got {tuple(cov.shape)}")
    if cov.device.type == "cpu":
        return principal_axes_reference(cov, k, iters)
    if cov.device.type != "cuda":
        raise ValueError(f"no principal_axes kernel for device {cov.device}")
    d = cov.shape[0]
    cov = cov.contiguous()
    out = torch.empty((k, d), dtype=cov.dtype, device=cov.device)
    args = _AxesArgs(cov=_ptr(cov), out=_ptr(out), d=d, k=k, iters=iters)
    _launch(_library().wembed_principal_axes, args, cov.dtype == torch.float64, cov.device, "principal_axes")
    principal_axes.launches += 1
    return out


principal_axes.launches = 0


# ------------------------------------------------------------------ records


class SpanRecords(NamedTuple):
    """What the build gathers through the step's permutation ``order``."""

    qrec: torch.Tensor  # (NQ, d+3) [pos(d), invw, lw^2, 1/invw]
    qcol: torch.Tensor  # (NQ,) i32, -2 at padding
    srec: torch.Tensor  # (NPA, d+3) [pos(d), invw, bm2, 1/invw]
    scol: torch.Tensor  # (NPA,) i32, -3 at padding
    inv: torch.Tensor  # (n, 4) i64 rank in its row, query block, query slot and row of each vertex
    sorted: torch.Tensor  # (3, n) x, y and lw = L * w^(1/d) in sorted order


def span_records_reference(order, positions, inv_w, lwpow, colors, x, y, t, in_index=None) -> SpanRecords:
    """Plain version of ``span_records``: the records gathered through the
    static slot maps of ``t`` (``span_sparse.SpanTensors``), sentinels at
    padding slots, a vertex outside ``in_index`` (a partial index's
    members) given the member sentinel position and a zero radius factor;
    the inverse maps written through ``order``."""
    n = positions.shape[0]
    dtype, device = positions.dtype, positions.device
    pos_s = positions[order]
    invw_s = inv_w.to(dtype)[order]
    lwpow_s = lwpow[order]
    col_s = colors[order]
    rawexp_s = 1.0 / invw_s
    mpos_s, bm2_s = pos_s, t.class_bm2.to(dtype)[order]
    if in_index is not None:
        member = in_index[order]
        mpos_s = torch.where(member[:, None], pos_s, _S_SENTINEL)
        bm2_s = torch.where(member, bm2_s, 0.0)
    svals = torch.cat([mpos_s, invw_s[:, None], bm2_s[:, None], rawexp_s[:, None]], dim=1)
    srec = _with_record_sentinel(svals, _S_SENTINEL)[t.src_of_pad]
    qvals = torch.cat(
        [pos_s, invw_s[:, None], (lwpow_s * lwpow_s)[:, None], rawexp_s[:, None]], dim=1
    )
    qrec = _with_record_sentinel(qvals, _Q_SENTINEL)[t.src_of_q]
    scol = _with_sentinel(col_s, -3)[t.src_of_pad].to(torch.int32)
    qcol = _with_sentinel(col_s, -2)[t.src_of_q].to(torch.int32)
    # inverse maps: row-local rank, query block, query slot and row of each
    # vertex, one index write through the permutation ``order``
    j = torch.arange(n, device=device)
    q_idx = j + t.sorted_shift_q
    inv = torch.empty((n, 4), dtype=torch.int64, device=device)
    inv[order] = torch.stack([j - t.sorted_moff, q_idx // _Q, q_idx, t.row_of_sorted], dim=1)
    return SpanRecords(qrec.contiguous(), qcol, srec.contiguous(), scol, inv,
                       torch.stack([x[order], y[order], lwpow_s]))


class _RecordsArgs(ctypes.Structure):
    """``struct RecordsArgs`` of csrc/span_build.cu, field for field."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "order", "pos", "inv_w", "lwpow", "colors", "class_bm2", "in_index", "x", "y", "src_of_q",
            "src_of_pad", "sorted_shift_q", "sorted_moff", "row_of_sorted", "qrec", "qcol", "srec",
            "scol", "inv", "sorted",
        )),
        *((name, ctypes.c_int64) for name in ("n", "d", "nq", "npa")),
    ]


def span_records(order, positions, inv_w, lwpow, colors, x, y, t, in_index=None) -> SpanRecords:
    """The step's records through the permutation ``order`` ((n,) i64,
    sorted rank -> vertex): ``positions`` (n, d) f32 or f64, ``inv_w``,
    ``lwpow`` (L * w^(1/d)) and the projections ``x`` (second axis; at d
    = 1 the first) and ``y`` (first axis), all (n,) in the positions'
    dtype, ``colors`` (n,) i32, the index's static tables ``t``
    (``span_sparse.SpanTensors``) and ``in_index`` ((n,) bool) under a
    partial index.  One launch of ``span_records_kernel`` on CUDA tensors,
    ``span_records_reference`` on CPU tensors."""
    n, d = positions.shape
    dtype, device = positions.dtype, positions.device
    if dtype not in _FLOATS:
        raise TypeError(f"span_records takes positions as float32 or float64, got {dtype}")
    nq, npa = t.src_of_q.shape[0], t.src_of_pad.shape[0]
    for item in (
        ("order", order, torch.int64, (n,)), ("inv_w", inv_w, dtype, (n,)), ("lwpow", lwpow, dtype, (n,)),
        ("colors", colors, torch.int32, (n,)), ("x", x, dtype, (n,)), ("y", y, dtype, (n,)),
        ("class_bm2", t.class_bm2, torch.float32, (n,)), ("src_of_q", t.src_of_q, torch.int64, (nq,)),
        ("src_of_pad", t.src_of_pad, torch.int64, (npa,)),
        ("sorted_shift_q", t.sorted_shift_q, torch.int64, (n,)),
        ("sorted_moff", t.sorted_moff, torch.int64, (n,)),
        ("row_of_sorted", t.row_of_sorted, torch.int64, (n,)),
        *((("in_index", in_index, torch.bool, (n,)),) if in_index is not None else ()),
    ):
        _expect(*item, device)
    if device.type == "cpu":
        return span_records_reference(order, positions, inv_w, lwpow, colors, x, y, t, in_index)
    if device.type != "cuda":
        raise ValueError(f"no span_records kernel for device {device}")
    out = SpanRecords(
        qrec=torch.empty((nq, d + 3), dtype=dtype, device=device),
        qcol=torch.empty((nq,), dtype=torch.int32, device=device),
        srec=torch.empty((npa, d + 3), dtype=dtype, device=device),
        scol=torch.empty((npa,), dtype=torch.int32, device=device),
        inv=torch.empty((n, 4), dtype=torch.int64, device=device),
        sorted=torch.empty((3, n), dtype=dtype, device=device),
    )
    inputs = dict(order=order, pos=positions, inv_w=inv_w, lwpow=lwpow, colors=colors, class_bm2=t.class_bm2,
                  in_index=in_index, x=x, y=y, src_of_q=t.src_of_q, src_of_pad=t.src_of_pad,
                  sorted_shift_q=t.sorted_shift_q, sorted_moff=t.sorted_moff, row_of_sorted=t.row_of_sorted)
    keep = {name: None if v is None else v.contiguous() for name, v in inputs.items()}
    args = _RecordsArgs(**{name: _ptr(v) for name, v in keep.items()},
                        **{name: _ptr(v) for name, v in out._asdict().items()}, n=n, d=d, nq=nq, npa=npa)
    _launch(_library().wembed_span_records, args, dtype == torch.float64, device, "span_records")
    span_records.launches += 1
    return out


span_records.launches = 0


# ------------------------------------------------------------------ windows


def span_windows_reference(sorted_xyl, y, order1, t, blk_t):
    """Plain version of ``span_windows``: per-block conservative windows in
    both axes.  A block is a contiguous rank range of its row, so its
    second-axis extrema sit at static first/last ranks; its first-axis
    extrema need a masked reduction.  Row first-axis extrema sit at static
    ranks of the first sort.  Returns (start_tile (NB, R) i32, need (NB, R)
    i64, overflow i64)."""
    n = y.shape[0]
    dtype = y.dtype
    nb = t.blk_first.shape[0]
    x_s, y_ord, lwpow_s = sorted_xyl
    minx = x_s[t.blk_first]
    maxx = x_s[t.blk_last]
    maxlw = _with_sentinel(lwpow_s, 0.0)[t.src_of_q].view(nb, _Q).amax(dim=1)
    qmask = (t.src_of_q < n).view(nb, _Q)
    y_q = _with_sentinel(y_ord, 0.0)[t.src_of_q].view(nb, _Q)
    big = torch.finfo(dtype).max
    ymin_blk = torch.where(qmask, y_q, big).amin(dim=1)
    ymax_blk = torch.where(qmask, y_q, -big).amax(dim=1)
    row_ymin = y[order1[t.row_lo]]
    row_ymax = y[order1[t.row_hi]]

    reach = maxlw[:, None] * t.bmax_row.to(dtype)[None, :]  # (NB, R)
    overlap = (ymin_blk[:, None] - reach <= row_ymax[None, :]) & (
        ymax_blk[:, None] + reach >= row_ymin[None, :]
    )
    lo = minx[:, None] - reach
    hi = maxx[:, None] + reach
    # every bound in one batched search over the rows' sorted second-axis
    # values, +inf past each row's end
    xrows = _with_sentinel(x_s, float("inf"))[t.row_grid]  # (R, max row size)
    start = torch.searchsorted(xrows, lo.T.contiguous(), side="left").T
    stop = torch.searchsorted(xrows, hi.T.contiguous(), side="right").T
    start = torch.where(overlap, start, 0)
    stop = torch.where(overlap, stop, 0)

    # slide the T-tile window to cover [start, stop) when it can: end at
    # ceil(stop/ST), never start after floor(start/ST), stay inside the row
    t_blk = blk_t.to(torch.int64)
    start_tile = torch.minimum((stop + _ST - 1) // _ST - t_blk, start // _ST)
    start_tile = torch.minimum(torch.clamp_min(start_tile, 0), t.row_tiles[None, :] - t_blk)
    cov_end = (start_tile + t_blk) * _ST
    # per-window overflow bounded by the real need (stop - start): a window
    # shrunk to 0 tiles with no member in range reports none
    overflow = torch.sum(torch.clamp_min(torch.minimum(stop - cov_end, stop - start), 0))
    need = torch.where(stop > start, stop - (start // _ST) * _ST, 0)
    return start_tile.to(torch.int32), need, overflow


class _WindowsArgs(ctypes.Structure):
    """``struct WindowsArgs`` of csrc/span_build.cu, field for field."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "sorted", "y", "order1", "src_of_q", "blk_first", "blk_last", "row_lo", "row_hi",
            "row_tiles", "bmax_row", "blk_t", "start_tile", "need", "part", "overflow",
        )),
        *((name, ctypes.c_int64) for name in ("n", "nb", "r", "max_row")),
    ]


def span_windows(sorted_xyl, y, order1, t, blk_t):
    """Each (query block, row) window of ``blk_t`` (NB, R) tiles placed for
    this step: ``sorted_xyl`` (3, n) the sorted projections and radius
    factors (``SpanRecords.sorted``), ``y`` (n,) the first-axis projection
    by vertex, ``order1`` (n,) i64 the first sort's permutation, ``t`` the
    index's static tables.  Returns (start_tile (NB, R) i32, need (NB, R)
    i64, overflow i64).  One launch of ``span_windows_kernel`` on CUDA
    tensors (it reads ``blk_t`` as int32, in place), the plain version on
    CPU tensors."""
    n = y.shape[0]
    dtype, device = y.dtype, y.device
    if dtype not in _FLOATS:
        raise TypeError(f"span_windows takes float32 or float64, got {dtype}")
    nb, rr = t.blk_first.shape[0], t.row_lo.shape[0]
    for item in (
        ("sorted_xyl", sorted_xyl, dtype, (3, n)), ("order1", order1, torch.int64, (n,)),
        ("src_of_q", t.src_of_q, torch.int64, (nb * _Q,)), ("blk_first", t.blk_first, torch.int64, (nb,)),
        ("blk_last", t.blk_last, torch.int64, (nb,)), ("row_lo", t.row_lo, torch.int64, (rr,)),
        ("row_hi", t.row_hi, torch.int64, (rr,)), ("row_tiles", t.row_tiles, torch.int64, (rr,)),
        ("bmax_row", t.bmax_row, torch.float32, (rr,)),
    ):
        _expect(*item, device)
    if tuple(blk_t.shape) != (nb, rr) or blk_t.device != device:
        raise ValueError(f"blk_t is {tuple(blk_t.shape)} on {blk_t.device}, expected {(nb, rr)} on {device}")
    if device.type == "cpu":
        return span_windows_reference(sorted_xyl, y, order1, t, blk_t)
    if device.type != "cuda":
        raise ValueError(f"no span_windows kernel for device {device}")
    if blk_t.dtype != torch.int32 or not blk_t.is_contiguous():
        raise ValueError("the span_windows kernel reads blk_t as contiguous int32, in place")
    start_tile = torch.empty((nb, rr), dtype=torch.int32, device=device)
    need = torch.empty((nb, rr), dtype=torch.int64, device=device)
    part = torch.empty((nb,), dtype=torch.int64, device=device)
    overflow = torch.empty((), dtype=torch.int64, device=device)
    inputs = dict(sorted=sorted_xyl, y=y, order1=order1, src_of_q=t.src_of_q, blk_first=t.blk_first,
                  blk_last=t.blk_last, row_lo=t.row_lo, row_hi=t.row_hi, row_tiles=t.row_tiles,
                  bmax_row=t.bmax_row)
    keep = {name: v.contiguous() for name, v in inputs.items()}
    args = _WindowsArgs(**{name: _ptr(v) for name, v in keep.items()}, blk_t=_ptr(blk_t),
                        start_tile=_ptr(start_tile), need=_ptr(need), part=_ptr(part),
                        overflow=_ptr(overflow), n=n, nb=nb, r=rr, max_row=t.row_grid.shape[1])
    _launch(_library().wembed_span_windows, args, dtype == torch.float64, device, "span_windows")
    span_windows.launches += 1
    return start_tile, need, overflow


span_windows.launches = 0


# ------------------------------------------------------------------ library

_CONSTANTS = {
    "wembed_span_build_query_block": _Q,
    "wembed_span_build_tile": _ST,
    "wembed_span_build_max_fast_dim": MAX_FAST_DIM,
}


def _configure(lib: ctypes.CDLL) -> None:
    for name, want in _CONSTANTS.items():
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"csrc/span_build.cu and the package disagree on {name}: {fn()} != {want}")
    lib.wembed_span_build_error_string.argtypes = [ctypes.c_int]
    lib.wembed_span_build_error_string.restype = ctypes.c_char_p
    for name, struct in (("wembed_principal_axes", _AxesArgs), ("wembed_span_records", _RecordsArgs),
                         ("wembed_span_windows", _WindowsArgs)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(struct), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load("span_build", _configure)
