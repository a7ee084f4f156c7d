"""The span structures build's hand kernels: the principal frame, the
records and the windows of one step.

Not a port of a TPU kernel.  The JAX package builds the span structures as
plain jnp, which XLA fuses into one program
(``wembed_tpu/kernels/span_sparse.py:917 build_span_structures``, with
``wembed_tpu/core/candidates.py:409 _power_iteration`` and ``:429
_principal_axes2``).  The port ran it as ~300 small torch launches a step;
those torch lines are the plain versions here, and each kernel of
``csrc/span_build.cu`` repeats its plain version's operations in their
order, so it is bitwise its plain version.

  principal_frame  positions in, the first K = 2 (windows) or 3 (cells)
                   principal axes and the K projections out: at d <= 8
                   three grid-wide launches (``frame_mean_kernel<T, D>``,
                   ``frame_axes_kernel<T, D>``, ``frame_project_kernel<T,
                   D>``), the mean and the covariance summed as pairwise
                   trees; at d > 8 torch's mean, covariance and
                   projections around ``principal_axes``
  principal_axes   the first K principal axes of a (d, d) covariance:
                   power iteration, deflation, re-orthogonalisation, in one
                   single-CTA launch (``principal_axes_kernel<T, K>``); the
                   plain version folds every product and norm in ascending
                   k, one multiply and one add a term
  span_records     the query and member records and colours the sweep
                   reads, the four inverse maps and the sorted projections,
                   a CTA a section's 256 slots, each gathering one packed
                   vertex row (``vertex_records``) and writing its rows
                   through shared memory as 16-byte stores
                   (``span_records_kernel<T, D>``)
  span_windows     each (query block, row) window's start tile and need,
                   and the overflow, one CTA a query block: the bounds
                   that the row's ends do not settle found by 4 lanes
                   each in 4-ary rounds, four windows a warp, torch's own
                   binary search on a row that ends in NaN
                   (``span_windows_kernel<T>``)

Each wrapper launches its kernel for CUDA tensors, on the current stream
without synchronising (a failed build or launch raises), and runs its plain
version (``*_reference``) for CPU tensors.  ``<wrapper>.launches`` counts
the calls that launched its kernels; the plain versions are not counted.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .span_sweep import Q as _Q, ST as _ST

ITERS = 12  # power iterations an axis (the JAX package's)
MAX_FAST_DIM = 8  # the widest templated row of the frame and records kernels; wider rows take the general route
FRAME_CHUNK = 1024  # rows a CTA of frame_mean_kernel and frame_axes_kernel sums (a power of two)
VREC_WIDTH = 8  # values a vertex record: [iw, lw * lw, 1 / iw, colour bits, bm2, lw, 0, 0]
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


# ----------------------------------------------------------- principal frame


def _tree_sum(a: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0 as a pairwise tree: the rows padded with -0.0 to
    a power of two, then ``a[0::2] + a[1::2]`` until one row is left.  -0.0
    is the additive identity (x + -0.0 is x for every x, +0.0 and -0.0
    included), so the tree is the same at every power-of-two length >= n:
    the kernels cut it into aligned chunks of FRAME_CHUNK rows a CTA and
    finish it over the CTAs' partials."""
    n = a.shape[0]
    p = 1 << max(n - 1, 0).bit_length()
    if p > n:
        a = torch.cat([a, torch.full((p - n, *a.shape[1:]), -0.0, dtype=a.dtype, device=a.device)])
    while a.shape[0] > 1:
        a = a[0::2] + a[1::2]
    return a[0]


def _upper(d: int) -> tuple[list[int], list[int]]:
    """Rows and columns of the (d, d) upper triangle, row by row."""
    pairs = [(i, k) for i in range(d) for k in range(i, d)]
    return [i for i, _ in pairs], [k for _, k in pairs]


def _general_frame(positions: torch.Tensor, k: int, iters: int, axes_fn):
    """The route at d > MAX_FAST_DIM: torch's mean, centring, covariance
    product and projections around ``axes_fn`` (``principal_axes`` or its
    plain version)."""
    centered = positions - torch.mean(positions, dim=0)
    axes = axes_fn(centered.T @ centered, k, iters)
    return axes, torch.stack([centered @ axes[a] for a in range(k)])


def principal_frame_reference(positions: torch.Tensor, k: int, iters: int = ITERS):
    """Plain version of ``principal_frame``, at d <= MAX_FAST_DIM the spec
    its kernels repeat: the mean a ``_tree_sum`` of the rows divided by n
    (an elementwise division); the centred rows ``p - mean``; the
    covariance's upper triangle a ``_tree_sum`` of the products ``c_i *
    c_k``, mirrored; ``principal_axes_reference``; and each projection
    ``c . axis`` folded in ascending k (``_matvec``).  At d > MAX_FAST_DIM
    the general route (``_general_frame``)."""
    n, d = positions.shape
    if d > MAX_FAST_DIM:
        return _general_frame(positions, k, iters, principal_axes_reference)
    total = _tree_sum(positions)
    c = positions - total / torch.full_like(total, n)
    rows, cols = _upper(d)
    upper = _tree_sum(c[:, rows] * c[:, cols])
    cov = torch.empty((d, d), dtype=positions.dtype, device=positions.device)
    cov[rows, cols] = upper
    cov[cols, rows] = upper
    axes = principal_axes_reference(cov, k, iters)
    return axes, torch.stack([_matvec(c, axes[a]) for a in range(k)])


class _FrameArgs(ctypes.Structure):
    """``struct FrameArgs`` of csrc/span_build.cu, field for field."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in ("pos", "mean", "part", "axes", "proj")),
        *((name, ctypes.c_int64) for name in ("n", "d", "k", "iters", "ctas")),
    ]


def principal_frame(positions: torch.Tensor, k: int, iters: int = ITERS):
    """(axes (k, d), proj (k, n)) of the (n, d) ``positions`` (f32 or f64):
    the first ``k`` (2 or 3) principal axes of the centred rows and the
    centred rows' projection on each.  On a CUDA tensor at d <=
    MAX_FAST_DIM three launches (the mean; the covariance and, in the last
    CTA, the axes in one warp's registers; the projections), bitwise
    ``principal_frame_reference``; at a larger d the general route through
    ``principal_axes``; on a CPU tensor the plain version."""
    if k not in (2, 3):
        raise ValueError(f"principal_frame takes k = 2 or 3, got {k}")
    if positions.dtype not in _FLOATS:
        raise TypeError(f"principal_frame takes float32 or float64, got {positions.dtype}")
    if positions.dim() != 2 or positions.shape[0] < 1 or positions.shape[1] < 1:
        raise ValueError(f"principal_frame takes (n, d) positions, got {tuple(positions.shape)}")
    if positions.device.type == "cpu":
        return principal_frame_reference(positions, k, iters)
    if positions.device.type != "cuda":
        raise ValueError(f"no principal_frame kernel for device {positions.device}")
    n, d = positions.shape
    if d > MAX_FAST_DIM:
        return _general_frame(positions, k, iters, principal_axes)
    dtype, device = positions.dtype, positions.device
    positions = positions.contiguous()
    ctas = -(-n // FRAME_CHUNK)
    mean = torch.empty((d,), dtype=dtype, device=device)
    part = torch.empty((ctas, d * (d + 1) // 2), dtype=dtype, device=device)
    axes = torch.empty((k, d), dtype=dtype, device=device)
    proj = torch.empty((k, n), dtype=dtype, device=device)
    args = _FrameArgs(pos=_ptr(positions), mean=_ptr(mean), part=_ptr(part), axes=_ptr(axes), proj=_ptr(proj),
                      n=n, d=d, k=k, iters=iters, ctas=ctas)
    _launch(_library().wembed_principal_frame, args, dtype == torch.float64, device, "principal_frame")
    principal_frame.launches += 1
    return axes, proj


principal_frame.launches = 0


# ------------------------------------------------------------------ records


class SpanRecords(NamedTuple):
    """What the build gathers through the step's permutation ``order``."""

    qrec: torch.Tensor  # (NQ, d+3) [pos(d), invw, lw^2, 1/invw]
    qcol: torch.Tensor  # (NQ,) i32, -2 at padding
    srec: torch.Tensor  # (NPA, d+3) [pos(d), invw, bm2, 1/invw]
    scol: torch.Tensor  # (NPA,) i32, -3 at padding
    inv: torch.Tensor  # (n, 4) i64 rank in its row, query block, query slot and row of each vertex
    sorted: torch.Tensor  # (3, n) x, y and lw = L * w^(1/d) in sorted order


def _colour_column(vrec: torch.Tensor) -> int:
    """The int32 column of ``vrec.view(torch.int32)`` that holds the colour
    bits (the low word of value 3: little-endian)."""
    return 3 * (vrec.element_size() // 4)


def vertex_records(inv_w: torch.Tensor, lwpow: torch.Tensor, colors: torch.Tensor,
                   class_bm2: torch.Tensor) -> torch.Tensor:
    """The static vertex record ``span_records`` gathers, (n, VREC_WIDTH)
    in ``lwpow``'s dtype: [iw, lw * lw, 1 / iw, colour bits, bm2, lw, 0,
    0], each value the operation the records took every step before,
    rounded alone (``1.0 / iw`` is torch's reciprocal), the colour an
    int32 in the low word of its value.  One aligned row of 32 bytes (f32)
    or 64 (f64) a vertex; made once a weights tensor
    (``span_sparse.SpanIndex.vertex_records``)."""
    dtype = lwpow.dtype
    iw = inv_w.to(dtype)
    rec = torch.zeros((lwpow.shape[0], VREC_WIDTH), dtype=dtype, device=lwpow.device)
    rec[:, 0] = iw
    rec[:, 1] = lwpow * lwpow
    rec[:, 2] = 1.0 / iw
    rec[:, 4] = class_bm2.to(dtype)
    rec[:, 5] = lwpow
    rec.view(torch.int32)[:, _colour_column(rec)] = colors.to(torch.int32)
    return rec


def span_records_reference(order, positions, vrec, x, y, t, in_index=None) -> SpanRecords:
    """Plain version of ``span_records``: the records gathered through the
    static slot maps of ``t`` (``span_sparse.SpanTensors``), sentinels at
    padding slots, a vertex outside ``in_index`` (a partial index's
    members) given the member sentinel position and a zero radius factor;
    the inverse maps written through ``order``."""
    n = positions.shape[0]
    device = positions.device
    pos_s = positions[order]
    rec_s = vrec[order]
    invw_s, lw2_s, rawexp_s, bm2_s, lwpow_s = (rec_s[:, c] for c in (0, 1, 2, 4, 5))
    col_s = vrec.view(torch.int32)[:, _colour_column(vrec)][order]
    mpos_s = pos_s
    if in_index is not None:
        member = in_index[order]
        mpos_s = torch.where(member[:, None], pos_s, _S_SENTINEL)
        bm2_s = torch.where(member, bm2_s, 0.0)
    svals = torch.cat([mpos_s, invw_s[:, None], bm2_s[:, None], rawexp_s[:, None]], dim=1)
    srec = _with_record_sentinel(svals, _S_SENTINEL)[t.src_of_pad]
    qvals = torch.cat([pos_s, invw_s[:, None], lw2_s[:, None], rawexp_s[:, None]], dim=1)
    qrec = _with_record_sentinel(qvals, _Q_SENTINEL)[t.src_of_q]
    scol = _with_sentinel(col_s, -3)[t.src_of_pad]
    qcol = _with_sentinel(col_s, -2)[t.src_of_q]
    # inverse maps: row-local rank, query block, query slot and row of each
    # vertex, one index write through the permutation ``order``
    j = torch.arange(n, device=device)
    q_idx = j + t.sorted_shift_q
    inv = torch.empty((n, 4), dtype=torch.int64, device=device)
    inv[order] = torch.stack([j - t.sorted_moff, q_idx // _Q, q_idx, t.row_key.to(torch.int64)], dim=1)
    return SpanRecords(qrec.contiguous(), qcol, srec.contiguous(), scol, inv,
                       torch.stack([x[order], y[order], lwpow_s]))


class _RecordsArgs(ctypes.Structure):
    """``struct RecordsArgs`` of csrc/span_build.cu, field for field."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "order", "pos", "vrec", "in_index", "x", "y", "src_of_q", "src_of_pad", "sorted_shift_q",
            "sorted_moff", "row_of_sorted", "qrec", "qcol", "srec", "scol", "inv", "sorted",
        )),
        *((name, ctypes.c_int64) for name in ("n", "d", "nq", "npa")),
    ]


def span_records(order, positions, vrec, x, y, t, in_index=None) -> SpanRecords:
    """The step's records through the permutation ``order`` ((n,) i64,
    sorted rank -> vertex): ``positions`` (n, d) f32 or f64, the static
    vertex record ``vrec`` ((n, VREC_WIDTH), ``vertex_records``) and the
    projections ``x`` (second axis; at d = 1 the first) and ``y`` (first
    axis), all in the positions' dtype, the index's static tables ``t``
    (``span_sparse.SpanTensors``: the int32 slot maps) and ``in_index``
    ((n,) bool) under a partial index.  One launch of
    ``span_records_kernel`` on CUDA tensors, ``span_records_reference`` on
    CPU tensors."""
    n, d = positions.shape
    dtype, device = positions.dtype, positions.device
    if dtype not in _FLOATS:
        raise TypeError(f"span_records takes positions as float32 or float64, got {dtype}")
    nq, npa = t.src_of_q.shape[0], t.src_of_pad.shape[0]
    for item in (
        ("order", order, torch.int64, (n,)), ("vrec", vrec, dtype, (n, VREC_WIDTH)),
        ("x", x, dtype, (n,)), ("y", y, dtype, (n,)), ("src_of_q", t.src_of_q, torch.int32, (nq,)),
        ("src_of_pad", t.src_of_pad, torch.int32, (npa,)),
        ("sorted_shift_q", t.sorted_shift_q, torch.int32, (n,)),
        ("sorted_moff", t.sorted_moff, torch.int32, (n,)),
        ("row_key", t.row_key, torch.int32, (n,)),
        *((("in_index", in_index, torch.bool, (n,)),) if in_index is not None else ()),
    ):
        _expect(*item, device)
    if nq % _Q or npa % _ST:
        raise ValueError(f"span_records takes whole query blocks and tiles, got {nq} and {npa} slots")
    if device.type == "cpu":
        return span_records_reference(order, positions, vrec, x, y, t, in_index)
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
    inputs = dict(order=order, pos=positions, vrec=vrec, in_index=in_index, x=x, y=y, src_of_q=t.src_of_q,
                  src_of_pad=t.src_of_pad, sorted_shift_q=t.sorted_shift_q, sorted_moff=t.sorted_moff,
                  row_of_sorted=t.row_key)
    keep = {name: None if v is None else v.contiguous() for name, v in inputs.items()}
    args = _RecordsArgs(**{name: _ptr(v) for name, v in keep.items()},
                        **{name: _ptr(v) for name, v in out._asdict().items()}, n=n, d=d, nq=nq, npa=npa)
    _launch(_library().wembed_span_records, args, dtype == torch.float64, device, "span_records")
    span_records.launches += 1
    return out


span_records.launches = 0


# ------------------------------------------------------------------ windows


def _row_search(x_s, t, value, right: bool):
    """Each window's bound in its row, the JAX package's ``bsearch``
    (wembed_tpu/kernels/span_sparse.py:1196): one branchless binary search
    for all (NB, R) values at once, each confined to its row's own sorted
    ranks, for the values x < value (x <= value on the ``right``).  Along a
    row sorted ascending with NaN last both tests are monotone, so this is
    where the test flips, as a rank in the row."""
    n = x_s.shape[0]
    lo = t.row_lo.expand_as(value)
    hi = (t.row_hi + 1).expand_as(value)
    for _ in range(int(t.max_row).bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        x = x_s[torch.clamp_max(mid, n - 1)]
        pred = (x <= value) if right else (x < value)
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo - t.row_lo


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
    start = torch.where(overlap, _row_search(x_s, t, lo, right=False), 0)
    stop = torch.where(overlap, _row_search(x_s, t, hi, right=True), 0)

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
            "row_tiles", "bmax_row", "blk_t", "start_tile", "need", "overflow",
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
        ("src_of_q", t.src_of_q, torch.int32, (nb * _Q,)), ("blk_first", t.blk_first, torch.int64, (nb,)),
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
    overflow = torch.empty((), dtype=torch.int64, device=device)
    inputs = dict(sorted=sorted_xyl, y=y, order1=order1, src_of_q=t.src_of_q, blk_first=t.blk_first,
                  blk_last=t.blk_last, row_lo=t.row_lo, row_hi=t.row_hi, row_tiles=t.row_tiles,
                  bmax_row=t.bmax_row)
    keep = {name: v.contiguous() for name, v in inputs.items()}
    args = _WindowsArgs(**{name: _ptr(v) for name, v in keep.items()}, blk_t=_ptr(blk_t),
                        start_tile=_ptr(start_tile), need=_ptr(need), overflow=_ptr(overflow), n=n, nb=nb, r=rr,
                        max_row=t.max_row)
    _launch(_library().wembed_span_windows, args, dtype == torch.float64, device, "span_windows")
    span_windows.launches += 1
    return start_tile, need, overflow


span_windows.launches = 0


# ------------------------------------------------------------------ library

_CONSTANTS = {
    "wembed_span_build_query_block": _Q,
    "wembed_span_build_tile": _ST,
    "wembed_span_build_max_fast_dim": MAX_FAST_DIM,
    "wembed_span_build_frame_chunk": FRAME_CHUNK,
    "wembed_span_build_vrec_width": VREC_WIDTH,
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
    for name, struct in (("wembed_principal_frame", _FrameArgs), ("wembed_principal_axes", _AxesArgs),
                         ("wembed_span_records", _RecordsArgs), ("wembed_span_windows", _WindowsArgs)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(struct), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load("span_build", _configure)
