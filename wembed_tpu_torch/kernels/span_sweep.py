"""The span sweep: repulsion candidates of every query block in one pass.

Counterpart of the TPU kernel of ``wembed_tpu/kernels/span_sparse.py``
(``sweep_work_tiles`` and ``_span_tile_body``).  Query block ``i`` (256
sorted query slots) is swept against the member tiles of its windows: for
each row ``g`` with ``blk_t[i, g] > 0``, the tiles ``start_tile[i, g] ...
start_tile[i, g] + blk_t[i, g] - 1`` of row ``g``'s padded member range.
For every (slot, member) pair:

  dist2  = sum_k (q[k] - s[k])^2             (per-dimension differences)
  valid  = dist2 <= lw_q^2 * bm2_s  and  col_q != col_s
  ws     = invw_q * invw_s  (or the sum, additive weights)
  active = valid and dist2 * ws^2 <= L^2 and dist2 > 0
  coeff  = rep_scale * ws / dist

and per slot it returns force = sum coeff * (q - s), the loss
sum (L/ws - dist) over active pairs, the candidate count (valid pairs) and
the coincident count (valid pairs at dist2 == 0).  The TPU kernel returns
q * rowsum - coeff @ S instead of the force; the direct sum does not cancel.

Record layout (row-major, ``d + 3`` channels): queries
``[pos(d), invw, lw^2, 1/invw]``, members ``[pos(d), invw, bm2, 1/invw]``,
with int32 colours beside them; padding slots carry far sentinel positions
and never pass the radius test.

Work items: ``work_items`` cuts every block's tiles, in block-major order,
into items of at most ``WORK_ITEM_TILES`` tiles, ``(block, first row g,
tiles to skip in row g's window, tiles)``.  The table depends only on
``blk_t``, so it is built on the host once per window change.  The kernel
runs one CTA an item and adds each block's items in item order.

``span_sweep`` launches ``csrc/span_sweep.cu`` for CUDA tensors, the fast
kernel for f32 at d <= 8 and the general one for f64 or a larger d
(``launches_general`` counts those), and runs ``span_sweep_reference``,
the plain PyTorch version, for CPU tensors (f32 or f64).  A contiguous
slice of the work items sweeps exactly those items' tiles: blocks without
an item in the slice get zeros.  That slice is one rank's share of the
replicated multi-device step.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

Q = 256  # query slots per block
ST = 256  # members per tile
WORK_ITEM_TILES = 4  # K: tiles of the longest work item (chosen on an H100, PERF.md)
_REFERENCE_PAIRS = 1 << 22  # (tile, slot, member) elements per chunk of the plain version


def _work_tiles(blk_t: torch.Tensor, start_tile: torch.Tensor, tile_off: torch.Tensor):
    """The block-major work list of the windows: (query block, global member
    tile) of every tile."""
    nb, rr = blk_t.shape
    counts = blk_t.reshape(-1).to(torch.int64)
    pair = torch.repeat_interleave(torch.arange(nb * rr, device=blk_t.device), counts)
    first = torch.cumsum(counts, 0) - counts
    within = torch.arange(pair.shape[0], device=blk_t.device) - first[pair]
    qblk = pair // rr
    stile = tile_off.to(torch.int64)[pair % rr] + start_tile.reshape(-1).to(torch.int64)[pair] + within
    return qblk, stile


def work_items(blk_t: np.ndarray, k: int = WORK_ITEM_TILES) -> np.ndarray:
    """The (items, 4) int32 work-item table of the windows ``blk_t`` (NB, R):
    each block's tiles in block-major order (rows ascending, tiles within a
    window ascending) cut into runs of at most ``k`` tiles, each run as
    (block, first row g, tiles to skip in row g's window, tiles).  Items of
    one block are consecutive; a block without tiles has none."""
    if k < 1:
        raise ValueError(f"work items need k >= 1, got {k}")
    blk_t = np.asarray(blk_t, np.int64)
    nb, rr = blk_t.shape
    flat = blk_t.reshape(-1)
    pair = np.repeat(np.arange(nb * rr), flat)  # (block, row) of every tile
    within = np.arange(pair.shape[0]) - (np.cumsum(flat) - flat)[pair]
    block = pair // rr
    per_block = blk_t.sum(axis=1)
    in_block = np.arange(pair.shape[0]) - (np.cumsum(per_block) - per_block)[block]
    first = np.flatnonzero(in_block % k == 0)
    b = block[first]
    return np.stack(
        [b, pair[first] % rr, within[first], np.minimum(k, per_block[b] - in_block[first])],
        axis=1,
    ).astype(np.int32)


def _item_tiles(items, blk_t, start_tile, tile_off):
    """(query block, global member tile, item) of every tile of the work
    items, in item order, found from each item's (row, skip) fields."""
    qblk, stile = _work_tiles(blk_t, start_tile, tile_off)
    items = items.to(torch.int64)
    flat = blk_t.reshape(-1).to(torch.int64)
    first = torch.cumsum(flat, 0) - flat  # work-list position of each window's first tile
    pos = first[items[:, 0] * blk_t.shape[1] + items[:, 1]] + items[:, 2]
    item = torch.repeat_interleave(torch.arange(items.shape[0], device=items.device), items[:, 3])
    offset = torch.cumsum(items[:, 3], 0) - items[:, 3]
    tile = pos[item] + torch.arange(item.shape[0], device=items.device) - offset[item]
    return qblk[tile], stile[tile], item


def span_sweep_reference(
    qrec: torch.Tensor,  # (nb * Q, d + 3)
    qcol: torch.Tensor,  # (nb * Q,) int32
    srec: torch.Tensor,  # (tiles * ST, d + 3)
    scol: torch.Tensor,  # (tiles * ST,) int32
    blk_t: torch.Tensor,  # (nb, R) int32
    start_tile: torch.Tensor,  # (nb, R) int32
    tile_off: torch.Tensor,  # (R,) int32
    *,
    dim: int,
    L: float,
    rep_scale: float,
    additive: bool,
    items: torch.Tensor | None = None,  # (items, 4) int32 work items of blk_t
):
    """Plain PyTorch version of the kernel, vectorised over chunks of work
    tiles.  Same outputs as ``span_sweep``: (force (nb*Q, d), loss (nb*Q,),
    count (nb*Q,) int32, zero (nb*Q,) int32).  With ``items`` it runs the
    kernel's split: each item's tiles summed on their own, then each
    block's items added in item order; without, each block's tiles at
    once."""
    d = dim
    nq, c = qrec.shape
    nb = nq // Q
    dtype, device = qrec.dtype, qrec.device
    if items is None:
        qblk, stile = _work_tiles(blk_t, start_tile, tile_off)
        dest, n_dest = qblk, nb
    else:
        qblk, stile, dest = _item_tiles(items, blk_t, start_tile, tile_off)
        n_dest = items.shape[0]
    q3, qc3 = qrec.view(nb, Q, c), qcol.view(nb, Q)
    s3, sc3 = srec.view(-1, ST, c), scol.view(-1, ST)
    force = torch.zeros((n_dest, Q, d), dtype=dtype, device=device)
    loss = torch.zeros((n_dest, Q), dtype=dtype, device=device)
    count = torch.zeros((n_dest, Q), dtype=torch.int64, device=device)
    zero = torch.zeros((n_dest, Q), dtype=torch.int64, device=device)
    L2 = float(L) * float(L)
    chunk = max(1, _REFERENCE_PAIRS // (Q * ST))
    for lo in range(0, qblk.shape[0], chunk):
        qb, st, to = qblk[lo : lo + chunk], stile[lo : lo + chunk], dest[lo : lo + chunk]
        q, s = q3[qb], s3[st]  # (k, Q, c), (k, ST, c)
        diffs = [q[:, :, k, None] - s[:, None, :, k] for k in range(d)]
        dist2 = torch.zeros_like(diffs[0])
        for diff in diffs:
            dist2 = dist2 + diff * diff
        valid = (dist2 <= q[:, :, d + 1, None] * s[:, None, :, d + 1]) & (
            qc3[qb][:, :, None] != sc3[st][:, None, :]
        )
        iw_q, iw_s = q[:, :, d, None], s[:, None, :, d]
        ws = iw_q + iw_s if additive else iw_q * iw_s
        posd = dist2 > 0
        active = valid & (dist2 * (ws * ws) <= L2) & posd
        dist = torch.sqrt(dist2)
        coeff = torch.where(active, rep_scale * ws * (1.0 / dist), 0.0)
        l_over_ws = L / ws if additive else (L * q[:, :, d + 2, None]) * s[:, None, :, d + 2]
        force.index_add_(0, to, torch.stack([torch.sum(coeff * diff, dim=2) for diff in diffs], dim=2))
        loss.index_add_(0, to, torch.sum(torch.where(active, l_over_ws - dist, 0.0), dim=2))
        count.index_add_(0, to, torch.sum(valid, dim=2))
        zero.index_add_(0, to, torch.sum(valid & ~posd, dim=2))
    if items is not None:  # each block's items, in item order
        block = items[:, 0].to(torch.int64)
        sums = (force, loss, count, zero)
        force, loss, count, zero = (
            torch.zeros((nb, *t.shape[1:]), dtype=t.dtype, device=device).index_add_(0, block, t)
            for t in sums
        )
    return (
        force.reshape(nq, d),
        loss.reshape(nq),
        count.reshape(nq).to(torch.int32),
        zero.reshape(nq).to(torch.int32),
    )


def sweep_outputs(nq: int, dim: int, dtype: torch.dtype, device) -> tuple[torch.Tensor, ...]:
    """Empty outputs of a sweep of ``nq`` query slots: (force (nq, dim),
    loss (nq,), count (nq,) int32, zero (nq,) int32)."""
    return (
        torch.empty((nq, dim), dtype=dtype, device=device),
        torch.empty((nq,), dtype=dtype, device=device),
        torch.empty((nq,), dtype=torch.int32, device=device),
        torch.empty((nq,), dtype=torch.int32, device=device),
    )


def _configure(lib: ctypes.CDLL) -> None:
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("wembed_span_sweep_block", "wembed_span_sweep_tile", "wembed_span_sweep_max_dim"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.wembed_span_sweep_error_string.argtypes = [i]
    lib.wembed_span_sweep_error_string.restype = ctypes.c_char_p
    lib.wembed_span_sweep.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, d, d, i, p, p, p, p, p, i, p]
    lib.wembed_span_sweep.restype = i
    lib.wembed_span_sweep_general.argtypes = [
        p, p, p, p, p, p, p, p, i, i, i, i, i, d, d, i, p, p, p, p, p, i, p,
    ]
    lib.wembed_span_sweep_general.restype = i


def _check(qrec, qcol, srec, scol, blk_t, start_tile, tile_off, items, dim):
    nq, npa = qrec.shape[0], srec.shape[0]
    nb, rr = blk_t.shape
    if items is None:
        raise ValueError("the CUDA kernel needs the work-item table (items=)")
    if qrec.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernels take records as float32 or float64, got {qrec.dtype}")
    expected = [
        ("qrec", qrec, qrec.dtype, (nq, dim + 3)),
        ("qcol", qcol, torch.int32, (nq,)),
        ("srec", srec, qrec.dtype, (npa, dim + 3)),
        ("scol", scol, torch.int32, (npa,)),
        ("blk_t", blk_t, torch.int32, (nb, rr)),
        ("start_tile", start_tile, torch.int32, (nb, rr)),
        ("tile_off", tile_off, torch.int32, (rr,)),
        ("items", items, torch.int32, (items.shape[0], 4)),
    ]
    for name, t, dtype, shape in expected:
        if t.device != qrec.device:
            raise ValueError(f"{name} is on {t.device}, qrec on {qrec.device}")
        if t.dtype != dtype:
            raise TypeError(f"the CUDA kernels take {name} as {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nb < 1 or rr < 1 or nq != nb * Q or npa % ST != 0:
        raise ValueError(
            f"the CUDA kernel takes nb * {Q} query slots and whole {ST}-member tiles, "
            f"got {nq} slots for {nb} blocks and {npa} members"
        )
    if items.data_ptr() % 16 != 0:
        raise ValueError("the CUDA kernel reads items as int4: its data must be 16-byte aligned")


def span_sweep(
    qrec: torch.Tensor,
    qcol: torch.Tensor,
    srec: torch.Tensor,
    scol: torch.Tensor,
    blk_t: torch.Tensor,
    start_tile: torch.Tensor,
    tile_off: torch.Tensor,
    *,
    dim: int,
    L: float,
    rep_scale: float,
    additive: bool,
    items: torch.Tensor | None = None,
):
    """The sweep of one step.  Returns (force (nb*Q, d), loss (nb*Q,), count
    (nb*Q,) int32, zero (nb*Q,) int32) per query slot.  CPU tensors go
    through the plain version; CUDA tensors (f32 or f64, any d) through a
    kernel, on the current stream, without synchronising, which needs
    ``items``, the ``work_items`` table of these ``blk_t`` on the device,
    or a contiguous slice of it.  The caller keeps the windows inside each
    row (start_tile + blk_t <= the row's tiles)."""
    kwargs = dict(dim=dim, L=L, rep_scale=rep_scale, additive=additive, items=items)
    args = (qrec, qcol, srec, scol, blk_t, start_tile, tile_off)
    if qrec.device.type == "cpu":
        return span_sweep_reference(*args, **kwargs)
    if qrec.device.type != "cuda":
        raise ValueError(f"no span_sweep kernel for device {qrec.device}")
    _check(*args, items, dim)
    lib = _build.load("span_sweep", _configure)
    if (lib.wembed_span_sweep_block(), lib.wembed_span_sweep_tile()) != (Q, ST):
        raise RuntimeError("csrc/span_sweep.cu and kernels/span_sweep.py disagree on Q or ST")
    nq, dtype, device = qrec.shape[0], qrec.dtype, qrec.device
    nb, rr = blk_t.shape
    n_items = items.shape[0]
    scratch = torch.empty((n_items, dim + 3, Q), dtype=dtype, device=device)
    force, loss, count, zero = sweep_outputs(nq, dim, dtype, device)
    inputs = (*(t.data_ptr() for t in args), items.data_ptr(), n_items, nb, rr, dim)
    outputs = (scratch.data_ptr(), force.data_ptr(), loss.data_ptr(), count.data_ptr(),
               zero.data_ptr(), device.index, torch.cuda.current_stream(device).cuda_stream)
    scalars = (float(L), float(rep_scale), int(bool(additive)))
    general = dtype == torch.float64 or dim > lib.wembed_span_sweep_max_dim()
    if general:
        rc = lib.wembed_span_sweep_general(
            *inputs, int(dtype == torch.float64), *scalars, *outputs
        )
    else:
        rc = lib.wembed_span_sweep(*inputs, *scalars, *outputs)
    if rc != 0:
        msg = lib.wembed_span_sweep_error_string(rc).decode()
        raise RuntimeError(f"span_sweep kernel launch failed: {msg} (cudaError {rc})")
    span_sweep.launches += 1
    span_sweep.launches_general += int(general)
    return force, loss, count, zero


span_sweep.launches = 0  # kernel launches, both kernels; the plain version is not counted
span_sweep.launches_general = 0  # of which the general kernel's
