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

``span_sweep`` launches ``csrc/span_sweep.cu`` for CUDA tensors (f32 only)
and runs ``span_sweep_reference``, the plain PyTorch version, for CPU
tensors (f32 or f64).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

Q = 256  # query slots per block
ST = 256  # members per tile
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
):
    """Plain PyTorch version of the kernel, vectorised over chunks of work
    tiles.  Same outputs as ``span_sweep``: (force (nb*Q, d), loss (nb*Q,),
    count (nb*Q,) int32, zero (nb*Q,) int32)."""
    d = dim
    nq, c = qrec.shape
    nb = nq // Q
    dtype, device = qrec.dtype, qrec.device
    qblk, stile = _work_tiles(blk_t, start_tile, tile_off)
    q3, qc3 = qrec.view(nb, Q, c), qcol.view(nb, Q)
    s3, sc3 = srec.view(-1, ST, c), scol.view(-1, ST)
    force = torch.zeros((nb, Q, d), dtype=dtype, device=device)
    loss = torch.zeros((nb, Q), dtype=dtype, device=device)
    count = torch.zeros((nb, Q), dtype=torch.int64, device=device)
    zero = torch.zeros((nb, Q), dtype=torch.int64, device=device)
    L2 = float(L) * float(L)
    chunk = max(1, _REFERENCE_PAIRS // (Q * ST))
    for lo in range(0, qblk.shape[0], chunk):
        qb, st = qblk[lo : lo + chunk], stile[lo : lo + chunk]
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
        force.index_add_(0, qb, torch.stack([torch.sum(coeff * diff, dim=2) for diff in diffs], dim=2))
        loss.index_add_(0, qb, torch.sum(torch.where(active, l_over_ws - dist, 0.0), dim=2))
        count.index_add_(0, qb, torch.sum(valid, dim=2))
        zero.index_add_(0, qb, torch.sum(valid & ~posd, dim=2))
    return (
        force.reshape(nq, d),
        loss.reshape(nq),
        count.reshape(nq).to(torch.int32),
        zero.reshape(nq).to(torch.int32),
    )


def _configure(lib: ctypes.CDLL) -> None:
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("wembed_span_sweep_block", "wembed_span_sweep_tile", "wembed_span_sweep_max_dim"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.wembed_span_sweep_error_string.argtypes = [i]
    lib.wembed_span_sweep_error_string.restype = ctypes.c_char_p
    lib.wembed_span_sweep.argtypes = [p, p, p, p, p, p, p, i, i, i, d, d, i, p, p, p, p, i, p]
    lib.wembed_span_sweep.restype = i


def _check(qrec, qcol, srec, scol, blk_t, start_tile, tile_off, dim):
    nq, npa = qrec.shape[0], srec.shape[0]
    nb, rr = blk_t.shape
    expected = [
        ("qrec", qrec, torch.float32, (nq, dim + 3)),
        ("qcol", qcol, torch.int32, (nq,)),
        ("srec", srec, torch.float32, (npa, dim + 3)),
        ("scol", scol, torch.int32, (npa,)),
        ("blk_t", blk_t, torch.int32, (nb, rr)),
        ("start_tile", start_tile, torch.int32, (nb, rr)),
        ("tile_off", tile_off, torch.int32, (rr,)),
    ]
    for name, t, dtype, shape in expected:
        if t.device != qrec.device:
            raise ValueError(f"{name} is on {t.device}, qrec on {qrec.device}")
        if t.dtype != dtype:
            raise TypeError(f"the CUDA kernel takes {name} as {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nb < 1 or rr < 1 or nq != nb * Q or npa % ST != 0:
        raise ValueError(
            f"the CUDA kernel takes nb * {Q} query slots and whole {ST}-member tiles, "
            f"got {nq} slots for {nb} blocks and {npa} members"
        )


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
):
    """The sweep of one step.  Returns (force (nb*Q, d), loss (nb*Q,), count
    (nb*Q,) int32, zero (nb*Q,) int32) per query slot.  CPU tensors go
    through the plain version; CUDA tensors (f32 only, d <= 8) through the
    kernel, on the current stream, without synchronising.  The caller keeps
    the windows inside each row (start_tile + blk_t <= the row's tiles)."""
    kwargs = dict(dim=dim, L=L, rep_scale=rep_scale, additive=additive)
    args = (qrec, qcol, srec, scol, blk_t, start_tile, tile_off)
    if qrec.device.type == "cpu":
        return span_sweep_reference(*args, **kwargs)
    if qrec.device.type != "cuda":
        raise ValueError(f"no span_sweep kernel for device {qrec.device}")
    _check(*args, dim)
    lib = _build.load("span_sweep", _configure)
    if (lib.wembed_span_sweep_block(), lib.wembed_span_sweep_tile()) != (Q, ST):
        raise RuntimeError("csrc/span_sweep.cu and kernels/span_sweep.py disagree on Q or ST")
    if dim > lib.wembed_span_sweep_max_dim():
        raise ValueError(f"the CUDA kernel takes d <= {lib.wembed_span_sweep_max_dim()}, got {dim}")
    nq, device = qrec.shape[0], qrec.device
    nb, rr = blk_t.shape
    force = torch.empty((nq, dim), dtype=torch.float32, device=device)
    loss = torch.empty((nq,), dtype=torch.float32, device=device)
    count = torch.empty((nq,), dtype=torch.int32, device=device)
    zero = torch.empty((nq,), dtype=torch.int32, device=device)
    rc = lib.wembed_span_sweep(
        *(t.data_ptr() for t in args), nb, rr, dim, float(L), float(rep_scale),
        int(bool(additive)), force.data_ptr(), loss.data_ptr(), count.data_ptr(),
        zero.data_ptr(), device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        msg = lib.wembed_span_sweep_error_string(rc).decode()
        raise RuntimeError(f"span_sweep kernel launch failed: {msg} (cudaError {rc})")
    span_sweep.launches += 1
    return force, loss, count, zero


span_sweep.launches = 0  # kernel launches; the plain version is not counted
