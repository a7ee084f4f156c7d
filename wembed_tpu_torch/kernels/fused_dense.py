"""The fused all-pairs force pass: attraction + repulsion in one kernel.

Counterpart of ``wembed_tpu/kernels/fused_dense.py``.  One pass over every
(row, column) pair of the graph computes

  dist2   = sum_k (p_v[k] - p_u[k])^2          (per-dimension differences)
  ws      = invw_v * invw_u  (or their sum, additive weights)
  repel   : non-neighbour, colours differ, dist2 * ws^2 <= L^2  (dead zone,
            reference NewWEmbedEmbedder.cpp:242-247)
  attract : neighbour with dist2 * ws^2 > L^2  (hinge,
            reference NewWEmbedEmbedder.cpp:210-215)
  coeff   = rep_scale*ws/dist [repel, dist > 0] - att_scale*ws/dist [attract]
  force_v = sum_u coeff * (p_v - p_u)

plus both losses, the repulsion-candidate count (numRepForceCalculations,
NewWEmbedEmbedder.cpp:321-332) and per-vertex coincident-pair counts (for
the random kicks, NewWEmbedEmbedder.cpp:197-200,229-233).  The weighted
distance is tested in the TPU kernel's squared form.

The adjacency is one bit a pair (``adjacency_bits``): an (n, ceil(n/32))
int32 array, bit ``c % 32`` of word ``c // 32`` of row ``v`` set where
``(v, c)`` is an edge, 1/8 of a u8 matrix.

``fused_dense_forces`` launches the CUDA kernel ``csrc/fused_dense.cu`` for
CUDA tensors and runs ``fused_dense_forces_reference``, the plain PyTorch
version, for CPU tensors.  Unlike the TPU kernel, neither pads positions
to 128 columns nor rows to a tile multiple, and both visit every column.
On the card, f32 at d <= 8 goes to the fast kernel and f64, or f32 at a
larger d, to the general one (``launches_general`` counts those).  Both
take a row range, ``rows=(r0, r1)``: rows r0 ... r1 - 1 against every
column, one rank's share of the replicated multi-device step.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_REFERENCE_BLOCK = 1024  # rows per block of the plain version
GENERAL_ROWS_PER_BLOCK = 16  # the fewest rows a CTA of the general kernel (csrc kWarps * kGenMinRowsPerWarp)


def adjacency_bits(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """The (n, ceil(n / 32)) int32 bit adjacency of the directed pairs
    (src, dst), on their device: bit ``dst % 32`` of word ``dst // 32`` of
    row ``src``.  Repeated pairs set their bit once."""
    words = -(-n // 32)
    key = torch.unique(src.to(torch.int64) * n + dst.to(torch.int64))
    row, col = key // n, key % n
    bit = torch.bitwise_left_shift(torch.ones_like(col), col % 32)
    acc = torch.zeros(n * words, dtype=torch.int64, device=key.device)
    acc.index_add_(0, row * words + col // 32, bit)  # distinct bits: the sum is the OR
    acc = torch.where(acc >= 2**31, acc - 2**32, acc)  # as two's-complement int32
    return acc.to(torch.int32).view(n, words)


def neighbour_mask(adj: torch.Tensor, rows: slice, n: int) -> torch.Tensor:
    """(rows, n) bool: the bits of ``adj`` (``adjacency_bits``) unpacked
    by shifts."""
    cols = torch.arange(n, device=adj.device)
    words = adj[rows][:, cols // 32]
    return ((words >> (cols % 32).to(torch.int32)) & 1) != 0


def fused_dense_forces_reference(
    pos: torch.Tensor,  # (n, d) f32 or f64
    invw: torch.Tensor,  # (n,)
    colors: torch.Tensor,  # (n,) int32
    adj: torch.Tensor,  # (n, ceil(n / 32)) int32 adjacency bits
    *,
    dim: int,
    L: float,
    att_scale: float,
    rep_scale: float,
    additive: bool,
    rows: tuple[int, int] | None = None,
):
    """Plain PyTorch version of the kernel, in blocks of rows so that the
    (block, n) intermediates stay small.  Same outputs as
    ``fused_dense_forces``; the losses come back in ``pos.dtype``.  Each
    row's force and coincident count do not depend on the other rows, so
    a row range gives those rows of the whole call bit for bit."""
    n = pos.shape[0]
    r0, r1 = _row_range(rows, n)
    dtype, device = pos.dtype, pos.device
    force = torch.empty((r1 - r0, dim), dtype=dtype, device=device)
    zero_count = torch.empty((r1 - r0,), dtype=torch.int32, device=device)
    att_loss = torch.zeros((), dtype=dtype, device=device)
    rep_loss = torch.zeros((), dtype=dtype, device=device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    L2 = float(L) * float(L)
    for s in range(r0, r1, _REFERENCE_BLOCK):
        e = min(s + _REFERENCE_BLOCK, r1)
        diffs = [pos[s:e, k, None] - pos[None, :, k] for k in range(dim)]
        dist2 = torch.zeros((e - s, n), dtype=dtype, device=device)
        for diff in diffs:
            dist2 = dist2 + diff * diff
        iw_r, iw_c = invw[s:e, None], invw[None, :]
        ws = iw_r + iw_c if additive else iw_r * iw_c
        nbr = neighbour_mask(adj, slice(s, e), n)
        differ = colors[s:e, None] != colors[None, :]
        wdist2 = dist2 * (ws * ws)
        rep = ~nbr & differ & (wdist2 <= L2)
        att = nbr & (wdist2 > L2)
        posd = dist2 > 0
        rep_act = rep & posd
        dist = torch.sqrt(dist2)
        inv = 1.0 / torch.clamp_min(dist, 1e-30)
        coeff = torch.where(rep_act, rep_scale * ws * inv, 0.0) - torch.where(
            att, att_scale * ws * inv, 0.0
        )
        for k, diff in enumerate(diffs):
            force[s - r0 : e - r0, k] = torch.sum(coeff * diff, dim=1)
        linvws = L / ws
        att_loss += torch.sum(torch.where(att, dist - linvws, 0.0))
        rep_loss += torch.sum(torch.where(rep_act, linvws - dist, 0.0))
        count += torch.sum(rep)
        zero_count[s - r0 : e - r0] = torch.sum(~posd & (nbr | rep), dim=1)
    return force, zero_count, att_loss, rep_loss, count


def _row_range(rows: tuple[int, int] | None, n: int) -> tuple[int, int]:
    if rows is None:
        return 0, n
    r0, r1 = int(rows[0]), int(rows[1])
    if not 0 <= r0 <= r1 <= n:
        raise ValueError(f"row range {rows} outside [0, {n}]")
    return r0, r1


def _configure(lib: ctypes.CDLL) -> None:
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in (
        "wembed_fused_dense_rows_per_block", "wembed_fused_dense_general_rows_per_block",
        "wembed_fused_dense_max_dim",
    ):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.wembed_cuda_error_string.argtypes = [i]
    lib.wembed_cuda_error_string.restype = ctypes.c_char_p
    lib.wembed_fused_dense_splits.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.wembed_fused_dense_splits.restype = i
    lib.wembed_fused_dense_forces.argtypes = [
        p, p, p, p, i, i, i, i, i, d, d, d, i, p, p, p, p, p, p, p, p, i, p,
    ]
    lib.wembed_fused_dense_forces.restype = i
    lib.wembed_fused_dense_general.argtypes = [
        p, p, p, p, i, i, i, i, i, d, d, d, i, p, p, p, p, p, p, i, p,
    ]
    lib.wembed_fused_dense_general.restype = i


def _check(pos, invw, colors, adj, dim):
    n = pos.shape[0]
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernels take pos as float32 or float64, got {pos.dtype}")
    expected = [
        ("pos", pos, pos.dtype, (n, dim)),
        ("invw", invw, pos.dtype, (n,)),
        ("colors", colors, torch.int32, (n,)),
        ("adj", adj, torch.int32, (n, -(-n // 32))),
    ]
    for name, t, dtype, shape in expected:
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
        if t.dtype != dtype:
            raise TypeError(f"the CUDA kernels take {name} as {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n < 1:
        raise ValueError("the CUDA kernel needs at least one vertex")


def fused_dense_forces(
    pos: torch.Tensor,
    invw: torch.Tensor,
    colors: torch.Tensor,
    adj: torch.Tensor,
    *,
    dim: int,
    L: float,
    att_scale: float,
    rep_scale: float,
    additive: bool,
    rows: tuple[int, int] | None = None,
):
    """The whole force pass of one embedding step, or of rows ``rows =
    (r0, r1)`` of it against every column.

    Returns (force (r1 - r0, d), zero_count (r1 - r0,) int32, att_loss,
    rep_loss, rep_count int64), the scalars as 0-d tensors on
    ``pos.device``; by default the rows are all n.  CPU tensors go through
    the plain version; CUDA tensors (f32 or f64, any d) through a kernel,
    on the current stream, without synchronising: the fast kernel for f32
    at d <= 8, the general kernel otherwise.  An empty range launches
    nothing.
    """
    kwargs = dict(dim=dim, L=L, att_scale=att_scale, rep_scale=rep_scale, additive=additive)
    if pos.device.type == "cpu":
        return fused_dense_forces_reference(pos, invw, colors, adj, rows=rows, **kwargs)
    if pos.device.type != "cuda":
        raise ValueError(f"no fused_dense kernel for device {pos.device}")
    _check(pos, invw, colors, adj, dim)
    n, dtype, device = pos.shape[0], pos.dtype, pos.device
    r0, r1 = _row_range(rows, n)
    force = torch.empty((r1 - r0, dim), dtype=dtype, device=device)
    zero_count = torch.empty((r1 - r0,), dtype=torch.int32, device=device)
    if r1 == r0:
        nothing = torch.zeros((), dtype=dtype, device=device)
        return force, zero_count, nothing, nothing, torch.zeros((), dtype=torch.int64, device=device)
    losses = torch.empty((2,), dtype=dtype, device=device)
    count = torch.empty((), dtype=torch.int64, device=device)
    lib = _build.load("fused_dense", _configure)
    stream = torch.cuda.current_stream(device).cuda_stream
    common = (pos.data_ptr(), invw.data_ptr(), colors.data_ptr(), adj.data_ptr(), n, dim, r0, r1 - r0)
    scalars = (float(L), float(att_scale), float(rep_scale), int(bool(additive)))
    if dtype == torch.float32 and dim <= lib.wembed_fused_dense_max_dim():
        splits = _splits(lib, n, dim, device.index)
        parts = -(-(r1 - r0) // lib.wembed_fused_dense_rows_per_block()) * splits
        part_force = torch.empty((splits, r1 - r0, dim), dtype=dtype, device=device)
        part_zero = torch.empty((splits, r1 - r0), dtype=torch.int32, device=device)
        part_loss = torch.empty((parts, 2), dtype=torch.float64, device=device)
        part_count = torch.empty((parts,), dtype=torch.int64, device=device)
        rc = lib.wembed_fused_dense_forces(
            *common, splits, *scalars, part_force.data_ptr(), part_zero.data_ptr(),
            part_loss.data_ptr(), part_count.data_ptr(), force.data_ptr(), zero_count.data_ptr(),
            losses.data_ptr(), count.data_ptr(), device.index, stream,
        )
        _raise_on(lib, rc, "fused_dense kernel launch")
    else:
        if lib.wembed_fused_dense_general_rows_per_block() != GENERAL_ROWS_PER_BLOCK:
            raise RuntimeError("csrc/fused_dense.cu and kernels/fused_dense.py disagree on the general kernel's rows")
        parts = -(-(r1 - r0) // GENERAL_ROWS_PER_BLOCK)  # its CTAs at the fewest rows a CTA
        part_loss = torch.empty((parts, 2), dtype=torch.float64, device=device)
        part_count = torch.empty((parts,), dtype=torch.int64, device=device)
        rc = lib.wembed_fused_dense_general(
            *common, int(dtype == torch.float64), *scalars, force.data_ptr(),
            zero_count.data_ptr(), part_loss.data_ptr(), part_count.data_ptr(),
            losses.data_ptr(), count.data_ptr(), device.index, stream,
        )
        _raise_on(lib, rc, "fused_dense general kernel launch")
        fused_dense_forces.launches_general += 1
    fused_dense_forces.launches += 1
    return force, zero_count, losses[0], losses[1], count


_split_cache: dict[tuple[int, int, int], int] = {}


def _splits(lib, n: int, dim: int, device_index: int) -> int:
    """The fast kernel's column splits for (n, dim) on the device, for the
    whole pass and for any row range of it: chosen once from its SM count
    and occupancy (``csrc/fused_dense.cu``)."""
    key = (n, dim, device_index)
    if key not in _split_cache:
        out = ctypes.c_int(0)
        rc = lib.wembed_fused_dense_splits(n, dim, device_index, ctypes.byref(out))
        _raise_on(lib, rc, "fused_dense split choice")
        _split_cache[key] = out.value
    return _split_cache[key]


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.wembed_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: {msg} (cudaError {rc})")


fused_dense_forces.launches = 0  # kernel launches, both kernels; the plain version is not counted
fused_dense_forces.launches_general = 0  # of which the general kernel's
