"""The torch pieces of a pass over the directed edges: the edges' geometry,
the hinge attraction a directed edge, the edge kicks' normalisation and
the per-vertex segment sum.

The edge pass's plain version (``kernels/edge_pass.py:
edge_pass_reference``), the coincident-edge counts (``core/forces.py``)
and the halo backend's two-table attraction (``distributed/halo.py``) are
built from these, so the three agree operation for operation.
"""

from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Per-vertex sums of src-sorted directed-edge rows, one segment per
    CSR row: deterministic run to run (no atomics).  The JAX package's
    cumsum difference (``csr_segment_sum``) works around a serialising TPU
    scatter and is not ported."""
    return torch.segment_reduce(values, "sum", offsets=row_ptr, axis=0)


def edge_geometry(positions: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """(pos[dst] - pos[src], dist2) of the directed edges (src, dst), dist2
    summed over dimensions in ascending order as the force kernels sum it,
    so that ``dist2 > 0`` is their own coincidence test."""
    return edge_geometry_between(positions, positions, src, dst)


def edge_geometry_between(src_rows: torch.Tensor, dst_rows: torch.Tensor, src, dst):
    """``edge_geometry`` with the sources and destinations read from two
    tables (a halo rank's own rows and its ext table)."""
    diff = dst_rows[dst] - src_rows[src]
    dist2 = torch.zeros_like(diff[:, 0])
    for k in range(diff.shape[1]):
        dist2 = dist2 + diff[:, k] * diff[:, k]
    return diff, dist2


def unit_rows(g: torch.Tensor) -> torch.Tensor:
    """The rows of ``g`` (E, d) over their norms, each operation rounded
    alone as the edge pass kernel (``csrc/edge_pass.cu``) repeats it:
    norm2 = 0 + g_0^2 + g_1^2 + ... in ascending k, norm = sqrt(norm2),
    g / (norm > 0 ? norm : 1).  The edge kicks are a raw normal draw that
    a pass normalises with this where it uses a row.  A row whose squares
    underflow stays as it is (its norm is 0); one whose squares overflow
    becomes zeros (g / inf)."""
    norm2 = torch.zeros_like(g[:, 0])
    for k in range(g.shape[1]):
        norm2 = norm2 + g[:, k] * g[:, k]
    norm = torch.sqrt(norm2)
    return g / torch.where(norm > 0, norm, 1.0)[:, None]


def edge_attraction(diff, dist2, iw_src, iw_dst, opts, kicks):
    """(force a directed edge (E, d), attraction loss) of edges with
    geometry (``diff``, ``dist2``, ``edge_geometry``) and inverse weights:
    the hinge pull, or where its endpoints coincide the edge's kick, its
    row of the raw normal draw ``kicks`` (E, d) normalised (``unit_rows``)."""
    dist = torch.sqrt(dist2)
    ws = iw_src + iw_dst if opts.additive_weights else iw_src * iw_dst
    L = float(opts.edge_length)
    active = dist * ws > L
    coeff = torch.where(active, opts.attraction_scale * ws / torch.clamp_min(dist, 1e-30), 0.0)
    force_e = torch.where((dist2 > 0)[:, None], coeff[:, None] * diff, unit_rows(kicks))
    loss = torch.sum(torch.where(active, dist - L / ws, 0.0))
    return force_e, loss
