"""The torch pieces of a pass over the directed edges: the edges' geometry,
the hinge attraction a directed edge, and the per-vertex segment sum.

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


def edge_attraction(diff, dist2, iw_src, iw_dst, opts, kicks):
    """(force a directed edge (E, d), attraction loss) of edges with
    geometry (``diff``, ``dist2``, ``edge_geometry``) and inverse weights:
    the hinge pull, or the edge's kick where its endpoints coincide."""
    dist = torch.sqrt(dist2)
    ws = iw_src + iw_dst if opts.additive_weights else iw_src * iw_dst
    L = float(opts.edge_length)
    active = dist * ws > L
    coeff = torch.where(active, opts.attraction_scale * ws / torch.clamp_min(dist, 1e-30), 0.0)
    force_e = torch.where((dist2 > 0)[:, None], coeff[:, None] * diff, kicks)
    loss = torch.sum(torch.where(active, dist - L / ws, 0.0))
    return force_e, loss
