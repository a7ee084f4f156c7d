"""The plain tensor passes of the step around the force kernels.

Counterpart of ``wembed_tpu/core/forces.py`` (reference
src/embeddingLib/src/embedder/NewWEmbedEmbedder.cpp:188-363):
coincident-point kick directions (the vertex kicks' unit rows, the edge
kicks' raw draw and its normalisation), the attraction pass over the edges, the
negative-sampling repulsion, the centre force, gravity recentring, the
convergence metric, and the bit adjacency that the dense force kernel
reads (built on the device, in place of the u8 matrix of
``wembed_tpu/core/step.py:287-291``).

The normal dense step does attraction and repulsion in one kernel
(``kernels/fused_dense.py``), the span step in the sweep kernel and one
edge pass (``kernels/span_sparse.py``).  ``attraction_forces``, the edge
pass's attraction mode (``kernels/edge_pass.py``), serves the profiled
step and the sampled one.  The JAX package's unfused
``dense_repulsion_forces`` has no counterpart: the profiled dense step
runs the fused kernel with the attraction scale at 0 (``core/step.py``).
"""

from __future__ import annotations

import torch

from ..kernels import edge_pass as edges
from ..kernels.fused_dense import adjacency_bits
from .edge_geometry import edge_geometry, segment_sum, unit_rows
from .options import EmbedderOptions
from .state import DeviceGraph


def normal_rows(generator: torch.Generator, n: int, dim: int, dtype: torch.dtype) -> torch.Tensor:
    """(n, dim) standard normal draws from ``generator``, on its device: the
    edge kicks, which the edge pass normalises (``unit_rows``) at the
    coincident edges it kicks, and the draw behind ``random_unit_vectors``."""
    return torch.randn((n, dim), generator=generator, dtype=dtype, device=generator.device)


def random_unit_vectors(
    generator: torch.Generator, n: int, dim: int, dtype: torch.dtype
) -> torch.Tensor:
    """(n, dim) Gaussian directions normalized to unit length (reference
    DVec.hpp:408-427 setToRandomUnitVector), on the generator's device: the
    vertex kicks.  (The edge kicks take ``unit_rows`` of ``normal_rows``,
    operation by operation what the edge pass kernel computes.)"""
    g = normal_rows(generator, n, dim, dtype)
    norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return g / torch.where(norm > 0, norm, torch.ones_like(norm))


def _weight_scaling(inv_w_a, inv_w_b, additive: bool):
    return inv_w_a + inv_w_b if additive else inv_w_a * inv_w_b


def edge_share(row_ptr: torch.Tensor, num_edges: int, share):
    """(lo, hi, row_ptr) of the src-sorted directed edges: all of them, or
    the share's contiguous range with the segment offsets clipped to it, so
    that every vertex gets its partial (zero outside the range)."""
    if share is None:
        return 0, num_edges, row_ptr
    lo, hi = share.cut(num_edges)
    return lo, hi, torch.clamp(row_ptr, lo, hi) - lo


def attraction_forces(
    positions: torch.Tensor,
    inv_w: torch.Tensor,
    dg: DeviceGraph,
    opts: EmbedderOptions,
    generator: torch.Generator,
    share=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge SDDMM and per-vertex segment sum (``wembed_tpu/core/forces.py:
    attraction_forces``): each directed edge (src, dst) pulls src toward dst
    past the hinge, dist * ws > L (NewWEmbedEmbedder.cpp:188-219), into its
    source row only.  Coincident endpoints get a random unit kick instead
    (NewWEmbedEmbedder.cpp:197-200): one raw (E, d) normal draw from
    ``generator`` every step (``normal_rows``), a row normalised
    (``unit_rows``) where its edge's endpoints coincide, so that no host
    branch (and no synchronisation) decides whether any edge needs one.
    The kernel walks the edges by the schedule held beside them
    (``dg.edge_schedules``, ``core/edge_schedule.py``).  ``share``
    (``core/step.py:Share``) takes its range of the edges, with the kicks
    drawn whole and sliced, as the JAX package's sharded pass draws them
    (``wembed_tpu/core/forces.py:139-152``).

    Returns (force (n, d), attraction loss)."""
    n, d = positions.shape
    dtype = positions.dtype
    e = dg.edge_src.shape[0]
    if e == 0:
        return torch.zeros_like(positions), torch.zeros((), dtype=dtype, device=positions.device)
    lo, hi, row_ptr = edge_share(dg.row_ptr, e, share)
    kicks = normal_rows(generator, e, d, dtype)[lo:hi]
    out = edges.edge_pass(
        "attraction", positions, inv_w, dg.edge_src[lo:hi], dg.edge_dst[lo:hi], row_ptr, opts,
        kicks=kicks, schedule=dg.edge_schedules.get(lo, hi),
    )
    return out.force, out.att_loss


def coincident_edge_counts(positions: torch.Tensor, dg: DeviceGraph) -> torch.Tensor:
    """(n,) int32: each vertex's directed edges whose endpoints coincide,
    the pairs that ``attraction_forces`` kicks."""
    if dg.edge_src.shape[0] == 0:
        return torch.zeros((dg.n,), dtype=torch.int32, device=positions.device)
    _, dist2 = edge_geometry(positions, dg.edge_src, dg.edge_dst)
    # counts summed as floats (segment_reduce takes no integers): exact below 2^24
    return segment_sum((dist2 <= 0).to(dist2.dtype), dg.row_ptr).to(torch.int32)


def _edge_membership(dg: DeviceGraph, src_ids: torch.Tensor, dst_ids: torch.Tensor) -> torch.Tensor:
    """Vectorised areNeighbors (reference Graph.cpp:67-83): one
    ``torch.searchsorted`` of the keys src * n + dst in the graph's sorted
    edge keys, in place of the JAX package's fixed-depth binary search
    within each CSR row (``wembed_tpu/core/forces.py:_edge_membership``)."""
    keys = src_ids.to(torch.int64) * dg.n + dst_ids.to(torch.int64)
    e = dg.edge_keys.shape[0]
    if e == 0:
        return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    at = torch.searchsorted(dg.edge_keys, keys.reshape(-1)).reshape(keys.shape)
    return (at < e) & (dg.edge_keys[torch.clamp_max(at, e - 1)] == keys)


def sampled_repulsion_forces(
    positions: torch.Tensor,
    inv_w: torch.Tensor,
    dg: DeviceGraph,
    opts: EmbedderOptions,
    generator: torch.Generator,
    share=None,
):
    """Negative-sampling repulsion (numNegativeSamples > 0, reference
    NewWEmbedEmbedder.cpp:250-252,292-295): every vertex repels
    k = min(num_negative_samples, n) uniformly drawn vertices, the forces
    scaled by n/k.  DOCUMENTED DEVIATION, as in the JAX package: the draw is
    with replacement (the reference's Floyd sampling is without);
    indistinguishable for k << n, and the scaled force stays an unbiased
    estimate of the exact all-pairs repulsion.  The draw is one (n, k)
    ``torch.randint`` from ``generator``.  ``share`` (``core/step.py:
    Share``) takes its range of the rows; the draw stays whole on every
    rank and is sliced.  DOCUMENTED DEVIATION: the JAX package's sharded
    pass folds the device index into the key (``wembed_tpu/core/forces.py:
    294``); drawing whole keeps a replicated run on the single-device
    trajectory.

    Returns (force (n, d), loss, count, zero_count (n,) int32); the caller
    applies the kicks."""
    n = positions.shape[0]
    k = min(int(opts.num_negative_samples), n)
    cand = torch.randint(0, n, (n, k), generator=generator, device=generator.device)
    rows = None if share is None else share.cut(n)
    return _sampled_from_candidates(positions, inv_w, dg, opts, cand, rows)


def _sampled_from_candidates(
    positions: torch.Tensor,
    inv_w: torch.Tensor,
    dg: DeviceGraph,
    opts: EmbedderOptions,
    cand: torch.Tensor,
    rows: tuple[int, int] | None = None,
):
    """The sampled pass for given (n, k) candidates: each (v, cand[v, j])
    with different colours and not an edge counts; those inside the dead
    zone (dist * ws <= L, dist > 0) repel with force scale * ws / dist
    along pos_v - pos_u, scale = n / k.  The loss and the count are not
    rescaled (``wembed_tpu/core/forces.py:sampled_repulsion_forces``).
    ``rows = (r0, r1)`` takes those rows only; the force and the zero
    counts stay (n, ...), zero on the other rows."""
    n, d = positions.shape
    k = cand.shape[1]
    dtype = positions.dtype
    L = float(opts.edge_length)
    r0, r1 = (0, n) if rows is None else rows
    cand = cand[r0:r1]
    rid = torch.arange(r0, r1, device=positions.device)[:, None]
    diff = positions[r0:r1, None, :] - positions[cand]  # (rows, k, d)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    iw = inv_w.to(dtype)
    ws = _weight_scaling(iw[r0:r1, None], iw[cand], opts.additive_weights)
    valid = (dg.colors[r0:r1, None] != dg.colors[cand]) & ~_edge_membership(dg, rid, cand)
    in_range = (dist * ws <= L) & valid
    active = in_range & (dist > 0)
    scale = float(n) / float(k)
    coeff = torch.where(
        active, opts.repulsion_scale * ws * scale / torch.clamp_min(dist, 1e-30), 0.0
    )
    force = torch.sum(coeff[..., None] * diff, dim=1)
    loss = torch.sum(torch.where(active, L / ws - dist, 0.0))
    count = torch.sum(valid, dtype=torch.int64)
    zero_count = torch.sum((dist <= 0) & valid, dim=1, dtype=torch.int32)
    if rows is not None:
        force, zero_count = widen_rows(force, n, r0), widen_rows(zero_count, n, r0)
    return force, loss, count, zero_count


def widen_rows(part: torch.Tensor, n: int, r0: int) -> torch.Tensor:
    """A share's rows r0 ... r0 + len(part) - 1 as an n-row tensor, zero
    on the other rows."""
    full = torch.zeros((n, *part.shape[1:]), dtype=part.dtype, device=part.device)
    full[r0 : r0 + part.shape[0]] = part
    return full


def build_dense_adjacency(dg: DeviceGraph) -> torch.Tensor:
    """(n, ceil(n / 32)) int32 bit adjacency (``kernels/fused_dense.py:
    adjacency_bits``) of the graph's directed edges, on its device."""
    return adjacency_bits(dg.edge_src, dg.edge_dst, dg.n)


def centre_forces(positions: torch.Tensor, opts: EmbedderOptions) -> torch.Tensor:
    """force += -centreScale * pos (reference NewWEmbedEmbedder.cpp:338-343)."""
    return -opts.centre_scale * positions


def apply_gravity_centre(positions: torch.Tensor) -> torch.Tensor:
    """Subtract the centroid (reference NewWEmbedEmbedder.cpp:345-363)."""
    return positions - positions.mean(dim=0, keepdim=True)


def mean_squared_displacement(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Convergence metric: mean over vertices of squared displacement norm
    (reference NewWEmbedEmbedder.cpp:69-89), reduced in f32 as the JAX
    package reduces it."""
    delta = (old - new).to(torch.float32)
    return torch.sum(delta * delta) / old.shape[0]
