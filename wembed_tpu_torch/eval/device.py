"""Batched similarity rows and ranking on a torch device.

Counterpart of ``wembed_tpu/eval/device.py``, the batched re-design of the
reference's NodeSampler (reference:
src/evaluationLib/src/metrics/NodeSampler.cpp:5-111, OMP-parallel per-node
O(n) similarity scans + std::sort): a block of sampled vertices gets its
similarity rows computed on the device, ranked with one batched stable
sort, and scored with cumulative-sum precision curves — no per-node host
work.  Tie-breaking matches the reference's (similarity, id) lexicographic
order (NodeSampler.cpp:40): a stable argsort over the similarity row IS
that order.

Everything is f64, so that the rows, hence the ranks and their ties, are
the host path's (``reconstruction.sample_node_entries``).  Distances are
summed over the dimensions in ascending order, as numpy sums a short last
axis.  Every space of ``spaces.py`` has a torch row here, with the same
formula (see spaces.py for the reference file:line of each).

A sampled row's neighbours are found by a (B, n) mask scattered from its
CSR range and gathered in rank order, in place of the JAX package's binary
search over the CSR row (``wembed_tpu/core/forces.py:_edge_membership``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.embedder import resolve_device
from ..graphs.csr import CSRGraph
from . import spaces as spaces_mod
from .reconstruction import NodeEntry

_F64 = torch.float64


def _sq_dist_rows(pos: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, n) squared L2 distances of the rows ``ids`` to every vertex,
    summed one dimension at a time in ascending order."""
    out = None
    for k in range(pos.shape[1]):
        diff = pos[ids, k, None] - pos[None, :, k]
        out = diff * diff if out is None else out + diff * diff
    return out


def _dist_rows(pos: torch.Tensor, ids: torch.Tensor, inf: bool = False) -> torch.Tensor:
    """(B, n) L2 (or L-inf) distances of the rows ``ids`` to every vertex."""
    if not inf:
        return torch.sqrt(_sq_dist_rows(pos, ids))
    out = None
    for k in range(pos.shape[1]):
        term = torch.abs(pos[ids, k, None] - pos[None, :, k])
        out = term if out is None else torch.maximum(out, term)
    return out


def _rows_builder(space: spaces_mod.Space, device: torch.device):
    """(device tensors, row_fn) where row_fn(tensors, ids) -> (B, n) f64
    similarities — a torch mirror of ``space.rows``."""
    t = type(space)

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=_F64, device=device)

    if t is spaces_mod.Euclidean:
        return (dev(space.positions),), lambda a, ids: _dist_rows(a[0], ids)
    if t is spaces_mod.InfNorm:
        return (dev(space.positions),), lambda a, ids: _dist_rows(a[0], ids, inf=True)
    if t is spaces_mod.DotProduct:
        return (dev(space.positions),), lambda a, ids: -(a[0][ids] @ a[0].T)
    if t is spaces_mod.Cosine:
        return (dev(space._unit),), lambda a, ids: -(a[0][ids] @ a[0].T)
    if t is spaces_mod.WeightedGeometric:
        w = space.weights ** (1.0 / space.dimension)
        return (dev(space.positions), dev(w)), lambda a, ids: _dist_rows(a[0], ids) / (
            a[1][ids][:, None] * a[1][None, :]
        )
    if t is spaces_mod.WeightedGeometricInf:
        w = space.weights ** (1.0 / space.dimension)
        return (dev(space.positions), dev(w)), lambda a, ids: _dist_rows(
            a[0], ids, inf=True
        ) / (a[1][ids][:, None] * a[1][None, :])
    if t is spaces_mod.WeightedNoDim:
        return (dev(space.positions), dev(space.weights)), lambda a, ids: _dist_rows(
            a[0], ids
        ) / (a[1][ids][:, None] * a[1][None, :])
    if t is spaces_mod.Additive:
        w = space.weights ** (1.0 / space.dimension)
        return (dev(space.positions), dev(w)), lambda a, ids: _dist_rows(a[0], ids) / (
            a[1][ids][:, None] + a[1][None, :]
        )
    if t is spaces_mod.Poincare:

        def poincare_rows(a, ids):
            pos, sq = a
            sqdist = _sq_dist_rows(pos, ids)
            x = sqdist / ((1.0 - sq[ids][:, None]) * (1.0 - sq[None, :])) * 2.0 + 1.0
            z = torch.sqrt(torch.clamp_min(x * x - 1.0, 0.0))
            return torch.log(x + z)

        return (dev(space.positions), dev(space._sqnorm)), poincare_rows
    if t is spaces_mod.Mercator:
        s1 = space.angular.ndim == 1

        def mercator_rows(a, ids):
            radii, angular = a
            if s1:
                dtheta = math.pi - torch.abs(
                    math.pi - torch.abs(angular[ids][:, None] - angular[None, :])
                )
            else:
                norms = torch.linalg.norm(angular, dim=-1)
                cosang = (angular[ids] @ angular.T) / (norms[ids][:, None] * norms[None, :])
                dtheta = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
                dtheta = torch.where(torch.abs(cosang - 1.0) < 1e-15, 0.0, dtheta)
            r1 = radii[ids][:, None]
            r2 = radii[None, :]
            x = 0.5 * (
                (1 - torch.cos(dtheta)) * torch.cosh(r1 + r2)
                + (1 + torch.cos(dtheta)) * torch.cosh(r1 - r2)
            )
            hyper = torch.arccosh(torch.clamp_min(x, 1.0))
            out = torch.where(dtheta == 0, torch.abs(r1 - r2), hyper)
            return torch.where((r1 == r2) & (dtheta == 0), 0.0, out)

        return (dev(space.radii), dev(space.angular)), mercator_rows
    raise NotImplementedError(f"no device rows for {t.__name__}")


def _neighbour_mask(row_ptr: torch.Tensor, col: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) bool: row b marks the CSR neighbours of ``ids[b]``."""
    starts, deg = row_ptr[ids], row_ptr[ids + 1] - row_ptr[ids]
    rows = torch.repeat_interleave(torch.arange(ids.shape[0], device=ids.device), deg)
    first = torch.cumsum(deg, 0) - deg  # each row's first slot in the flat list
    slot = torch.arange(rows.shape[0], device=ids.device) - first[rows]
    mask = torch.zeros((ids.shape[0], n), dtype=torch.bool, device=ids.device)
    mask[rows, col[starts[rows] + slot]] = True
    return mask


def _score_block(arrays, row_fn, row_ptr, col, n: int, ids: torch.Tensor):
    """(deg_precision (B,), average_precision (B,), deg (B,)) for one block
    of sampled vertices: similarity rows, stable rank, precision curves."""
    sims = row_fn(arrays, ids)  # (B, n)
    b = ids.shape[0]
    # exclude self by ranking it last (the reference skips the v == x pair)
    sims[torch.arange(b, device=ids.device), ids] = math.inf
    order = torch.argsort(sims, dim=1, stable=True)  # (sim, id) lex order
    del sims
    hits = torch.gather(_neighbour_mask(row_ptr, col, ids, n), 1, order)
    del order
    cums = torch.cumsum(hits.to(_F64), dim=1)
    ranks = torch.arange(1, n + 1, dtype=_F64, device=ids.device)
    precisions = cums / ranks
    deg = row_ptr[ids + 1] - row_ptr[ids]
    at_deg = torch.gather(precisions, 1, torch.clamp_min(deg - 1, 0)[:, None])[:, 0]
    deg_precision = torch.where(deg >= 1, at_deg, 0.0)
    nbr_prec_sum = torch.sum(torch.where(hits, precisions, 0.0), dim=1)
    avg_precision = torch.where(deg >= 1, nbr_prec_sum / torch.clamp_min(deg, 1), 0.0)
    return deg_precision, avg_precision, deg


def sample_node_entries_device(
    g: CSRGraph,
    space: spaces_mod.Space,
    num_node_samples: int,
    rng: np.random.Generator | None = None,
    block: int = 128,
    node_ids: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> list[NodeEntry]:
    """Device-side NodeSampler::sampleHistEntries — the same ``NodeEntry``
    list as the host version (same sampling, same tie-breaking), computed
    in blocks of ``block`` vertices on ``device``.  ``node_ids`` pins the
    sample set (see reconstruction.py)."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng()
    n = g.num_vertices
    if node_ids is not None:
        sampled = np.asarray(node_ids, dtype=np.int64)
        num = sampled.shape[0]
    else:
        num = min(num_node_samples, n)
        sampled = rng.permutation(n)[:num]
    arrays, row_fn = _rows_builder(space, dev)
    row_ptr = torch.as_tensor(g.row_ptr, dtype=torch.int64, device=dev)
    col = torch.as_tensor(g.col_idx, dtype=torch.int64, device=dev)

    entries: list[NodeEntry] = []
    for start in range(0, num, block):
        ids = sampled[start : start + block]
        dp, ap, deg = _score_block(
            arrays, row_fn, row_ptr, col, n, torch.as_tensor(ids, dtype=torch.int64, device=dev)
        )
        dp, ap, deg = dp.cpu().numpy(), ap.cpu().numpy(), deg.cpu().numpy()
        for i, v in enumerate(ids):
            entries.append(NodeEntry(int(v), int(deg[i]), float(dp[i]), float(ap[i])))
    return entries
