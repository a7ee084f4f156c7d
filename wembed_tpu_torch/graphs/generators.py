"""Random graph generators, numpy only: 2-D geometric graphs and
geometric inhomogeneous random graphs (GIRGs).

Counterpart of ``wembed_tpu/graphs/generators.py`` (the reference's
disc-intersection sampler, src/graphLib/src/graph/GeometricGraphSampler.cpp:
10-101, and its CLI's external ``girgs`` sampler,
src/cli_generator/GirgGenerator.cpp:10-70).  The arithmetic and the order
of draws from the host generator are the JAX package's, so one seed gives
the same graph, byte for byte once written.

The model: vertex weights ~ power law with exponent ``ple``; positions
uniform on a d-dimensional torus; edge probability
``min(1, (w_u * w_v / (n * dist^d))^alpha)`` (alpha = 1/temperature,
infinity = threshold model).  Weights are scaled to hit a target average
degree, as girgs::scaleWeights does.
"""

from __future__ import annotations

import numpy as np

from . import algorithms
from .csr import CSRGraph, from_edges


def geometric_graph(
    n: int,
    grid_size: float | None = None,
    radius: float | None = None,
    rng: np.random.Generator | None = None,
) -> tuple[CSRGraph, np.ndarray]:
    """Random 2-D disc-intersection graph, largest component only.

    Defaults give average degree ~= 20: points uniform in a sqrt(n) square,
    connect within radius sqrt(20/pi)
    (GeometricGraphSampler.cpp:10-17).  Returns (graph, coords (k, 2)).
    Vectorized with a cell grid instead of the reference's O(n^2) loop.
    """
    rng = rng or np.random.default_rng()
    grid_size = float(grid_size if grid_size is not None else np.sqrt(n))
    radius = float(radius if radius is not None else np.sqrt(20.0 / np.pi))
    coords = rng.uniform(0.0, grid_size, size=(n, 2))

    # bucket points into radius-sized cells; only 3x3 neighborhoods can touch
    ncells = max(1, int(np.floor(grid_size / radius)))
    cell_xy = np.minimum((coords / radius).astype(np.int64), ncells - 1)
    cell = cell_xy[:, 0] * ncells + cell_xy[:, 1]
    order = np.argsort(cell, kind="stable")
    sorted_cell = cell[order]
    # cell start offsets
    starts = np.searchsorted(sorted_cell, np.arange(ncells * ncells))
    ends = np.searchsorted(sorted_cell, np.arange(ncells * ncells) + 1)

    pairs = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            ncell_xy = cell_xy + np.asarray([dx, dy])
            valid = ((ncell_xy >= 0) & (ncell_xy < ncells)).all(axis=1)
            ncell = ncell_xy[:, 0] * ncells + ncell_xy[:, 1]
            ncell = np.where(valid, ncell, 0)
            s, e = starts[ncell], ends[ncell]
            s, e = np.where(valid, s, 0), np.where(valid, e, 0)
            counts = e - s
            total = int(counts.sum())
            if total == 0:
                continue
            # flat gather of all candidate neighbors per point
            src = np.repeat(np.arange(n), counts)
            offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
            dst = order[np.repeat(s, counts) + offs]
            m = src < dst
            src, dst = src[m], dst[m]
            d2 = ((coords[src] - coords[dst]) ** 2).sum(axis=1)
            m = d2 < radius * radius
            if m.any():
                pairs.append(np.stack([src[m], dst[m]], axis=1))

    edges = np.concatenate(pairs, axis=0) if pairs else np.empty((0, 2), dtype=np.int64)
    g = from_edges(edges, num_vertices=n)
    sub, mapping = algorithms.largest_component_with_mapping(g)
    return sub, coords[mapping]


# --------------------------------------------------------------------- GIRG


def _girg_weights(n: int, ple: float, rng: np.random.Generator) -> np.ndarray:
    """Power-law weights with exponent ``ple``: inverse-CDF sampling of
    P(W > w) ~ w^{1-ple}, w >= 1."""
    u = rng.uniform(size=n)
    return (1.0 - u) ** (1.0 / (1.0 - ple))


def _torus_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """L-infinity torus distance between position rows (girgs convention)."""
    diff = np.abs(a - b)
    diff = np.minimum(diff, 1.0 - diff)
    return diff.max(axis=-1)


def girg(
    n: int,
    ple: float = 2.5,
    avg_degree: float = 10.0,
    dim: int = 2,
    temperature: float = 0.0,
    torus: bool = True,
    connected: bool = True,
    rng: np.random.Generator | None = None,
) -> tuple[CSRGraph, np.ndarray, np.ndarray]:
    """Sample a geometric inhomogeneous random graph.

    Returns (graph, positions (k, dim), weights (k,)).  Mirrors
    GirgGenerator::generateRandomGraph (GirgGenerator.cpp:10-70): with
    ``torus=False`` positions are scaled by 0.5 and weights by 0.5^dim to
    avoid wrap-around; with ``connected=True`` only the largest component is
    returned, with positions/weights mapped through.
    """
    rng = rng or np.random.default_rng()
    alpha = np.inf if temperature <= 0 else 1.0 / temperature
    weights = _girg_weights(n, ple, rng)
    positions = rng.uniform(size=(n, dim))
    weights = _scale_girg_weights(weights, avg_degree, dim, alpha, rng)
    edges = _girg_edges(weights, positions, dim, alpha, rng)
    if not torus:
        positions = positions * 0.5
        weights = weights * 0.5**dim
    g = from_edges(edges, num_vertices=n)
    if connected:
        sub, mapping = algorithms.largest_component_with_mapping(g)
        return sub, positions[mapping], weights[mapping]
    return g, positions, weights


def _scale_girg_weights(
    weights: np.ndarray, avg_degree: float, dim: int, alpha: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Scale weights so the sampled graph's expected average degree ~=
    target: a Monte-Carlo estimate of E[deg] as a function of the weight
    scale c (weights enter the connection probability as c^2 * w_u * w_v),
    then a binary search, as girgs::scaleWeights does."""
    n = weights.shape[0]
    nsamples = min(200_000, 20 * n)
    u = rng.integers(0, n, size=nsamples)
    v = rng.integers(0, n, size=nsamples)
    keep = u != v
    u, v = u[keep], v[keep]
    dist = _torus_distance(
        rng.uniform(size=(u.shape[0], dim)), rng.uniform(size=(u.shape[0], dim))
    )
    base = weights[u] * weights[v] / (n * np.maximum(dist, 1e-12) ** dim)

    def mean_prob(c2: float) -> float:
        x = c2 * base
        if np.isinf(alpha):
            p = (x >= 1.0).astype(np.float64)
        else:
            p = np.minimum(1.0, x**alpha)
        return float(p.mean())

    target = avg_degree / (n - 1)
    lo, hi = 1e-12, 1e12
    for _ in range(100):
        mid = np.sqrt(lo * hi)
        if mean_prob(mid) < target:
            lo = mid
        else:
            hi = mid
    c2 = np.sqrt(lo * hi)  # multiplier on w_u * w_v
    return weights * np.sqrt(c2)


def _girg_edges(
    weights: np.ndarray, positions: np.ndarray, dim: int, alpha: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """GIRG edges in near-linear expected time via doubling weight buckets.

    Each bucket PAIR (i, j) gets its own grid with cell size
    r_ij = min(0.5, (wmax_i * wmax_j / n)^(1/dim)), the largest distance at
    which any (i, j) pair connects in the threshold model.  Near pairs get
    their exact connection probability; for alpha < inf the long-range
    tail beyond r_ij is rejection-sampled per bucket pair with the
    upper-bound probability at distance r_ij."""
    n = weights.shape[0]
    logw = np.floor(np.log2(np.maximum(weights, 1e-300))).astype(np.int64)
    logw -= logw.min()
    nb = int(logw.max()) + 1
    members = [np.flatnonzero(logw == k) for k in range(nb)]
    wmax_b = [float(weights[m].max()) if m.size else 0.0 for m in members]

    edges = []
    for i in range(nb):
        mi = members[i]
        if mi.size == 0:
            continue
        for j in range(i, nb):
            mj = members[j]
            if mj.size == 0:
                continue
            r_ij = min(0.5, (wmax_b[i] * wmax_b[j] / n) ** (1.0 / dim))
            pairs = _cross_pairs_within_radius(positions, mi, mj, r_ij)
            if pairs.shape[0]:
                u, v = pairs[:, 0], pairs[:, 1]
                d = _torus_distance(positions[u], positions[v])
                if np.isinf(alpha):
                    thresh = (weights[u] * weights[v] / n) ** (1.0 / dim)
                    m = d <= thresh
                else:
                    p = np.minimum(
                        1.0,
                        (weights[u] * weights[v] / (n * np.maximum(d, 1e-12) ** dim))
                        ** alpha,
                    )
                    m = rng.uniform(size=p.shape[0]) < p
                if m.any():
                    edges.append(pairs[m])

            if np.isinf(alpha) or r_ij >= 0.5:
                continue  # no pair beyond r_ij can connect / none exists
            # long-range tail: p <= (wmax_i wmax_j / (n r_ij^dim))^alpha for
            # dist > r_ij; rejection-sample over the (i, j) pair universe
            p_far_max = min(1.0, (wmax_b[i] * wmax_b[j] / (n * r_ij**dim)) ** alpha)
            universe = (
                mi.size * (mi.size - 1) / 2 if i == j else mi.size * mj.size
            )
            expected = p_far_max * universe
            num_cand = int(min(expected * 3 + 64, 2e7))
            if num_cand <= 0 or p_far_max <= 0:
                continue
            cu = mi[rng.integers(0, mi.size, size=num_cand)]
            cv = mj[rng.integers(0, mj.size, size=num_cand)]
            keep = cu < cv if i == j else cu != cv
            cu, cv = cu[keep], cv[keep]
            d = _torus_distance(positions[cu], positions[cv])
            far = d > r_ij
            cu, cv, d = cu[far], cv[far], d[far]
            p = np.minimum(1.0, (weights[cu] * weights[cv] / (n * d**dim)) ** alpha)
            # candidates were drawn uniformly from the pair universe;
            # correct the acceptance so each far pair is included w.p. p
            accept_scale = universe / max(1, num_cand)
            m = rng.uniform(size=p.shape[0]) < np.minimum(1.0, p * accept_scale)
            if m.any():
                fu, fv = np.minimum(cu[m], cv[m]), np.maximum(cu[m], cv[m])
                edges.append(np.stack([fu, fv], axis=1))

    if not edges:
        return np.empty((0, 2), dtype=np.int64)
    all_edges = np.concatenate(edges, axis=0)
    keys = np.unique(all_edges[:, 0] * n + all_edges[:, 1])
    return np.stack([keys // n, keys % n], axis=1)


def _cross_pairs_within_radius(
    positions: np.ndarray, idx_a: np.ndarray, idx_b: np.ndarray, radius: float
) -> np.ndarray:
    """(k, 2) global-id pairs (u < v, u != v) with one endpoint in ``idx_a``,
    the other in ``idx_b`` and Linf torus distance <= radius, via a cell grid
    over the b-side with wrap-around neighborhoods.  ``idx_a is idx_b``
    handles the self case."""
    n_all, dim = positions.shape
    same = idx_a is idx_b
    ncells = max(1, int(np.floor(1.0 / max(radius, 1e-9))))
    if ncells <= 3:
        # grid too coarse to prune (radius ~ torus size): brute-force the
        # cross product in blocks; only heavy (hence tiny) buckets land here
        out = []
        block = max(1, int(4e7) // max(1, idx_b.size))
        for s in range(0, idx_a.size, block):
            a_blk = idx_a[s : s + block]
            d = _torus_distance(
                positions[a_blk][:, None, :], positions[idx_b][None, :, :]
            )
            ai, bi = np.nonzero(d <= radius)
            u, v = a_blk[ai], idx_b[bi]
            m = u < v if same else u != v
            if m.any():
                uu, vv = u[m], v[m]
                out.append(np.stack([np.minimum(uu, vv), np.maximum(uu, vv)], axis=1))
        if not out:
            return np.empty((0, 2), dtype=np.int64)
        pairs = np.concatenate(out, axis=0)
        keys = np.unique(pairs[:, 0] * n_all + pairs[:, 1])
        return np.stack([keys // n_all, keys % n_all], axis=1)

    multipliers = ncells ** np.arange(dim)[::-1]
    b_cell_coord = np.minimum((positions[idx_b] * ncells).astype(np.int64), ncells - 1)
    b_cell = b_cell_coord @ multipliers
    order = np.argsort(b_cell, kind="stable")
    sorted_cell = b_cell[order]
    total_cells = ncells**dim
    starts = np.searchsorted(sorted_cell, np.arange(total_cells))
    ends = np.searchsorted(sorted_cell, np.arange(total_cells) + 1)
    b_sorted_ids = idx_b[order]

    a_cell_coord = np.minimum((positions[idx_a] * ncells).astype(np.int64), ncells - 1)
    offsets = np.stack(
        np.meshgrid(*([np.asarray([-1, 0, 1])] * dim), indexing="ij"), axis=-1
    ).reshape(-1, dim)

    out = []
    for off in offsets:
        ncell = ((a_cell_coord + off) % ncells) @ multipliers
        s, e = starts[ncell], ends[ncell]
        counts = e - s
        total = int(counts.sum())
        if total == 0:
            continue
        src = np.repeat(idx_a, counts)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        dst = b_sorted_ids[np.repeat(s, counts) + offs]
        m = src < dst if same else src != dst
        src, dst = src[m], dst[m]
        d = _torus_distance(positions[src], positions[dst])
        m = d <= radius
        if m.any():
            u, v = src[m], dst[m]
            out.append(np.stack([np.minimum(u, v), np.maximum(u, v)], axis=1))
    if not out:
        return np.empty((0, 2), dtype=np.int64)
    pairs = np.concatenate(out, axis=0)
    keys = np.unique(pairs[:, 0] * n_all + pairs[:, 1])
    return np.stack([keys // n_all, keys % n_all], axis=1)
