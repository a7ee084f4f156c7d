"""Reconstruction quality: precision@degree and mean average precision.

Counterpart of ``wembed_tpu/eval/reconstruction.py``: a vectorized
re-design of the reference's NodeSampler/Reconstruction
(reference: src/evaluationLib/src/metrics/NodeSampler.cpp:5-111,
Reconstruction.cpp:6-30): for each sampled vertex, rank all other vertices
by similarity and measure how early its true neighbors appear.  The
per-node O(n) loop becomes blocked similarity-row computation + argsort.

Tie-breaking matches the reference: (similarity, vertex id) lexicographic
(std::sort over pair<double,int>, NodeSampler.cpp:40).  The numpy loop here
is the host path; ``device.py`` ranks the same rows on a torch device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graphs.csr import CSRGraph
from .spaces import Space


@dataclass
class NodeEntry:
    v: int
    deg: int
    deg_precision: float
    average_precision: float


def sample_node_entries(
    g: CSRGraph,
    space: Space,
    num_node_samples: int,
    rng: np.random.Generator | None = None,
    block: int = 64,
    node_ids: np.ndarray | None = None,
) -> list[NodeEntry]:
    """Precision stats for ``num_node_samples`` random vertices
    (NodeSampler::sampleHistEntries).

    ``node_ids`` pins the sample set explicitly (cross-implementation
    comparisons: feed the ids the reference's NodeSampler drew — its
    Rand::randomPermutation prefix — so MAP deltas measure the embedding,
    not 1000-sample variance)."""
    rng = rng or np.random.default_rng()
    n = g.num_vertices
    if node_ids is not None:
        sampled = np.asarray(node_ids, dtype=np.int64)
        num = sampled.shape[0]
    else:
        num = min(num_node_samples, n)
        sampled = rng.permutation(n)[:num]

    entries: list[NodeEntry] = []
    for start in range(0, num, block):
        ids = sampled[start : start + block]
        sims = space.rows(ids)  # (B, n)
        for row, v in zip(sims, ids):
            v = int(v)
            deg = g.num_neighbors(v)
            nbrs = g.neighbors(v)
            # exclude self by ranking it last (reference skips the v==x pair)
            row = row.copy()
            row[v] = np.inf
            order = np.lexsort((np.arange(n), row))[: n - 1]
            is_nbr = np.zeros(n, dtype=bool)
            is_nbr[nbrs] = True
            hits = is_nbr[order]
            precisions = np.cumsum(hits) / np.arange(1, n)
            deg_precision = float(precisions[deg - 1]) if deg >= 1 else 0.0
            nbr_precisions = precisions[hits]
            avg_precision = float(nbr_precisions.mean()) if nbr_precisions.size else 0.0
            entries.append(NodeEntry(v, deg, deg_precision, avg_precision))
    return entries


def reconstruction_metrics(
    g: CSRGraph,
    space: Space,
    num_node_samples: int = 1000,
    rng: np.random.Generator | None = None,
    method: str = "auto",
    node_ids: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> dict[str, float]:
    """constructDeg (mean precision@degree) and MAP
    (Reconstruction.cpp:6-30).

    ``method``: "device" ranks in torch on ``device`` (eval/device.py,
    O(n) memory per sampled vertex), "host" runs the numpy loop, and "auto"
    prefers the device and falls back to the host for a space with no
    torch rows (a type outside the ten, a subclass included), as the JAX
    package does (``wembed_tpu/eval/reconstruction.py:95-110``): the
    device path has drawn its sample from ``rng`` before it finds that
    out, and the host loop draws from the same ``rng`` after it.  A
    missing CUDA device raises; CPU runs pass ``device="cpu"``."""
    if method not in ("auto", "host", "device"):
        raise ValueError(f"unknown reconstruction method {method!r}")
    if method == "host":
        entries = sample_node_entries(g, space, num_node_samples, rng, node_ids=node_ids)
    else:
        from .device import sample_node_entries_device

        try:
            entries = sample_node_entries_device(
                g, space, num_node_samples, rng, node_ids=node_ids, device=device
            )
        except NotImplementedError:
            if method == "device":
                raise
            entries = sample_node_entries(g, space, num_node_samples, rng, node_ids=node_ids)
    if not entries:
        return {"constructDeg": 0.0, "MAP": 0.0}
    return {
        "constructDeg": float(np.mean([e.deg_precision for e in entries])),
        "MAP": float(np.mean([e.average_precision for e in entries])),
    }
