"""Device-resident graph tensors and the embedding state.

Counterpart of ``wembed_tpu/core/state.py`` (the reference's
Graph/VecList/EmbedderParameters object graph, reference:
src/embeddingLib/include/embedder/EmbedderParameters.hpp:12-39,
src/embeddingLib/include/dVec/VecList.hpp:8-91).  The JAX package pads the
edge list to a multiple of 512 so that similar graphs reuse jit compiles;
PyTorch runs eagerly, so the port keeps the edge list unpadded.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graphs.csr import CSRGraph
from .edge_schedule import EdgeSchedules


@dataclass(frozen=True)
class DeviceGraph:
    """Static per-embedder tensors describing the graph, on one device."""

    n: int
    num_edges: int  # undirected edge count (directed count = 2 * num_edges)
    edge_src: torch.Tensor  # (2m,) int64, CSR row of each directed edge
    edge_dst: torch.Tensor  # (2m,) int64, CSR col_idx
    colors: torch.Tensor  # (n,) int32
    row_ptr: torch.Tensor  # (n+1,) int64 CSR offsets
    # (2m,) int64 sorted keys src * n + dst: neighbour membership is one
    # searchsorted (``forces._edge_membership``)
    edge_keys: torch.Tensor
    # the edge pass kernel's schedules of these edges and of their shares
    edge_schedules: EdgeSchedules

    @staticmethod
    def build(g: CSRGraph, device: torch.device) -> "DeviceGraph":
        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        edge_dst = i64(g.col_idx)
        return DeviceGraph(
            n=g.num_vertices,
            num_edges=g.num_edges,
            edge_src=i64(g.edge_src),
            edge_dst=edge_dst,
            colors=torch.as_tensor(g.colors, dtype=torch.int32, device=device),
            row_ptr=i64(g.row_ptr),
            edge_keys=i64(g.edge_keys),
            edge_schedules=EdgeSchedules(g.row_ptr, edge_dst),
        )


@dataclass
class EmbedState:
    """Everything that changes across iterations.

    Fields follow the JAX package's ``EmbedState``.  ``generator`` takes the
    place of the PRNG key, and ``iteration`` is a host int: the host drives
    the loop and needs it every step, so keeping it on the device would
    cost a synchronisation per step.
    """

    positions: torch.Tensor  # (n, d)
    adam_m: torch.Tensor  # (n, d)
    adam_v: torch.Tensor  # (n, d)
    iteration: int  # reference currentIteration / Adam t
    generator: torch.Generator  # coincident-point kicks
    attract_loss: torch.Tensor  # scalar, loss from the most recent step
    repel_loss: torch.Tensor  # scalar
    pos_change: torch.Tensor  # f32 scalar, mean squared displacement last step
    num_rep_forces: torch.Tensor  # int64 scalar, candidate pairs last step
    overflow: torch.Tensor  # int32 scalar; the exact dense path never truncates


def init_state(
    positions: np.ndarray, generator: torch.Generator, dtype: torch.dtype, device
) -> EmbedState:
    positions = torch.as_tensor(np.asarray(positions), dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return EmbedState(
        positions=positions,
        adam_m=torch.zeros_like(positions),
        adam_v=torch.zeros_like(positions),
        iteration=0,
        generator=generator,
        attract_loss=torch.zeros((), **f32),
        repel_loss=torch.zeros((), **f32),
        pos_change=torch.full((), float("inf"), **f32),
        num_rep_forces=torch.zeros((), dtype=torch.int64, device=device),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
    )


def random_positions(n: int, dim: int, rng: np.random.Generator) -> np.ndarray:
    """Uniform init in a cube of side n^(1/dim) (reference
    EmbedderInterface.hpp:70-74)."""
    side = float(n) ** (1.0 / dim)
    return rng.uniform(0.0, side, size=(n, dim))
