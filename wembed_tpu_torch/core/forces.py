"""The plain tensor passes of the step around the force kernel.

Counterpart of the parts of ``wembed_tpu/core/forces.py`` that the dense
path runs (reference src/embeddingLib/src/embedder/NewWEmbedEmbedder.cpp):
coincident-point kick directions, the centre force, gravity recentring,
the convergence metric, and the bit adjacency that the force kernel reads
(built on the device, in place of the u8 matrix of
``wembed_tpu/core/step.py:287-291``).
Attraction and repulsion themselves are one kernel,
``kernels/fused_dense.py``.
"""

from __future__ import annotations

import torch

from ..kernels.fused_dense import adjacency_bits
from .options import EmbedderOptions
from .state import DeviceGraph


def random_unit_vectors(
    generator: torch.Generator, n: int, dim: int, dtype: torch.dtype
) -> torch.Tensor:
    """(n, dim) Gaussian directions normalized to unit length (reference
    DVec.hpp:408-427 setToRandomUnitVector), on the generator's device."""
    g = torch.randn(
        (n, dim), generator=generator, dtype=dtype, device=generator.device
    )
    norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return g / torch.where(norm > 0, norm, torch.ones_like(norm))


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
