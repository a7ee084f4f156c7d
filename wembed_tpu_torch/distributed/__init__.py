"""The multi-device backends, one process a rank: the replicated one
(``MultiChipEmbedder``) and the vertex-sharded halo one (``HaloEmbedder``,
``HaloPlan``), their process groups (``make_mesh``, ``init_distributed``)
and a launcher of ranks for tests and smoke runs (``run_ranks``)."""

from .halo import HaloEmbedder, HaloPlan
from .launch import run_ranks
from .mesh import Mesh, init_distributed, make_mesh, process_rank
from .step import MultiChipEmbedder

__all__ = [
    "HaloEmbedder", "HaloPlan", "Mesh", "MultiChipEmbedder", "init_distributed", "make_mesh",
    "process_rank", "run_ranks",
]
