"""The replicated multi-device backend (``MultiChipEmbedder``), its process
groups (``make_mesh``, ``init_distributed``) and a launcher of ranks for
tests and smoke runs (``run_ranks``).  The vertex-sharded halo backend of
the JAX package (``wembed_tpu/distributed/halo.py``) is not ported yet:
ROADMAP.md, Queue 1, item 16."""

from .launch import run_ranks
from .mesh import Mesh, init_distributed, make_mesh, process_rank
from .step import MultiChipEmbedder

__all__ = [
    "Mesh", "MultiChipEmbedder", "init_distributed", "make_mesh", "process_rank", "run_ranks",
]
