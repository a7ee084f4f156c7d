from .csr import CSRGraph, from_edges
from . import io

__all__ = ["CSRGraph", "from_edges", "io"]
