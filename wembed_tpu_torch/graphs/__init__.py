from .csr import CSRGraph, from_edges
from . import algorithms, generators, io

__all__ = ["CSRGraph", "from_edges", "algorithms", "generators", "io"]
