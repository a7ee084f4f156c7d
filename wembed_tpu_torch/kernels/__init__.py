"""Hand-written CUDA kernels for the per-iteration hot ops, each with a
plain PyTorch version beside it.  Sources live in ``csrc/`` and build at
first use (``_build.py``)."""

from .fused_dense import fused_dense_forces, fused_dense_forces_reference

__all__ = ["fused_dense_forces", "fused_dense_forces_reference"]
