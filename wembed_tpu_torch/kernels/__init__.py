"""Hand-written CUDA kernels for the per-iteration hot ops, each with a
plain PyTorch version beside it.  Sources live in ``csrc/`` and build at
first use (``_build.py``).  The span sweep lives in ``span_sweep`` and
the span path around it in ``span_sparse`` (the windowed layout) and
``span_compact`` (the cell layout)."""

from .fused_dense import fused_dense_forces, fused_dense_forces_reference
from . import span_sweep as _span_sweep


def launch_counts() -> dict[str, int]:
    """Each CUDA kernel's launches so far in this process (the plain
    versions are not counted)."""
    return {"fused_dense": fused_dense_forces.launches, "span_sweep": _span_sweep.span_sweep.launches}


__all__ = ["fused_dense_forces", "fused_dense_forces_reference", "launch_counts"]
