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


# every launch counter: (wrapper, attribute)
_COUNTERS = (
    (fused_dense_forces, "launches"),
    (fused_dense_forces, "launches_general"),
    (_span_sweep.span_sweep, "launches"),
    (_span_sweep.span_sweep, "launches_general"),
)


def counters() -> tuple[int, ...]:
    """Every wrapper's launch counters, in one fixed order: the
    bookkeeping of a captured step (``core/step.py:StepGraph``), whose
    replays launch kernels without calling their wrappers."""
    return tuple(getattr(fn, name) for fn, name in _COUNTERS)


def add_to_counters(counts: tuple[int, ...]) -> None:
    """Add ``counts`` (in the order of ``counters()``) to the counters."""
    for (fn, name), k in zip(_COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + k)


__all__ = ["fused_dense_forces", "fused_dense_forces_reference", "launch_counts"]
