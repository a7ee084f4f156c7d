"""Hand-written CUDA kernels for the per-iteration hot ops, each with a
plain PyTorch version beside it.  Sources live in ``csrc/`` and build at
first use (``_build.py``).  The span sweep lives in ``span_sweep``, the
span path around it in ``span_sparse`` (the windowed layout) and
``span_compact`` (the cell layout), and its edge pass in ``edge_pass``."""

from .fused_dense import fused_dense_forces, fused_dense_forces_reference
from . import edge_pass as _edge_pass
from . import span_sweep as _span_sweep


def launch_counts() -> dict[str, int]:
    """The dense kernel's and the span sweep's launches so far in this
    process (the plain versions are not counted): one of them a step of
    each path, which ``bench_torch.py`` checks key for key."""
    return {"fused_dense": fused_dense_forces.launches, "span_sweep": _span_sweep.span_sweep.launches}


def edge_pass_launches() -> int:
    """The span edge pass kernel's launches so far in this process, kept
    out of ``launch_counts()`` for that check."""
    return _edge_pass.edge_pass.launches


# every launch counter: (wrapper, attribute)
_COUNTERS = (
    (fused_dense_forces, "launches"),
    (fused_dense_forces, "launches_general"),
    (_span_sweep.span_sweep, "launches"),
    (_span_sweep.span_sweep, "launches_general"),
    (_edge_pass.edge_pass, "launches"),
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


__all__ = ["edge_pass_launches", "fused_dense_forces", "fused_dense_forces_reference", "launch_counts"]
