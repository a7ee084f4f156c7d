"""The embedding steps and the embedding loop.

Counterpart of ``build_step`` and ``run_embedding`` in
``wembed_tpu/core/step.py`` (reference NewWEmbedEmbedder::calculateStep,
src/embeddingLib/src/embedder/NewWEmbedEmbedder.cpp:14-92):

  force pass -> coincident kicks -> centre -> optimizer ->
  gravity recentring -> mean-squared-displacement convergence metric

The force pass is the fused all-pairs kernel (``fused_step``, the dense
path) or the span path's structures build, sweep kernel and edge pass
(``span_step``).  PyTorch runs eagerly, so the loop is a Python loop.  It
synchronises once per step, to read the convergence metric and the
overflow together, which keeps the stopping iteration exactly the JAX
package's.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import forces
from ..kernels.fused_dense import fused_dense_forces
from ..kernels.span_sparse import SpanIndex, span_fused_forces
from .optim import AdamParams, adam_update, simple_update
from .options import EmbedderOptions, OptimizerType
from .state import DeviceGraph, EmbedState


def _apply_optimizer(opts, old_positions, force, state: EmbedState, t: int):
    """Positions + fresh moment tensors after one optimizer update.

    SIMPLE is the reference's clip-then-cooled-LR optimizer
    (SimpleOptimizer.cpp:17-41, maxDisplacement=1); it keeps the (unused)
    Adam moments untouched."""
    if opts.optimizer_type is OptimizerType.SIMPLE:
        positions = simple_update(
            old_positions, force, t, opts.learning_rate, opts.cooling_factor
        )
        return positions, state.adam_m, state.adam_v
    hp = AdamParams(opts.learning_rate, opts.cooling_factor)
    return adam_update(old_positions, force, state.adam_m, state.adam_v, t, hp)


def _finish_step(
    state: EmbedState, opts: EmbedderOptions, force, zero_count, att_loss, rep_loss,
    rep_count, overflow,
) -> EmbedState:
    """Everything after the force pass: kicks, centre, optimizer, gravity
    and the convergence metric."""
    old_positions = state.positions
    n, d = old_positions.shape
    # coincident-point kicks (NewWEmbedEmbedder.cpp:229-233): one random unit
    # vector per vertex, scaled by its coincident-pair count.  Drawn every
    # step and multiplied by the count, so that no host branch (and no
    # synchronisation) is needed to skip them; a zero count adds exactly 0.
    kicks = forces.random_unit_vectors(state.generator, n, d, old_positions.dtype)
    force = force + kicks * zero_count[:, None].to(old_positions.dtype)

    if opts.centre_scale != 0.0:
        force = force + forces.centre_forces(old_positions, opts)

    t = state.iteration + 1
    positions, m, v = _apply_optimizer(opts, old_positions, force, state, t)
    positions = forces.apply_gravity_centre(positions)
    pos_change = forces.mean_squared_displacement(old_positions, positions)
    return EmbedState(
        positions=positions,
        adam_m=m,
        adam_v=v,
        iteration=t,
        generator=state.generator,
        attract_loss=att_loss,
        repel_loss=rep_loss,
        pos_change=pos_change,
        num_rep_forces=rep_count,
        overflow=overflow,
    )


def fused_step(
    state: EmbedState,
    inv_w: torch.Tensor,
    adj: torch.Tensor,
    dg: DeviceGraph,
    opts: EmbedderOptions,
) -> EmbedState:
    """One iteration of the dense path: the whole force pass in the fused
    kernel (``wembed_tpu/core/step.py:fused_step``)."""
    d = state.positions.shape[1]
    force, zero_count, att_loss, rep_loss, rep_count = fused_dense_forces(
        state.positions,
        inv_w,
        dg.colors,
        adj,
        dim=d,
        L=opts.edge_length,
        att_scale=opts.attraction_scale,
        rep_scale=opts.repulsion_scale,
        additive=opts.additive_weights,
    )
    return _finish_step(
        state, opts, force, zero_count, att_loss, rep_loss, rep_count, state.overflow
    )


def span_step(
    state: EmbedState,
    weights: torch.Tensor,
    inv_w: torch.Tensor,
    dg: DeviceGraph,
    index: SpanIndex,
    blk_t: torch.Tensor,
    opts: EmbedderOptions,
) -> EmbedState:
    """One iteration of the span path (the ``fused_span`` branch of
    ``wembed_tpu/core/step.py:step``): structures, sweep kernel and the
    merged attraction/correction edge pass, with the windows ``blk_t``."""
    force, att_loss, rep_loss, rep_count, overflow, zero_count = span_fused_forces(
        state.positions, inv_w, weights, dg.colors, index, opts, state.generator,
        blk_t=blk_t,
    )
    return _finish_step(
        state, opts, force, zero_count, att_loss, rep_loss, rep_count, overflow
    )


def _progress(state: EmbedState) -> tuple[float, int]:
    """(pos_change, overflow) of the last step, in one synchronisation."""
    both = torch.stack(
        [state.pos_change.to(torch.float64), state.overflow.to(torch.float64)]
    ).tolist()
    return both[0], int(both[1])


def run_embedding(
    step_fn: Callable[[EmbedState], EmbedState],
    state: EmbedState,
    max_iterations: int,
    position_min_change: float,
    stop_on_overflow: bool = False,
) -> EmbedState:
    """calculateEmbedding: step until convergence.

    Continuation condition mirrors !isFinished() (NewWEmbedEmbedder.cpp:94-96,
    ``wembed_tpu/core/step.py:507-512``): iteration < maxIterations AND the
    last step moved vertices by at least positionMinChange on average.  With
    ``stop_on_overflow`` the loop also stops at the first step that
    truncated candidate windows, so that they can grow."""
    pos_change, overflow = _progress(state)
    while (
        state.iteration < max_iterations
        and pos_change >= position_min_change
        and not (stop_on_overflow and overflow != 0)
    ):
        state = step_fn(state)
        pos_change, overflow = _progress(state)
    return state
