"""The embedding step and the embedding loop.

Counterpart of ``fused_step`` and ``run_embedding`` in
``wembed_tpu/core/step.py`` (reference NewWEmbedEmbedder::calculateStep,
src/embeddingLib/src/embedder/NewWEmbedEmbedder.cpp:14-92):

  fused force kernel -> coincident kicks -> centre -> optimizer ->
  gravity recentring -> mean-squared-displacement convergence metric

PyTorch runs eagerly, so the loop is a Python loop.  It synchronises once
per step, to read the convergence metric, which keeps the stopping
iteration exactly the JAX package's.
"""

from __future__ import annotations

import torch

from . import forces
from ..kernels.fused_dense import fused_dense_forces
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


def fused_step(
    state: EmbedState,
    inv_w: torch.Tensor,
    adj: torch.Tensor,
    dg: DeviceGraph,
    opts: EmbedderOptions,
) -> EmbedState:
    """One iteration: the whole force pass in the fused kernel, then the
    elementwise updates of ``wembed_tpu/core/step.py:fused_step``."""
    old_positions = state.positions
    n, d = old_positions.shape
    force, zero_count, att_loss, rep_loss, rep_count = fused_dense_forces(
        old_positions,
        inv_w,
        dg.colors,
        adj,
        dim=d,
        L=opts.edge_length,
        att_scale=opts.attraction_scale,
        rep_scale=opts.repulsion_scale,
        additive=opts.additive_weights,
    )
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
        overflow=state.overflow,
    )


def run_embedding(
    state: EmbedState,
    inv_w: torch.Tensor,
    adj: torch.Tensor,
    dg: DeviceGraph,
    opts: EmbedderOptions,
    max_iterations: int,
) -> EmbedState:
    """calculateEmbedding: step until convergence.

    Continuation condition mirrors !isFinished() (NewWEmbedEmbedder.cpp:94-96,
    ``wembed_tpu/core/step.py:507-512``): iteration < maxIterations AND the
    last step moved vertices by at least positionMinChange on average."""
    while (
        state.iteration < max_iterations
        and float(state.pos_change) >= opts.position_min_change
    ):
        state = fused_step(state, inv_w, adj, dg, opts)
    return state
