"""The embedding steps and the embedding loop.

Counterpart of ``build_step`` and ``run_embedding`` in
``wembed_tpu/core/step.py`` (reference NewWEmbedEmbedder::calculateStep,
src/embeddingLib/src/embedder/NewWEmbedEmbedder.cpp:14-92):

  force pass -> coincident kicks -> centre -> optimizer ->
  gravity recentring -> mean-squared-displacement convergence metric

The force pass is the fused all-pairs kernel (``fused_step``, the dense
path), the span path's structures build, sweep kernel and edge pass
(``span_step``), or attraction and negative sampling (``sampled_step``).
``profiled_step`` runs any of the three split into the reference's timed
phases.  PyTorch runs eagerly, so the loop is a Python loop.  It
synchronises once per step, to read the convergence metric and the
overflow together, which keeps the stopping iteration exactly the JAX
package's.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from . import forces
from ..kernels.fused_dense import fused_dense_forces
from ..kernels.span_sparse import (
    SpanIndex,
    build_span_structures,
    span_fused_forces,
    span_repulsion_forces,
)
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


def _apply_forces(state: EmbedState, opts: EmbedderOptions, force, zero_count):
    """Coincident kicks, the centre force and the optimizer update: the
    profiled step's ``apply_forces`` phase.  Returns (positions, m, v, t).

    Coincident-point kicks (NewWEmbedEmbedder.cpp:229-233): one random unit
    vector per vertex, scaled by its coincident-pair count.  Drawn every
    step and multiplied by the count, so that no host branch (and no
    synchronisation) is needed to skip them; a zero count adds exactly 0."""
    old_positions = state.positions
    n, d = old_positions.shape
    kicks = forces.random_unit_vectors(state.generator, n, d, old_positions.dtype)
    force = force + kicks * zero_count[:, None].to(old_positions.dtype)

    if opts.centre_scale != 0.0:
        force = force + forces.centre_forces(old_positions, opts)

    t = state.iteration + 1
    positions, m, v = _apply_optimizer(opts, old_positions, force, state, t)
    return positions, m, v, t


def _next_state(state, positions, m, v, t, pos_change, att_loss, rep_loss, rep_count, overflow):
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


def _finish_step(
    state: EmbedState, opts: EmbedderOptions, force, zero_count, att_loss, rep_loss,
    rep_count, overflow,
) -> EmbedState:
    """Everything after the force pass: kicks, centre, optimizer, gravity
    and the convergence metric."""
    positions, m, v, t = _apply_forces(state, opts, force, zero_count)
    positions = forces.apply_gravity_centre(positions)
    pos_change = forces.mean_squared_displacement(state.positions, positions)
    return _next_state(
        state, positions, m, v, t, pos_change, att_loss, rep_loss, rep_count, overflow
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
    items: torch.Tensor,
    opts: EmbedderOptions,
) -> EmbedState:
    """One iteration of the span path (the ``fused_span`` branch of
    ``wembed_tpu/core/step.py:step``): structures, sweep kernel and the
    merged attraction/correction edge pass, with the windows ``blk_t`` and
    their work items ``items``."""
    force, att_loss, rep_loss, rep_count, overflow, zero_count = span_fused_forces(
        state.positions, inv_w, weights, dg.colors, index, opts, state.generator,
        blk_t=blk_t, items=items,
    )
    return _finish_step(
        state, opts, force, zero_count, att_loss, rep_loss, rep_count, overflow
    )


def _sampled_repulsion(state: EmbedState, inv_w, dg: DeviceGraph, opts: EmbedderOptions):
    """(force, loss, count, zero_count) of the sampled pass; with
    ``num_negative_samples == 0`` no repulsion at all and no draw
    (``wembed_tpu/core/step.py:396-400``)."""
    if opts.num_negative_samples == 0:
        pos = state.positions
        return (
            torch.zeros_like(pos),
            torch.zeros((), dtype=pos.dtype, device=pos.device),
            torch.zeros((), dtype=torch.int64, device=pos.device),
            torch.zeros((pos.shape[0],), dtype=torch.int32, device=pos.device),
        )
    return forces.sampled_repulsion_forces(state.positions, inv_w, dg, opts, state.generator)


def sampled_step(
    state: EmbedState, inv_w: torch.Tensor, dg: DeviceGraph, opts: EmbedderOptions
) -> EmbedState:
    """One iteration with negative-sampling repulsion (the non-fused
    branch of ``wembed_tpu/core/step.py:step`` with
    ``num_negative_samples >= 0``): attraction, then the sampled pass, then
    the rest of the step.  The generator draws the edge kicks (E, d), the
    candidates (n, k) and the vertex kicks (n, d), in this order."""
    force, att_loss = forces.attraction_forces(state.positions, inv_w, dg, opts, state.generator)
    rep_force, rep_loss, rep_count, zero_count = _sampled_repulsion(state, inv_w, dg, opts)
    return _finish_step(
        state, opts, force + rep_force, zero_count, att_loss, rep_loss, rep_count, state.overflow
    )


class PhaseClock:
    """Phase boundaries of one step: CUDA events recorded on the current
    stream of a CUDA device, or the host clock on the CPU.  ``seconds()``
    reads them all after one synchronisation, so that timing adds no wait
    between phases."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks: list[tuple[str | None, object]] = []
        self.mark(None)

    def mark(self, name: str | None) -> None:
        """Close phase ``name`` here (``None``: the start)."""
        if self._cuda:
            stamp = torch.cuda.Event(enable_timing=True)
            stamp.record()
        else:
            stamp = time.perf_counter()
        self._marks.append((name, stamp))

    def seconds(self) -> list[tuple[str, float]]:
        """(phase, seconds) in the order the phases ran."""
        if self._cuda:
            self._marks[-1][1].synchronize()
        out = []
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            s = a.elapsed_time(b) / 1000.0 if self._cuda else b - a
            out.append((name, s))
        return out


def profiled_step(
    path: str,
    state: EmbedState,
    weights: torch.Tensor,
    inv_w: torch.Tensor,
    dg: DeviceGraph,
    opts: EmbedderOptions,
    timer,
    adj: torch.Tensor | None = None,
    index: SpanIndex | None = None,
    blk_t: torch.Tensor | None = None,
    items: torch.Tensor | None = None,
) -> EmbedState:
    """One step split into the reference's phases (``index`` on the span
    path only, ``attracting_forces``, ``repelling_forces``,
    ``apply_forces``, ``gravity``, ``position_change``;
    NewWEmbedEmbedder.cpp:38-91), each timed by ``PhaseClock`` and added to
    ``timer`` under its name after the step's one synchronisation
    (``wembed_tpu/core/embedder.py:_calculate_step_profiled``, which blocks
    after every phase instead).

    Attraction is ``forces.attraction_forces`` on every path.  Repulsion:
      * span: the structures build is ``index``; ``span_repulsion_forces``
        over them launches the sweep kernel;
      * dense: the JAX package runs its unfused jnp repulsion here, since
        the fused Pallas kernel cannot be split.  The port runs the fused
        CUDA kernel itself with the attraction scale at 0: its repulsion
        mask, loss and count are the repulsion part, its force is then
        repulsion alone, and its coincident count loses the coincident
        edges, which the attraction pass kicks.  So the profile times the
        kernel that the normal step runs, and no plain version runs on the
        card;
      * sampled: the sampled pass.

    The generator draws what the normal step of the path draws, in the same
    order and shapes (edge kicks, candidates, vertex kicks), so the profiled
    span and sampled trajectories equal the normal ones up to summation
    order.  The normal dense step draws no edge kicks (its kernel does
    attraction), so the profiled dense step consumes more of the stream; the
    JAX package's profiled dense step kicks coincident edges too."""
    clock = PhaseClock(state.positions.device)
    pos = state.positions
    structures = None
    if path == "span":
        structures = build_span_structures(pos, inv_w, weights, dg.colors, index, opts, blk_t)
        clock.mark("index")
    force_att, att_loss = forces.attraction_forces(pos, inv_w, dg, opts, state.generator)
    clock.mark("attracting_forces")
    overflow = state.overflow
    if path == "span":
        rep_force, rep_loss, rep_count, overflow, zero_count = span_repulsion_forces(
            pos, inv_w, weights, dg.colors, index, opts, structures=structures, items=items
        )
    elif path == "dense":
        rep_force, zero_k, _, rep_loss, rep_count = fused_dense_forces(
            pos, inv_w, dg.colors, adj, dim=pos.shape[1], L=opts.edge_length, att_scale=0.0,
            rep_scale=opts.repulsion_scale, additive=opts.additive_weights,
        )
        zero_count = zero_k - forces.coincident_edge_counts(pos, dg)
    else:
        rep_force, rep_loss, rep_count, zero_count = _sampled_repulsion(state, inv_w, dg, opts)
    clock.mark("repelling_forces")
    positions, m, v, t = _apply_forces(state, opts, force_att + rep_force, zero_count)
    clock.mark("apply_forces")
    positions = forces.apply_gravity_centre(positions)
    clock.mark("gravity")
    pos_change = forces.mean_squared_displacement(pos, positions)
    clock.mark("position_change")
    for name, seconds in clock.seconds():
        timer.add(name, seconds)
    return _next_state(
        state, positions, m, v, t, pos_change, att_loss, rep_loss, rep_count, overflow
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
