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
phases.  The loop is a Python loop.  It synchronises once per step, to
read the convergence metric and the overflow together, which keeps the
stopping iteration exactly the JAX package's.  On one CUDA device the
dense and span steps are captured into CUDA graphs and replayed
(``StepGraph``): the same kernels on the same inputs, bitwise the eager
step, from one or two graph launches in place of the step's host
launches.  The optimizer's step-dependent scalars reach a step as a
device tensor (``optim.Schedule``), so that a replayed step reads its
own.

With a ``Share`` the force pass computes one rank's partial of the
replicated multi-device step (``distributed/step.py``) and the share's
``reduce`` sums every rank's partials; what follows the force pass runs
whole, the same on every rank.  With the whole range a share's pass is the
single-device pass.

The generator's stream a step, in order: the partial index's member key
(span path, ``index_size < 1``: (n,) f64), the edge kicks (span, sampled
and profiled steps: (E, d)), the negative samples (sampled path: (n, k)),
then the vertex kicks ((n, d), after the reduction).  Every draw is whole
on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable

import torch

from . import forces
from .. import kernels
from ..kernels.fused_dense import fused_dense_forces
from ..kernels.span_compact import CellIndex
from ..kernels.span_sparse import SpanIndex, span_fused_forces, span_repulsion_forces
from ..kernels.span_sweep import sweep_outputs as span_sweep_outputs
from .optim import AdamParams, adam_update, simple_update
from .options import EmbedderOptions, OptimizerType
from .state import DeviceGraph, EmbedState


@dataclass(frozen=True)
class Share:
    """One rank's share of a step's force pass.  Each pass cuts its work
    (dense rows, sweep work items, directed edges, sampled rows) into
    ``size`` contiguous ranges of ceil(total / size), as the JAX package
    cuts its shards (``wembed_tpu/core/forces.py:117-126``); ``reduce``
    takes (force (n, d), zero_count (n,), att_loss, rep_loss, rep_count,
    overflow or None), every rank's partials, and returns their totals in
    the same form."""

    rank: int
    size: int
    reduce: Callable

    def cut(self, total: int) -> tuple[int, int]:
        per = -(-total // self.size)
        lo = min(self.rank * per, total)
        return lo, min(lo + per, total)


def _apply_optimizer(opts, old_positions, force, state: EmbedState, scalars: torch.Tensor):
    """Positions + fresh moment tensors after one optimizer update, with
    the step's (3,) optimizer scalars (``optim.Schedule.at``).

    SIMPLE is the reference's clip-then-cooled-LR optimizer
    (SimpleOptimizer.cpp:17-41, maxDisplacement=1); it keeps the (unused)
    Adam moments untouched."""
    if opts.optimizer_type is OptimizerType.SIMPLE:
        positions = simple_update(
            old_positions, force, scalars, opts.learning_rate, opts.cooling_factor
        )
        return positions, state.adam_m, state.adam_v
    hp = AdamParams(opts.learning_rate, opts.cooling_factor)
    return adam_update(old_positions, force, state.adam_m, state.adam_v, scalars, hp)


def _apply_forces(
    state: EmbedState, opts: EmbedderOptions, force, zero_count, scalars: torch.Tensor, n=None,
    own_rows=None,
):
    """Coincident kicks, the centre force and the optimizer update with
    the step's optimizer ``scalars``: the profiled step's ``apply_forces``
    phase.  Returns (positions, m, v, t).

    Coincident-point kicks (NewWEmbedEmbedder.cpp:229-233): one random unit
    vector per vertex, scaled by its coincident-pair count.  Drawn every
    step and multiplied by the count, so that no host branch (and no
    synchronisation) is needed to skip them; a zero count adds exactly 0.
    A halo rank, whose state holds its rows of the graph's ``n``, passes
    ``n`` and ``own_rows``, which picks its rows of the whole draw."""
    old_positions = state.positions
    d = old_positions.shape[1]
    kicks = forces.random_unit_vectors(state.generator, n or old_positions.shape[0], d, old_positions.dtype)
    if own_rows is not None:
        kicks = own_rows(kicks)
    force = force + kicks * zero_count[:, None].to(old_positions.dtype)

    if opts.centre_scale != 0.0:
        force = force + forces.centre_forces(old_positions, opts)

    t = state.iteration + 1
    positions, m, v = _apply_optimizer(opts, old_positions, force, state, scalars)
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
    state: EmbedState, opts: EmbedderOptions, scalars, force, zero_count, att_loss, rep_loss,
    rep_count, overflow,
) -> EmbedState:
    """Everything after the force pass: kicks, centre, optimizer, gravity
    and the convergence metric."""
    positions, m, v, t = _apply_forces(state, opts, force, zero_count, scalars)
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
    scalars: torch.Tensor,
    share: Share | None = None,
) -> EmbedState:
    """One iteration of the dense path: the whole force pass in the fused
    kernel (``wembed_tpu/core/step.py:fused_step``), or the share's rows
    of it; ``scalars`` are the step's optimizer scalars
    (``optim.Schedule.at``)."""
    n, d = state.positions.shape
    rows = None if share is None else share.cut(n)
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
        rows=rows,
    )
    if share is not None:
        force = forces.widen_rows(force, n, rows[0])
        zero_count = forces.widen_rows(zero_count, n, rows[0])
        force, zero_count, att_loss, rep_loss, rep_count, _ = share.reduce(
            force, zero_count, att_loss, rep_loss, rep_count, None
        )
    return _finish_step(
        state, opts, scalars, force, zero_count, att_loss, rep_loss, rep_count, state.overflow
    )


def span_step(
    state: EmbedState,
    weights: torch.Tensor,
    inv_w: torch.Tensor,
    dg: DeviceGraph,
    index: SpanIndex | CellIndex,
    blk_t: torch.Tensor,
    items: torch.Tensor,
    opts: EmbedderOptions,
    scalars: torch.Tensor,
    share: Share | None = None,
    sweep=None,
) -> EmbedState:
    """One iteration of the span path (the ``fused_span`` branch of
    ``wembed_tpu/core/step.py:step``): structures, sweep kernel and the
    merged attraction/correction edge pass, with the windows ``blk_t`` (a
    cell index: its (NB, 1) capacities) and their work items ``items``;
    under a partial index, with this step's member sample, drawn first.
    ``sweep`` makes the sweep kernel's call (``StepGraph``)."""
    in_index = index.draw_members(state.generator)
    force, att_loss, rep_loss, rep_count, overflow, zero_count = span_fused_forces(
        state.positions, inv_w, weights, dg.colors, index, opts, state.generator,
        blk_t=blk_t, items=items, in_index=in_index, share=share, sweep=sweep,
    )
    if share is not None:
        force, zero_count, att_loss, rep_loss, rep_count, overflow = share.reduce(
            force, zero_count, att_loss, rep_loss, rep_count, overflow
        )
    return _finish_step(
        state, opts, scalars, force, zero_count, att_loss, rep_loss, rep_count, overflow
    )


def _sampled_repulsion(state: EmbedState, inv_w, dg: DeviceGraph, opts: EmbedderOptions, share=None):
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
    return forces.sampled_repulsion_forces(
        state.positions, inv_w, dg, opts, state.generator, share
    )


def sampled_step(
    state: EmbedState,
    inv_w: torch.Tensor,
    dg: DeviceGraph,
    opts: EmbedderOptions,
    scalars: torch.Tensor,
    share: Share | None = None,
) -> EmbedState:
    """One iteration with negative-sampling repulsion (the non-fused
    branch of ``wembed_tpu/core/step.py:step`` with
    ``num_negative_samples >= 0``): attraction, then the sampled pass, then
    the rest of the step.  The generator draws the edge kicks (E, d), the
    candidates (n, k) and the vertex kicks (n, d), in this order."""
    force, att_loss = forces.attraction_forces(
        state.positions, inv_w, dg, opts, state.generator, share
    )
    rep_force, rep_loss, rep_count, zero_count = _sampled_repulsion(state, inv_w, dg, opts, share)
    force = force + rep_force
    if share is not None:
        force, zero_count, att_loss, rep_loss, rep_count, _ = share.reduce(
            force, zero_count, att_loss, rep_loss, rep_count, None
        )
    return _finish_step(
        state, opts, scalars, force, zero_count, att_loss, rep_loss, rep_count, state.overflow
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
    scalars: torch.Tensor,
    timer,
    adj: torch.Tensor | None = None,
    index: SpanIndex | CellIndex | None = None,
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
      * span: the structures build is ``index`` (either layout's:
        ``build_span_structures`` or the cell layout's
        ``build_cell_structures``); ``span_repulsion_forces`` over them
        launches the sweep kernel and runs the neighbour correction;
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
    structures = in_index = None
    if path == "span":
        in_index = index.draw_members(state.generator)
        structures = index.structures(pos, inv_w, weights, dg.colors, opts, blk_t, in_index)
        clock.mark("index")
    force_att, att_loss = forces.attraction_forces(pos, inv_w, dg, opts, state.generator)
    clock.mark("attracting_forces")
    overflow = state.overflow
    if path == "span":
        rep_force, rep_loss, rep_count, overflow, zero_count = span_repulsion_forces(
            pos, inv_w, weights, dg.colors, index, opts, structures=structures, items=items,
            in_index=in_index,
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
    positions, m, v, t = _apply_forces(state, opts, force_att + rep_force, zero_count, scalars)
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


# the state fields a captured step reads and writes in place
_STATE_TENSORS = (
    "positions", "adam_m", "adam_v", "attract_loss", "repel_loss", "pos_change", "num_rep_forces",
    "overflow",
)
_capture_streams: dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a device for every warm-up and capture: a capture
    cannot run on the default stream, and each stream that runs a matmul
    keeps its own cuBLAS workspace, made at its first use (so here once a
    device, in a warm-up, never inside a capture)."""
    if device.index not in _capture_streams:
        _capture_streams[device.index] = torch.cuda.Stream(device)
    return _capture_streams[device.index]


def _on_capture_stream(device: torch.device, fn):
    """``fn()`` on the device's capture stream, ordered after the current
    stream's work and before its later work."""
    stream, current = _capture_stream(device), torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


def _new_graph(generator: torch.Generator) -> torch.cuda.CUDAGraph:
    """A graph with ``generator`` registered, so that every replay draws
    from the generator's offset at the replay."""
    graph = torch.cuda.CUDAGraph()
    register = getattr(graph, "register_generator_state", None)
    if register is None:
        raise RuntimeError(
            f"torch {torch.__version__} cannot register a generator with a CUDA graph: "
            "a captured step would replay its first step's draws"
        )
    register(generator)
    return graph


def _free(graphs: list) -> None:
    """Free captured graphs (None: the CPU's stand-in, nothing to free)."""
    for graph in graphs:
        if graph is not None:
            graph.reset()


class StepGraph:
    """One device's dense or span step, captured into CUDA graphs once and
    replayed every iteration: one graph launch in place of the dense
    step's host launches; on the span path two graphs around the sweep
    kernel, which runs eagerly between them.

    Buffers.  A graph reads and writes fixed addresses: the runner owns
    one tensor of each state field (``_STATE_TENSORS``) and the (3,)
    optimizer scalars.  The captured step's last operations copy the new
    state into those buffers, and ``step`` returns a state whose tensors
    are the buffers, so the next step overwrites them.  Before a replay
    the host copies the step's schedule row into the scalars, and any
    state tensor that is not the runner's buffer (one assigned from
    outside, as the growth protocol resets the overflow) into its buffer.

    The sweep.  Its launch grid is the work items' count, which moves at
    every window growth and shrink; outside the graphs, it takes each
    step's current work items (``items``), so the graphs stay valid when
    the windows change.  The step function calls ``sweep(kernel, *args,
    **kw)`` where it would call ``kernel(*args, **kw)``: at the capture
    that ends the first graph, gives the sweep's outputs fixed buffers
    and begins the second; at a replay the runner launches ``kernel``
    between the two graphs on the inputs the first graph writes, with
    the current work items, and copies its outputs into those buffers.

    Capture.  The first step after construction or ``reset`` runs eagerly
    on the capture stream: a real step, whose result is kept, that loads
    the kernels and fills the caches a capture may not fill.  The next
    step captures and replays.  The state's generator is registered with
    the graphs, so the capture draws nothing and each replay draws where
    an eager step would: from the generator's offset at the replay.  A
    capture that fails raises; nothing falls back to an eager step.

    Recapture.  The graphs hold the addresses and shapes of everything the
    step reads besides the state, the scalars and the work items: weights,
    the index's tables and its windows tensor (whose values a windows
    change rewrites in place, ``WEmbedEmbedder._swap_index``).  Whoever
    replaces one calls ``reset`` (the embedder does for new weights, a new
    index shape or cell capacities, and state installed from outside); a
    state with another generator resets too.  The dropped graphs are
    never replayed again; the next capture takes their memory pool and
    then frees them.

    Counters.  A capture calls the wrappers of the kernels inside the
    graphs and launches nothing; a replay launches those kernels and calls
    no wrapper (the sweep's wrapper, called at every replay, counts
    itself).  So the runner takes back the counts the capture made and
    adds them at every replay: the wrappers' counters
    (``kernels.launch_counts``) count the kernels that ran.

    On the CPU (the tests' runner; the embedder replays only on a CUDA
    device) a capture runs the step once and undoes it, and a replay runs
    the step whole, with the counters kept as a CUDA replay keeps them."""

    def __init__(self, device: torch.device):
        self._device = device
        self.captures = 0
        self._graphs: list = []
        self._retired: list = []
        self.reset()

    def reset(self) -> None:
        """Drop the graphs and the buffers: the next step runs eagerly."""
        if self._graphs:
            _free(self._retired)
            self._retired = self._graphs
        self._graphs = []
        self._buffers = self._scalars = self._counts = self._sweep = None
        self._warm = False

    @property
    def captured(self) -> bool:
        return bool(self._graphs)

    def step(self, state: EmbedState, step_fn, scalars: torch.Tensor, items=None) -> EmbedState:
        """The step after ``state``: ``step_fn(state, scalars, sweep)`` run
        eagerly (``sweep`` None) or replayed.  ``scalars`` is the step's
        row of the optimizer schedule, ``items`` the sweep's current work
        items (span path)."""
        if self._graphs and state.generator is not self._buffers.generator:
            self.reset()
        if not self._graphs:
            if not self._warm:
                self._warm = True
                return self._eager(lambda: step_fn(state, scalars, None))
            self._record(state, step_fn, scalars)
        for name in _STATE_TENSORS:
            src, buf = getattr(state, name), getattr(self._buffers, name)
            if src is not buf:
                buf.copy_(src)
        self._scalars.copy_(scalars)
        if self._device.type == "cuda":
            self._replay(items)
        else:
            self._replay_on_host(step_fn)
        kernels.add_to_counters(self._counts)
        return dataclasses.replace(self._buffers, iteration=state.iteration + 1)

    def _eager(self, fn) -> EmbedState:
        """A warm-up step, on the capture stream on the card: its state
        tensors are then used on the current stream."""
        if self._device.type != "cuda":
            return fn()
        new = _on_capture_stream(self._device, fn)
        current = torch.cuda.current_stream(self._device)
        for name in _STATE_TENSORS:
            getattr(new, name).record_stream(current)
        return new

    def _body(self, step_fn, sweep) -> None:
        """The captured step: the state's buffers in, the new state copied
        into them last."""
        new = step_fn(self._buffers, self._scalars, sweep)
        for name in _STATE_TENSORS:
            out, buf = getattr(new, name), getattr(self._buffers, name)
            if out is not buf:
                buf.copy_(out)

    def _record(self, state: EmbedState, step_fn, scalars: torch.Tensor) -> None:
        self._buffers = dataclasses.replace(
            state, **{name: getattr(state, name).clone() for name in _STATE_TENSORS}
        )
        self._scalars = scalars.clone()
        before = kernels.counters()
        retired, self._retired = self._retired, []
        if self._device.type == "cuda":
            pool = retired[0].pool() if retired else None
            self._graphs = _on_capture_stream(
                self._device, lambda: self._capture(step_fn, state.generator, pool)
            )
        else:
            self._dry_run(step_fn, state.generator)
        _free(retired)
        self._counts = tuple(k - c for k, c in zip(kernels.counters(), before))
        kernels.add_to_counters(tuple(-k for k in self._counts))
        self.captures += 1

    def _split_at_sweep(self, split):
        """The ``sweep`` a capture passes to the step: ``split()`` ends the
        first graph and begins the second; the sweep's outputs get fixed
        buffers, which the second graph reads."""

        def sweep(kernel, *args, **kw):
            if self._sweep is not None:
                raise RuntimeError("a captured step runs one sweep")
            split()
            outputs = span_sweep_outputs(args[0].shape[0], kw["dim"], args[0].dtype, args[0].device)
            self._sweep = (kernel, args, kw, outputs)
            return outputs

        return sweep

    def _capture(self, step_fn, generator: torch.Generator, pool) -> list:
        graphs = []

        def begin():
            graph = _new_graph(generator)
            graph.capture_begin(pool=graphs[0].pool() if graphs else pool)
            graphs.append(graph)

        def split():
            graphs[-1].capture_end()
            begin()

        begin()
        try:
            self._body(step_fn, self._split_at_sweep(split))
        except Exception as err:
            try:
                graphs[-1].capture_end()
            except RuntimeError:
                pass  # the capture is invalid; the error that made it so is raised
            err.add_note("raised while capturing an embedding step into a CUDA graph")
            raise
        graphs[-1].capture_end()
        return graphs

    def _replay(self, items) -> None:
        self._graphs[0].replay()
        if self._sweep is not None:
            kernel, args, kw, outputs = self._sweep
            for out, new in zip(outputs, kernel(*args, **{**kw, "items": items})):
                out.copy_(new)
            self._graphs[1].replay()

    def _dry_run(self, step_fn, generator: torch.Generator) -> None:
        """The CPU's capture: the step run once, as a capture runs its
        Python, then its effects on the buffers and the generator undone,
        as a capture executes nothing."""
        saved = [getattr(self._buffers, name).clone() for name in _STATE_TENSORS]
        drawn = generator.get_state()
        self._body(step_fn, self._split_at_sweep(lambda: None))
        for name, value in zip(_STATE_TENSORS, saved):
            getattr(self._buffers, name).copy_(value)
        generator.set_state(drawn)
        self._graphs = [None]  # no graph: the replay runs the step

    def _replay_on_host(self, step_fn) -> None:
        """The CPU's replay: the step run whole, with the counters left as
        a CUDA replay leaves them: the sweep's wrapper counted, the
        wrappers inside the graphs not (the caller adds their captured
        counts)."""
        before = kernels.counters()
        swept = [0] * len(before)

        def sweep(kernel, *args, **kw):
            start = kernels.counters()
            out = kernel(*args, **kw)
            swept[:] = [k - c for k, c in zip(kernels.counters(), start)]
            return out

        self._body(step_fn, sweep)
        kernels.add_to_counters(tuple(b + w - k for b, w, k in zip(before, swept, kernels.counters())))
