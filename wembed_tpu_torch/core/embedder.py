"""The host-level embedder.

Counterpart of the flat ``WEmbedEmbedder`` of ``wembed_tpu/core/embedder.py``
(the reference's NewWEmbedEmbedder surface,
src/embeddingLib/include/embedder/EmbedderInterface.hpp:15-158):
``calculate_step`` runs one iteration, ``calculate_embedding`` runs the
loop to convergence.  Graphs up to ``dense_threshold`` vertices take the
dense path (the fused all-pairs kernel); larger ones the span path, with
its window growth protocol (``core/span_driver.py``); negative sampling
(``num_negative_samples >= 0``) takes the sampled path at any size.

``profile`` (also when set after construction) splits every step into the
reference's timed phases (``step.profiled_step``); ``opts.dump_weights``
appends the weights to ``weight_dump.txt`` every step; with either, the
loop is a host loop of ``calculate_step``.  ``opts.debug_checks`` raises
``FloatingPointError`` when a state tensor goes non-finite.  Checkpoints:
``core/checkpoint.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graphs.csr import CSRGraph
from ..utils import rng as rng_mod
from ..utils.timer import Timer, TimingResult
from . import forces
from . import step as step_mod
from . import weights as weights_mod
from ..kernels.span_sparse import SpanIndex, build_span_structures
from .options import EmbedderOptions
from .span_driver import SpanGrowthMixin
from .state import DeviceGraph, EmbedState, init_state, random_positions


class Loss:
    """Loss triple from the most recent step (reference include/wembed.h:43-48)."""

    def __init__(self, attractive: float, repulsive: float):
        self.attractive = float(attractive)
        self.repulsive = float(repulsive)

    @property
    def total(self) -> float:
        return self.attractive + self.repulsive

    def __repr__(self) -> str:
        return (
            f"Loss(attractive={self.attractive}, repulsive={self.repulsive}, "
            f"total={self.total})"
        )


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a torch.device; raises where it cannot run.  A missing
    CUDA never turns into the CPU: CPU runs ask for ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class WEmbedEmbedder(SpanGrowthMixin):
    """Flat (single-level) embedder on one device."""

    def __init__(
        self,
        graph: CSRGraph,
        opts: EmbedderOptions | None = None,
        timer: Timer | None = None,
        initial_coordinates: np.ndarray | None = None,
        initial_weights: np.ndarray | None = None,
        verbose: bool = True,
        profile: bool = False,
        device: torch.device | str = "cuda",
    ):
        self.opts = opts or EmbedderOptions()
        self.device = resolve_device(device)
        self._path = self.opts.resolve_path(graph.num_vertices)
        self._span = self._path == "span"
        self.graph = graph
        self.timer = timer or Timer()
        self.verbose = verbose
        # the profiled (phase-split) step, read at every step
        self.profile = profile
        self._dtype = torch.float64 if self.opts.dtype == "float64" else torch.float32
        self._dg = DeviceGraph.build(graph, self.device)
        # the dense path's (n, n) bit adjacency; the other paths never build it
        self._adj = forces.build_dense_adjacency(self._dg) if self._path == "dense" else None
        # the span path's windows and the sweep's work items (``_swap_index``)
        self._index: SpanIndex | None = None
        self._blk_t = self._items = None
        self._growth_events = 0
        self._shrink_events = 0
        n, d = graph.num_vertices, self.opts.embedding_dimension

        if initial_weights is None:
            initial_weights = weights_mod.initial_weights(graph, self.opts)
        if initial_coordinates is None:
            initial_coordinates = random_positions(n, d, rng_mod.host_rng())

        self._state = init_state(
            np.asarray(initial_coordinates, dtype=np.float64),
            rng_mod.new_generator(self.device),
            self._dtype,
            self.device,
        )
        self._set_weights_internal(np.asarray(initial_weights, dtype=np.float64))
        self._presize_spans()

    # -------------------------------------------------------------- internals
    def _set_weights_internal(self, w: np.ndarray) -> None:
        if w.shape != (self.graph.num_vertices,):
            raise ValueError(
                f"weights shape {w.shape} != ({self.graph.num_vertices},)"
            )
        self._weights_np = w
        self._weights = torch.as_tensor(w, dtype=self._dtype, device=self.device)
        self._inv_w = torch.as_tensor(
            weights_mod.inv_exp_weights(w, self.opts.embedding_dimension),
            dtype=self._dtype,
            device=self.device,
        )
        if self._span:
            # the weight groups, hence the whole skeleton, follow the weights
            self._growth_events = 0
            self._swap_index(
                SpanIndex.build(w, self.opts, self.graph.edge_src, self.graph.col_idx)
            )

    # span growth protocol: SpanGrowthMixin (core/span_driver.py)
    def _swap_index(self, index: SpanIndex) -> None:
        """Install resized windows: the skeleton's device tables are shared,
        only the (NB, R) window widths and the sweep's work items move to
        the device, once per window change."""
        self._index = index
        self._blk_t = index.blk_t_tensor(self.device)
        self._items = index.work_items(self.device)

    def _span_structures(self):
        return build_span_structures(
            self._state.positions, self._inv_w, self._weights, self._dg.colors,
            self._index, self.opts, self._blk_t,
        )

    def _step(self, state: EmbedState) -> EmbedState:
        if self._span:
            return step_mod.span_step(
                state, self._weights, self._inv_w, self._dg, self._index, self._blk_t,
                self._items, self.opts,
            )
        if self._path == "sampled":
            return step_mod.sampled_step(state, self._inv_w, self._dg, self.opts)
        return step_mod.fused_step(state, self._inv_w, self._adj, self._dg, self.opts)

    def _profiled_step(self, state: EmbedState) -> EmbedState:
        return step_mod.profiled_step(
            self._path, state, self._weights, self._inv_w, self._dg, self.opts, self.timer,
            adj=self._adj, index=self._index, blk_t=self._blk_t, items=self._items,
        )

    # ------------------------------------------------------------ embedding
    def calculate_step(self) -> None:
        """One iteration (reference NewWEmbedEmbedder.cpp:14-92)."""
        if self.graph.num_vertices <= 1:
            # coarsest-hierarchy-layer short-circuit
            # (NewWEmbedEmbedder.cpp:25-28)
            self._state = dataclasses.replace(
                self._state,
                iteration=self._state.iteration + 1,
                pos_change=torch.zeros((), dtype=torch.float32, device=self.device),
            )
            return
        if self.profile:
            self._state = self._profiled_step(self._state)
        else:
            with self.timer.phase("step", "Embedding step", self.device):
                self._state = self._step(self._state)
        it = self._state.iteration
        if self.opts.debug_checks:
            self._debug_validate()
        if self.opts.dump_weights:
            self._dump_weights(it)
        if self.verbose and (it == 1 or (it > 0 and it % 10 == 0)):
            print(
                f"(Iteration {it}: #rep forces {int(self._state.num_rep_forces)}, "
                f"relative pos change: {float(self._state.pos_change)})"
            )

    def _debug_validate(self) -> None:
        """Raise FloatingPointError if any state tensor went non-finite: the
        runtime analogue of the reference's ASSERT / NaN-poisoning machinery
        (DVec.hpp:89-94,693-697).  The JAX package also turns on its global
        ``jax_debug_nans``; torch has no such switch, so the check runs after
        every ``calculate_step`` and at the end of ``calculate_embedding``."""
        s = self._state
        for name in ("positions", "adam_m", "adam_v", "attract_loss", "repel_loss", "pos_change"):
            # pos_change is inf before the first step by construction
            if name == "pos_change" and s.iteration == 0:
                continue
            bad = int(torch.sum(~torch.isfinite(getattr(s, name))))
            if bad:
                raise FloatingPointError(
                    f"debug_checks: {bad} non-finite entries in {name} at iteration {s.iteration}"
                )

    def _dump_weights(self, iteration: int) -> None:
        """Append the current weights to weight_dump.txt, truncating it on
        the first iteration (reference NewWEmbedEmbedder.cpp:161-186)."""
        mode = "w" if iteration <= 1 else "a"
        with open("weight_dump.txt", mode) as f:
            f.write(" ".join(repr(float(w)) for w in self._weights_np) + " \n")

    def is_finished(self) -> bool:
        return self._state.iteration >= self.opts.max_iterations or (
            self._state.iteration > 0
            and float(self._state.pos_change) < self.opts.position_min_change
        )

    def calculate_embedding(self, max_iterations: int | None = None) -> None:
        """Step until convergence.  ``max_iterations`` optionally caps this
        CALL below the configured budget (segmented runs)."""
        cap = self.opts.max_iterations if max_iterations is None else min(
            max_iterations, self.opts.max_iterations
        )
        if self.graph.num_vertices <= 1:
            self._state = dataclasses.replace(
                self._state,
                pos_change=torch.zeros((), dtype=torch.float32, device=self.device),
            )
            return
        min_change = self.opts.position_min_change
        with self.timer.phase("embedding_all", "Embedding", self.device):
            if self.opts.dump_weights or self.profile:
                self._host_loop(cap)
            elif not self._span:
                self._state = step_mod.run_embedding(self._step, self._state, cap, min_change)
            else:

                def run_segment(seg_cap, stop_on_overflow):
                    self._state = step_mod.run_embedding(
                        self._step, self._state, seg_cap, min_change, stop_on_overflow
                    )

                self._drive_span_loop(run_segment, cap)
        if self.opts.debug_checks:
            self._debug_validate()

    def _host_loop(self, cap: int) -> None:
        """``calculate_step`` until convergence or ``cap``: weight dumping
        needs a host action a step (reference NewWEmbedEmbedder.cpp:36), and
        the profiled step times each one.  Truncated span windows grow right
        after the step that overflowed (``wembed_tpu/core/embedder.py:
        337-364``); no segment boundaries, so windows never shrink here."""
        while True:
            while not self.is_finished() and self._state.iteration < cap:
                self.calculate_step()
                overflow = int(self._state.overflow)
                if overflow > 0 and self._span and self._grow_spans():
                    self._announce_growth(overflow)
                    self._state = dataclasses.replace(
                        self._state, overflow=torch.zeros_like(self._state.overflow)
                    )
            if self._state.iteration >= cap:
                break
            if int(self._state.overflow) == 0 or not self._span or not self._grow_spans():
                break
            self._state = dataclasses.replace(
                self._state,
                pos_change=torch.full_like(self._state.pos_change, float("inf")),
                overflow=torch.zeros_like(self._state.overflow),
            )

    # ------------------------------------------------------------- accessors
    @property
    def state(self) -> EmbedState:
        return self._state

    @state.setter
    def state(self, s: EmbedState) -> None:
        self._state = s

    def get_coordinates(self) -> np.ndarray:
        return self._state.positions.detach().to("cpu", torch.float64).numpy()

    def get_weights(self) -> np.ndarray:
        return self._weights_np.copy()

    def set_coordinates(self, coordinates: np.ndarray) -> None:
        coordinates = np.asarray(coordinates, dtype=np.float64)
        n, d = self.graph.num_vertices, self.opts.embedding_dimension
        if coordinates.shape[0] != n:
            raise ValueError(f"expected {n} coordinate rows, got {coordinates.shape[0]}")
        if coordinates.shape[1] != d:
            # reference warns and copies the overlapping prefix
            # (NewWEmbedEmbedder.cpp:125-140)
            current = self.get_coordinates()
            k = min(d, coordinates.shape[1])
            current[:, :k] = coordinates[:, :k]
            coordinates = current
        self._state = dataclasses.replace(
            self._state,
            positions=torch.as_tensor(coordinates, dtype=self._dtype, device=self.device),
        )
        self._presize_spans()

    def set_weights(self, w: np.ndarray) -> None:
        self._set_weights_internal(np.asarray(w, dtype=np.float64))
        self._presize_spans()

    def get_timings(self) -> list[TimingResult]:
        return self.timer.results()

    def get_loss(self) -> Loss:
        return Loss(float(self._state.attract_loss), float(self._state.repel_loss))

    @property
    def iteration(self) -> int:
        return self._state.iteration

    @property
    def path(self) -> str:
        """``"sampled"`` with negative sampling on; else ``"span"`` above
        ``dense_threshold`` (or under ``RepulsionMode.BUCKET``), and
        ``"dense"`` below."""
        return self._path

    @property
    def growth_events(self) -> int:
        """Window growths of the span path since the weights were set."""
        return self._growth_events

    @property
    def final_overflow(self) -> int:
        """Truncated candidate pairs of the last step (0 on the dense path)."""
        return int(self._state.overflow)

    @property
    def num_vertices(self) -> int:
        return self.graph.num_vertices

    @property
    def embedding_dimension(self) -> int:
        return self.opts.embedding_dimension
