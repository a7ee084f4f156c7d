"""Multilevel (layered) embedder.

Counterpart of ``wembed_tpu/multilevel/layered.py`` (the reference's
LayeredEmbedder, src/embeddingLib/src/embedder/LayeredEmbedder.cpp): build a
label-propagation hierarchy, embed the coarsest layer with a flat
embedder, then repeatedly expand to the next-finer layer —
``child = geometricStretch * parentPos + sphereSize * randomUnitVec`` with
``geometricStretch = (newN/oldN)^(1/d) * expansionStretch``
(LayeredEmbedder.cpp:46-94) — starting a FRESH flat embedder (fresh Adam
state and iteration counter) per layer, with per-layer degree weights.

Every layer's embedder runs on ``device``: layers up to ``dense_threshold``
vertices take the dense kernel, larger ones the span path.  The coarser
embedder is dropped before the finer one is built, so its device tensors
are free for the finer layer (the JAX package clears its compile caches at
that point instead).

The host draws come in the JAX package's order — the finer layer's
weights, one ``normal(size=(new_n, d))`` from the host stream, then the new
embedder, which draws its generator seed from the same stream — so a CPU
run starts every layer where the JAX package's does.

``layer_records`` holds one ``LayerRecord`` a layer, filled when the
layer's loop ends, by ``calculate_embedding`` or step by step;
``hierarchy_seconds`` is the coarsening time.  A checkpoint
(``core/checkpoint.py``) restores mid-hierarchy through ``restore_layer``.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core import weights as weights_mod
from ..core.embedder import Loss, WEmbedEmbedder, resolve_device
from ..core.options import EmbedderOptions, PartitionerOptions, WeightType
from ..graphs.csr import CSRGraph
from ..kernels import launch_counts
from ..utils import rng as rng_mod
from ..utils.timer import Timer, TimingResult
from .hierarchy import ExpansionMode, GraphHierarchy
from .label_prop import coarsen_all_layers


@dataclass
class LayerRecord:
    """What one layer of a ``calculate_embedding`` run took.  Seconds are
    host-clock, each ending in a synchronisation of a CUDA device."""

    layer: int  # hierarchy index; 0 is the input graph
    n: int
    path: str  # "dense", "span" or "sampled"
    construct_s: float  # building the layer's embedder (span presize included)
    loop_s: float = 0.0  # from the layer's first step to the end of its last
    iterations: int = 0
    launches: dict[str, int] = field(default_factory=dict)  # per CUDA kernel, in the loop
    growth_events: int = 0
    final_overflow: int = 0
    # torch.cuda.max_memory_allocated after the layer's loop: the device's
    # peak since the caller last reset it; CUDA devices only
    peak_mem_bytes: int | None = None


class LayeredEmbedder:
    def __init__(
        self,
        graph: CSRGraph,
        opts: EmbedderOptions | None = None,
        timer: Timer | None = None,
        partitioner_opts: PartitionerOptions | None = None,
        # SIBLING_SPHERE by default, as in the JAX package: the reference's
        # expansion places all children EXACTLY on their parent (its
        # GraphHierarchy never populates totalContainedNodes, so
        # sphere_size = 0^(1/d) = 0 — SURVEY 2.5) and relies on
        # coincident-point kicks to separate them.  ExpansionMode.REFERENCE
        # remains for bug-for-bug parity runs.
        expansion_mode: ExpansionMode = ExpansionMode.SIBLING_SPHERE,
        verbose: bool = True,
        profile: bool = False,
        embedder_factory: Callable | None = None,
        device: torch.device | str = "cuda",
    ):
        """``embedder_factory(graph, opts, *, timer, initial_coordinates,
        initial_weights, verbose, profile, device)`` builds the per-layer
        flat embedder — the hook that composes multilevel with other
        backends (the reference's multilevel mode composes with its whole
        embedder surface, src/wembed.cpp:180-187).  Default: the
        single-device ``WEmbedEmbedder``; another factory's embedder has
        its public surface, ``path``, ``growth_events`` and
        ``final_overflow`` included."""
        self.device = resolve_device(device)
        self.graph = graph
        self.opts = opts or EmbedderOptions()
        self.timer = timer or Timer()
        self.expansion_mode = expansion_mode
        self.verbose = verbose
        self._current = None
        self.profile = profile
        self.embedder_factory = embedder_factory
        self.layer_records: list[LayerRecord] = []
        self._loop_start: tuple[float, dict[str, int]] | None = None

        t0 = time.perf_counter()
        result = coarsen_all_layers(graph, opts=partitioner_opts)
        self.hierarchy = GraphHierarchy.build(result)
        self.hierarchy_seconds = time.perf_counter() - t0
        self.current_layer = self.hierarchy.num_layers - 1
        self.current_iteration = 0
        self._current = self._make_embedder(
            self.hierarchy.layers[self.current_layer].graph
        )

    @property
    def profile(self) -> bool:
        """The profiled step, passed to every layer's embedder; setting it
        reaches the current layer's too (the ``embed`` CLI sets it after
        construction)."""
        return self._profile

    @profile.setter
    def profile(self, on: bool) -> None:
        self._profile = on
        if self._current is not None:
            self._current.profile = on

    def restore_layer(
        self,
        hierarchy: GraphHierarchy,
        layer: int,
        iteration: int,
        positions: np.ndarray,
        weights: np.ndarray,
    ) -> None:
        """Install ``hierarchy`` and rebuild layer ``layer``'s embedder at
        ``positions`` and ``weights``, with the accumulated ``iteration``
        count: a checkpoint's restore (``core/checkpoint.py``), which then
        restores that embedder's state.  ``layer_records`` start again at
        this layer."""
        self.hierarchy = hierarchy
        self.current_layer = layer
        self.current_iteration = iteration
        self.layer_records = []
        self._current = None
        self._current = self._make_embedder(hierarchy.layers[layer].graph, positions, weights)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _make_embedder(
        self,
        graph: CSRGraph,
        initial_coordinates: np.ndarray | None = None,
        initial_weights: np.ndarray | None = None,
    ):
        factory = self.embedder_factory or WEmbedEmbedder
        t0 = time.perf_counter()
        embedder = factory(
            graph,
            self.opts,
            timer=self.timer,
            initial_coordinates=initial_coordinates,
            initial_weights=initial_weights,
            verbose=self.verbose,
            profile=self.profile,
            device=self.device,
        )
        self._sync()
        self.layer_records.append(LayerRecord(
            layer=self.current_layer,
            n=graph.num_vertices,
            path=embedder.path,
            construct_s=time.perf_counter() - t0,
        ))
        self._loop_start = None
        return embedder

    # ------------------------------------------------------------- stepping
    def calculate_step(self) -> None:
        """(LayeredEmbedder.cpp:5-11)"""
        self.current_iteration += 1
        if self._current.is_finished() and self.current_layer > 0:
            self._expand_positions()
        self._open_loop()
        self._current.calculate_step()
        if self._current.is_finished():
            self._close_record()

    def is_finished(self) -> bool:
        return self.current_layer == 0 and self._current.is_finished()

    def calculate_embedding(self) -> None:
        with self.timer.phase("embedding_all", "Embedding", self.device):
            while True:
                # run the current layer to convergence, then expand
                self._run_layer()
                self.current_iteration += self._current.iteration
                if self.current_layer == 0:
                    break
                self._expand_positions()

    def _run_layer(self) -> None:
        self._open_loop()
        self._current.calculate_embedding()
        self._close_record()

    def _open_loop(self) -> None:
        """Start the current layer's loop clock and launch counts, once."""
        if self._loop_start is None:
            self._loop_start = (time.perf_counter(), launch_counts())

    def _close_record(self) -> None:
        """Fill the current layer's ``LayerRecord`` from its embedder; a
        step past convergence updates it."""
        self._sync()
        t0, before = self._loop_start
        record = self.layer_records[-1]
        record.loop_s = time.perf_counter() - t0
        record.launches = {k: v - before[k] for k, v in launch_counts().items()}
        record.iterations = self._current.iteration
        record.growth_events = self._current.growth_events
        record.final_overflow = self._current.final_overflow
        if self.device.type == "cuda":
            record.peak_mem_bytes = torch.cuda.max_memory_allocated(self.device)

    # ------------------------------------------------------------ expansion
    def _expand_positions(self) -> None:
        """(LayeredEmbedder.cpp:46-94)"""
        with self.timer.phase("expanding", "Expanding Positions"):
            d = self.opts.embedding_dimension
            finer = self.hierarchy.layers[self.current_layer - 1]
            new_n = finer.graph.num_vertices
            old_n = self.hierarchy.layers[self.current_layer].graph.num_vertices
            old_positions = self._current.get_coordinates()

            if self.opts.weight_type is WeightType.DEGREE:
                new_weights = weights_mod.rescale_weights(
                    self.opts.dimension_hint, d, weights_mod.degree_weights(finer.graph)
                )
            elif self.opts.weight_type is WeightType.UNIT:
                new_weights = weights_mod.unit_weights(new_n)
            else:
                raise ValueError("weight type not supported for layered embedding")

            stretch = (new_n / old_n) ** (1.0 / d) * self.opts.expansion_stretch
            parents = finer.parent
            base = stretch * old_positions[parents]

            if self.expansion_mode is ExpansionMode.SIBLING_SPHERE:
                siblings = self.hierarchy.num_siblings(self.current_layer - 1)
                sphere = siblings.astype(np.float64) ** (1.0 / d)
            else:
                # reference behavior: totalContainedNodes never populated =>
                # sphere radius 0 (GraphHierarchy.cpp:39-57, SURVEY.md §2.5)
                sphere = np.zeros(new_n)
            rng = rng_mod.host_rng()
            gauss = rng.normal(size=(new_n, d))
            norms = np.linalg.norm(gauss, axis=1, keepdims=True)
            unit = gauss / np.where(norms > 0, norms, 1.0)
            new_positions = base + sphere[:, None] * unit

            self.current_layer -= 1
            if self.verbose:
                print(
                    f"Expanding to layer {self.current_layer} "
                    f"(n={new_n}) at iteration {self.current_iteration}"
                )
            # free the coarser layer's device tensors before the finer
            # layer allocates its own
            self._current = None
            self._current = self._make_embedder(
                finer.graph,
                initial_coordinates=new_positions,
                initial_weights=new_weights,
            )

    # ------------------------------------------------------------ accessors
    def get_coordinates(self) -> np.ndarray:
        return self._current.get_coordinates()

    def get_weights(self) -> np.ndarray:
        return self._current.get_weights()

    def get_current_graph(self) -> CSRGraph:
        return self.hierarchy.layers[self.current_layer].graph

    def get_timings(self) -> list[TimingResult]:
        return self.timer.results()

    def get_loss(self) -> Loss:
        return self._current.get_loss()

    def set_coordinates(self, coordinates) -> None:
        # reference: no-op with a warning (LayeredEmbedder.cpp:26-36)
        warnings.warn("Setting coordinates for layered embedder has no effect")

    def set_weights(self, weights) -> None:
        warnings.warn("Setting weights for layered embedder has no effect")

    @property
    def state(self):
        """The current layer's embedding state."""
        return self._current.state

    @property
    def num_vertices(self) -> int:
        return self.get_current_graph().num_vertices

    @property
    def embedding_dimension(self) -> int:
        return self.opts.embedding_dimension

    @property
    def iteration(self) -> int:
        return self.current_iteration
