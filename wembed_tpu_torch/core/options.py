"""Embedder configuration.

Counterpart of ``wembed_tpu/core/options.py``: the reference's internal
EmbedderOptions (reference:
src/embeddingLib/include/embedder/EmbedderOptions.hpp:21-51) with identical
defaults, plus ``dtype``, ``repulsion_mode``, ``dense_threshold`` and the
span path's ``window_capacity``, ``span_layout`` and
``span_resize_interval``, and the halo backend's
``halo_resident_structures``.  The JAX package's TPU kernel switches
(``fused_dense``, ``fused_span``) have no counterpart: the port picks its
kernel from the device of the tensors.

``PartitionerOptions`` are the multilevel coarsening knobs, with the
reference's defaults.

The port runs the dense path (n <= dense_threshold), the span path above
it in either layout (``resolve_span_layout``; with a partial index,
``index_size < 1``, as a per-step member sample of the windowed layout),
and negative sampling (``num_negative_samples >= 0``) at any size.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class WeightType(enum.Enum):
    UNIT = 0
    DEGREE = 1
    ORIGINAL = 2


class OptimizerType(enum.Enum):
    SIMPLE = 0
    ADAM = 1


class RepulsionMode(enum.Enum):
    """How repulsion partners are found.

    AUTO   — dense up to ``dense_threshold`` vertices, bucket above.
    DENSE  — exact all-pairs repulsion (the fused all-pairs force kernel).
    BUCKET — the span path: windows over projected, sorted weight groups,
             swept by the span kernel (``kernels/span_sparse.py``).
    """

    AUTO = 0
    DENSE = 1
    BUCKET = 2


@dataclass(frozen=True)
class EmbedderOptions:
    # ---- embedding parameters (EmbedderOptions.hpp:22-24)
    embedding_dimension: int = 4
    dimension_hint: float = -1.0
    lp_norm: int = 2  # only 2 is supported, as in the reference

    # ---- force parameters (EmbedderOptions.hpp:27-38)
    weight_type: WeightType = WeightType.DEGREE
    num_negative_samples: int = -1  # -1 => use the exact candidate set
    index_size: float = 1.0  # fraction of nodes inserted into the index
    doubling_factor: float = 2.0
    position_min_change: float = 1e-4
    attraction_scale: float = 1.0
    repulsion_scale: float = 1.0
    centre_scale: float = 0.0
    edge_length: float = 1.0
    expansion_stretch: float = 1.0

    # ---- weights (EmbedderOptions.hpp:41-45)
    additive_weights: bool = False
    dump_weights: bool = False

    # ---- gradient descent (EmbedderOptions.hpp:48-51)
    optimizer_type: OptimizerType = OptimizerType.ADAM
    cooling_factor: float = 0.99
    learning_rate: float = 10.0
    max_iterations: int = 1000

    # ---- execution (no reference counterpart)
    dtype: str = "float32"  # positions/forces dtype, "float32" or "float64" (both on the card)
    repulsion_mode: RepulsionMode = RepulsionMode.AUTO
    dense_threshold: int = 16384  # AUTO switches to BUCKET above this
    window_capacity: int = 48  # base candidate window of the initial span sizing
    # "auto" and "windows": per-(query block, target row) tile windows on the
    # second principal axis (``kernels/span_sparse.py``); "cells": rows and
    # cells on the first two axes, windows on the third and each block's
    # members compacted (``kernels/span_compact.py``), where the JAX
    # package takes it (``resolve_span_layout``)
    span_layout: str = "auto"
    # the embedding loop pauses every this many iterations so that
    # over-provisioned span windows can shrink; 0 disables the pauses
    span_resize_interval: int = 50
    # halo backend only (``distributed/halo.py``): each rank sweeps its
    # range of the query blocks, ceil(nb / P) of them, instead of a slice of
    # the work items.  The equal-block partition balances queries, not
    # tiles.  The member records stay whole on every rank: the JAX
    # package's compact per-rank member buffer and its tile budget are TPU
    # layouts the port leaves out (ROADMAP)
    halo_resident_structures: bool = False
    debug_checks: bool = False

    def resolve_repulsion_mode(self, n: int) -> RepulsionMode:
        """The repulsion mode for an ``n``-vertex graph, DENSE or BUCKET."""
        mode = self.repulsion_mode
        if mode is RepulsionMode.AUTO:
            mode = RepulsionMode.DENSE if n <= self.dense_threshold else RepulsionMode.BUCKET
        return mode

    def resolve_path(self, n: int) -> str:
        """The step an ``n``-vertex graph takes: ``"sampled"`` with negative
        sampling on, whatever the mode (``wembed_tpu/core/embedder.py:142``,
        ``step.py:266,395``), else ``"dense"`` or ``"span"`` by the mode."""
        if self.num_negative_samples >= 0:
            return "sampled"
        mode = self.resolve_repulsion_mode(n)
        if mode is RepulsionMode.BUCKET:
            self.resolve_span_layout()
            return "span"
        return "dense"

    def resolve_span_layout(self) -> str:
        """The span path's layout on one device, ``"cells"`` or
        ``"windows"``, chosen where the JAX package chooses its index
        (``wembed_tpu/core/embedder.py:141-158``, ``core/step.py:71-93``):
        the cell index only with ``span_layout="cells"`` on the fused span
        kernel's path, which is f32 with a whole index (``index_size >=
        1``) and no negative sampling.  Elsewhere the JAX package takes its
        jnp ``BucketIndex``, whose counterpart here is the windowed layout:
        f64, a partial index, and ``"auto"`` or ``"windows"``.  The
        multi-device embedders keep windows whatever this says
        (``distributed/step.py``)."""
        if self.span_layout not in ("auto", "windows", "cells"):
            raise ValueError(f"unknown span_layout {self.span_layout!r}")
        cells = (
            self.span_layout == "cells"
            and self.dtype == "float32"
            and self.index_size >= 1.0
            and self.num_negative_samples < 0
        )
        return "cells" if cells else "windows"


@dataclass(frozen=True)
class PartitionerOptions:
    """Multilevel coarsening knobs (reference
    src/embeddingLib/include/partition/Partitioner.hpp:9-16)."""

    max_iterations: int = 20
    max_cluster_size: int = 6
    final_graph_size: int = 10
    order_type: int = 0  # 0 = ascending degree, 1 = random
    num_hierarchies: int = 1
