"""Embedder configuration.

Counterpart of ``wembed_tpu/core/options.py``: the reference's internal
EmbedderOptions (reference:
src/embeddingLib/include/embedder/EmbedderOptions.hpp:21-51) with identical
defaults, plus ``dtype``, ``repulsion_mode``, ``dense_threshold`` and the
span path's ``window_capacity``, ``span_layout`` and
``span_resize_interval``.  The JAX package's TPU kernel switches
(``fused_dense``, ``fused_span``) have no counterpart: the port picks its
kernel from the device of the tensors.

``PartitionerOptions`` are the multilevel coarsening knobs, with the
reference's defaults.

The port runs the dense path (n <= dense_threshold), the windowed span
path above it, and negative sampling (``num_negative_samples >= 0``) at
any size.  A partial index (``index_size < 1``) and the cell layout raise
``NotImplementedError`` naming the ROADMAP item that ports them.
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
    dtype: str = "float32"  # positions/forces dtype; "float64" for CPU parity runs
    repulsion_mode: RepulsionMode = RepulsionMode.AUTO
    dense_threshold: int = 16384  # AUTO switches to BUCKET above this
    window_capacity: int = 48  # base candidate window of the initial span sizing
    # "auto" and "windows": per-(query block, target row) tile windows on the
    # second principal axis; "cells" (three-level binning) is not ported
    span_layout: str = "auto"
    # the embedding loop pauses every this many iterations so that
    # over-provisioned span windows can shrink; 0 disables the pauses
    span_resize_interval: int = 50
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
        ``step.py:266,395``), else ``"dense"`` or ``"span"`` by the mode;
        raise for what the port does not run yet."""
        if self.num_negative_samples >= 0:
            return "sampled"
        mode = self.resolve_repulsion_mode(n)
        if mode is RepulsionMode.BUCKET:
            if self.index_size < 1.0:
                raise NotImplementedError(
                    f"a partial span index (index_size={self.index_size} < 1) is not "
                    "ported yet: ROADMAP.md, Queue 1, item 14"
                )
            if self.span_layout == "cells":
                raise NotImplementedError(
                    'the cell span layout (span_layout="cells") is not ported yet: '
                    "ROADMAP.md, Queue 1, item 15"
                )
            if self.span_layout not in ("auto", "windows"):
                raise ValueError(f"unknown span_layout {self.span_layout!r}")
            return "span"
        return "dense"


@dataclass(frozen=True)
class PartitionerOptions:
    """Multilevel coarsening knobs (reference
    src/embeddingLib/include/partition/Partitioner.hpp:9-16)."""

    max_iterations: int = 20
    max_cluster_size: int = 6
    final_graph_size: int = 10
    order_type: int = 0  # 0 = ascending degree, 1 = random
