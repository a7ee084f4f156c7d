"""Embedder configuration.

Counterpart of ``wembed_tpu/core/options.py``: the reference's internal
EmbedderOptions (reference:
src/embeddingLib/include/embedder/EmbedderOptions.hpp:21-51) with identical
defaults, plus ``dtype``, ``repulsion_mode`` and ``dense_threshold``.  The
JAX package's TPU kernel switches (``fused_dense``, ``fused_span``,
``span_layout``, ...) have no counterpart: the port picks its kernel from
the device of the tensors.

The port runs the dense path only.  Everything that would leave it
(negative sampling, the bucket/span path) raises ``NotImplementedError``
naming the ROADMAP item that ports it.
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
    BUCKET — the span/bucket candidate path; not ported yet.
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
    debug_checks: bool = False

    def resolve_repulsion_mode(self, n: int) -> RepulsionMode:
        """The repulsion mode for an ``n``-vertex graph: DENSE, or raise."""
        if self.num_negative_samples >= 0:
            raise NotImplementedError(
                "negative sampling (num_negative_samples >= 0) is not ported "
                "yet: ROADMAP.md, Queue 1, item 13"
            )
        mode = self.repulsion_mode
        if mode is RepulsionMode.AUTO:
            mode = RepulsionMode.DENSE if n <= self.dense_threshold else RepulsionMode.BUCKET
        if mode is RepulsionMode.BUCKET:
            raise NotImplementedError(
                f"the span/bucket repulsion path (n={n} > dense_threshold="
                f"{self.dense_threshold}, or RepulsionMode.BUCKET) is not ported "
                "yet: ROADMAP.md, Queue 1, items 5-7"
            )
        return mode
