from .options import (
    EmbedderOptions,
    OptimizerType,
    PartitionerOptions,
    RepulsionMode,
    WeightType,
)
from .state import DeviceGraph, EmbedState, init_state, random_positions
from .embedder import Loss, WEmbedEmbedder

__all__ = [
    "EmbedderOptions",
    "OptimizerType",
    "PartitionerOptions",
    "RepulsionMode",
    "WeightType",
    "DeviceGraph",
    "EmbedState",
    "init_state",
    "random_positions",
    "Loss",
    "WEmbedEmbedder",
]
