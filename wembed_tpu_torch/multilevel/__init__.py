from .label_prop import (
    CoarseningResult,
    calculate_new_edge_weights,
    coarsen_all_layers,
    compact_cluster_ids,
)
from .hierarchy import ExpansionMode, GraphHierarchy, Layer
from .layered import LayerRecord, LayeredEmbedder

__all__ = [
    "CoarseningResult",
    "calculate_new_edge_weights",
    "coarsen_all_layers",
    "compact_cluster_ids",
    "ExpansionMode",
    "GraphHierarchy",
    "Layer",
    "LayerRecord",
    "LayeredEmbedder",
]
