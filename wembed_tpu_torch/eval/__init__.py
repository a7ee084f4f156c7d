from .spaces import EmbeddingType, Space, parse_embedding
from .reconstruction import reconstruction_metrics, sample_node_entries
from .edge_detection import edge_detection_metrics, sample_histogram

__all__ = [
    "EmbeddingType",
    "Space",
    "parse_embedding",
    "reconstruction_metrics",
    "sample_node_entries",
    "edge_detection_metrics",
    "sample_histogram",
]
