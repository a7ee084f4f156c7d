from .svg import project_onto_plane, weight_colors, write_svg
from .ipe import write_ipe
from .animate import (
    FrameRecorder,
    LiveView,
    animate_embedding,
    write_animated_svg,
)

__all__ = [
    "project_onto_plane",
    "weight_colors",
    "write_svg",
    "write_ipe",
    "FrameRecorder",
    "LiveView",
    "animate_embedding",
    "write_animated_svg",
]
