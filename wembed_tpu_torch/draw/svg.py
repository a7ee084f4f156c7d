"""SVG rendering of 2-D embeddings.

Counterpart of ``wembed_tpu/draw/svg.py``, numpy only, with the same
output: the reference's drawLib SVG writer
(reference: src/drawLib/src/SVGDrawer.cpp:90-156, DrawCommon.cpp:5-72):
project onto the first two dimensions, auto-fit bounds, node radius
0.1*sqrt(area/n), edge width 0.3*radius; colors from an explicit list, an
HSV scale over vertex weights, or gray.
"""

from __future__ import annotations

import colorsys

import numpy as np

from ..graphs.csr import CSRGraph


def project_onto_plane(positions: np.ndarray) -> np.ndarray:
    """First two coordinates (reference DrawCommon.cpp projectOntoPlane)."""
    positions = np.asarray(positions, dtype=np.float64)
    if positions.shape[1] < 2:
        return np.concatenate(
            [positions, np.zeros((positions.shape[0], 2 - positions.shape[1]))],
            axis=1,
        )
    return positions[:, :2]


def hsv_to_rgb_hex(h: float, s: float = 0.9, v: float = 0.85) -> str:
    r, g, b = colorsys.hsv_to_rgb(h, s, v)
    return f"#{int(r * 255):02x}{int(g * 255):02x}{int(b * 255):02x}"


def weight_colors(weights: np.ndarray) -> list[str]:
    """HSV scale over log-weights (heavier = warmer)."""
    w = np.log(np.maximum(np.asarray(weights, dtype=np.float64), 1e-12))
    lo, hi = float(w.min()), float(w.max())
    t = (w - lo) / (hi - lo) if hi > lo else np.zeros_like(w)
    return [hsv_to_rgb_hex(0.66 * (1.0 - float(x))) for x in t]


def write_svg(
    path: str,
    g: CSRGraph,
    positions: np.ndarray,
    weights: np.ndarray | None = None,
    colors: list[str] | None = None,
    size: float = 1000.0,
    draw_edges: bool = True,
) -> None:
    pts = project_onto_plane(positions)
    n = pts.shape[0]
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = np.maximum(hi - lo, 1e-9)
    margin = 0.05 * extent.max()
    lo, hi = lo - margin, hi + margin
    scale = size / (hi - lo).max()
    xy = (pts - lo) * scale
    xy[:, 1] = size - xy[:, 1]  # flip y for screen coordinates

    area = float(size * size)
    radius = 0.1 * np.sqrt(area / max(n, 1))
    edge_width = 0.3 * radius

    if colors is None:
        colors = weight_colors(weights) if weights is not None else ["#808080"] * n

    lines = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size:.0f}" '
        f'height="{size:.0f}" viewBox="0 0 {size:.0f} {size:.0f}">',
        f'<rect width="{size:.0f}" height="{size:.0f}" fill="white"/>',
    ]
    if draw_edges:
        lines.append(f'<g stroke="#555555" stroke-width="{edge_width:.3f}" opacity="0.5">')
        for u, v in g.edge_list():
            lines.append(
                f'<line x1="{xy[u, 0]:.2f}" y1="{xy[u, 1]:.2f}" '
                f'x2="{xy[v, 0]:.2f}" y2="{xy[v, 1]:.2f}"/>'
            )
        lines.append("</g>")
    lines.append("<g>")
    for i in range(n):
        lines.append(
            f'<circle cx="{xy[i, 0]:.2f}" cy="{xy[i, 1]:.2f}" '
            f'r="{radius:.3f}" fill="{colors[i]}"/>'
        )
    lines.append("</g></svg>")
    with open(path, "w") as f:
        f.write("\n".join(lines))
