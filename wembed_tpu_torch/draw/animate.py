"""Embedding animation — the live-viewer equivalent of the reference's
SFML drawer (reference: src/drawLib/src/SFMLDrawer.cpp:8-143, which redraws
a 1600x900 window every frame while the embedder iterates).

Counterpart of ``wembed_tpu/draw/animate.py``, numpy only, with the same
output.  A window server is not a given next to an accelerator, so frames
are recorded from the embedding loop and rendered two ways:

* ``write_animated_svg`` — a self-contained SVG with SMIL animation
  (no dependencies; plays in any browser).  Node circles interpolate
  between recorded positions; edges follow their endpoints.
* ``LiveView`` — an optional matplotlib window that redraws per frame for
  interactive use on a workstation (import-gated; absence is fine).

``animate_embedding`` drives either from an embedder with the reference's
step API (calculateStep/isFinished naming per include/wembed.h:105-145):
``api.Embedder`` over any of the port's embedders, flat or layered.
"""

from __future__ import annotations

import numpy as np

from ..graphs.csr import CSRGraph
from .svg import project_onto_plane, weight_colors


class FrameRecorder:
    """Collects (n, 2) projected position snapshots of a running embed."""

    def __init__(self) -> None:
        self.frames: list[np.ndarray] = []

    def record(self, positions: np.ndarray) -> None:
        self.frames.append(project_onto_plane(np.asarray(positions)))

    def __len__(self) -> int:
        return len(self.frames)


def write_animated_svg(
    path: str,
    g: CSRGraph,
    frames: list[np.ndarray],
    weights: np.ndarray | None = None,
    size: float = 900.0,
    seconds_per_frame: float = 0.08,
    draw_edges: bool = True,
    max_edges: int = 20000,
) -> None:
    """Self-contained SMIL-animated SVG of the embedding trajectory.

    Bounds are fitted over ALL frames so the camera is static (the SFML
    drawer refits per frame; a fixed camera reads better for trajectories).
    """
    if not frames:
        raise ValueError("no frames recorded")
    n = frames[0].shape[0]
    stack = np.stack(frames)  # (F, n, 2)
    lo = stack.reshape(-1, 2).min(axis=0)
    hi = stack.reshape(-1, 2).max(axis=0)
    extent = np.maximum(hi - lo, 1e-9)
    margin = 0.05 * float(extent.max())
    lo, hi = lo - margin, hi + margin
    scale = size / float((hi - lo).max())
    xy = (stack - lo) * scale
    xy[:, :, 1] = size - xy[:, :, 1]

    radius = 0.1 * np.sqrt(size * size / max(n, 1))
    edge_width = 0.3 * radius
    colors = (
        weight_colors(weights) if weights is not None else ["#808080"] * n
    )
    total = max(seconds_per_frame * len(frames), 1e-3)

    def track(values: np.ndarray) -> str:
        return ";".join(f"{v:.2f}" for v in values)

    lines = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size:.0f}" '
        f'height="{size:.0f}" viewBox="0 0 {size:.0f} {size:.0f}">',
        f'<rect width="{size:.0f}" height="{size:.0f}" fill="white"/>',
    ]
    if draw_edges:
        lines.append(
            f'<g stroke="#555555" stroke-width="{edge_width:.3f}" opacity="0.4">'
        )
        for u, v in g.edge_list()[:max_edges]:
            lines.append(
                f'<line x1="{xy[-1, u, 0]:.2f}" y1="{xy[-1, u, 1]:.2f}" '
                f'x2="{xy[-1, v, 0]:.2f}" y2="{xy[-1, v, 1]:.2f}">'
                f'<animate attributeName="x1" dur="{total:.2f}s" '
                f'repeatCount="indefinite" values="{track(xy[:, u, 0])}"/>'
                f'<animate attributeName="y1" dur="{total:.2f}s" '
                f'repeatCount="indefinite" values="{track(xy[:, u, 1])}"/>'
                f'<animate attributeName="x2" dur="{total:.2f}s" '
                f'repeatCount="indefinite" values="{track(xy[:, v, 0])}"/>'
                f'<animate attributeName="y2" dur="{total:.2f}s" '
                f'repeatCount="indefinite" values="{track(xy[:, v, 1])}"/>'
                f"</line>"
            )
        lines.append("</g>")
    lines.append("<g>")
    for i in range(n):
        lines.append(
            f'<circle cx="{xy[-1, i, 0]:.2f}" cy="{xy[-1, i, 1]:.2f}" '
            f'r="{radius:.3f}" fill="{colors[i]}">'
            f'<animate attributeName="cx" dur="{total:.2f}s" '
            f'repeatCount="indefinite" values="{track(xy[:, i, 0])}"/>'
            f'<animate attributeName="cy" dur="{total:.2f}s" '
            f'repeatCount="indefinite" values="{track(xy[:, i, 1])}"/>'
            f"</circle>"
        )
    lines.append("</g></svg>")
    with open(path, "w") as f:
        f.write("\n".join(lines))


class LiveView:
    """Interactive per-frame redraw (the direct SFML analogue); requires
    matplotlib with a GUI backend and is import-gated so headless hosts
    never pay for it."""

    def __init__(self, g: CSRGraph, weights: np.ndarray | None = None):
        import matplotlib.pyplot as plt  # noqa: deferred heavy import

        self._plt = plt
        self._g = g
        self._colors = (
            weight_colors(weights) if weights is not None else None
        )
        plt.ion()
        self._fig, self._ax = plt.subplots(figsize=(8, 8))

    def draw(self, positions: np.ndarray) -> None:
        pts = project_onto_plane(np.asarray(positions))
        ax = self._ax
        ax.clear()
        edges = self._g.edge_list()
        segs = np.stack([pts[edges[:, 0]], pts[edges[:, 1]]], axis=1)
        from matplotlib.collections import LineCollection

        ax.add_collection(
            LineCollection(segs, colors="#555555", linewidths=0.5, alpha=0.4)
        )
        ax.scatter(pts[:, 0], pts[:, 1], s=6, c=self._colors or "#808080")
        ax.set_aspect("equal")
        self._fig.canvas.draw_idle()
        self._plt.pause(0.001)

    def close(self) -> None:
        self._plt.close(self._fig)


def animate_embedding(
    embedder,
    every: int = 10,
    recorder: FrameRecorder | None = None,
    live: "LiveView | None" = None,
    max_frames: int = 400,
) -> FrameRecorder:
    """Run ``embedder`` to convergence, recording a frame every ``every``
    steps (plus the final state).  Works with any object exposing the
    reference step API (calculateStep/isFinished/getCoordinates)."""
    rec = recorder if recorder is not None else FrameRecorder()
    step = 0
    rec.record(np.asarray(embedder.getCoordinates()))
    while not embedder.isFinished():
        embedder.calculateStep()
        step += 1
        if step % every == 0 and len(rec) < max_frames:
            pos = np.asarray(embedder.getCoordinates())
            rec.record(pos)
            if live is not None:
                live.draw(pos)
    rec.record(np.asarray(embedder.getCoordinates()))
    if live is not None:
        live.draw(rec.frames[-1])
    return rec
