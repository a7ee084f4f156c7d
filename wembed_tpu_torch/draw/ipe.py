"""IPE vector-format rendering of 2-D embeddings.

Counterpart of ``wembed_tpu/draw/ipe.py``, numpy only, with the same output
(the creator attribute included): the reference's IPE writer
(reference: src/drawLib/src/IPEDrawer.cpp:5-154): an IPE 7 XML document
with one page, edge paths and vertex marks, coordinates fitted to an A4-ish
canvas.
"""

from __future__ import annotations

import numpy as np

from ..graphs.csr import CSRGraph
from .svg import project_onto_plane


_HEADER = """<?xml version="1.0"?>
<!DOCTYPE ipe SYSTEM "ipe.dtd">
<ipe version="70218" creator="wembed_tpu">
<ipestyle name="basic">
<symbol name="mark/disk(sx)" transformations="translations">
<path fill="sym-stroke"> 0.6 0 0 0.6 0 0 e </path>
</symbol>
</ipestyle>
<page>
<layer name="edges"/>
<layer name="nodes"/>
"""


def write_ipe(
    path: str,
    g: CSRGraph,
    positions: np.ndarray,
    size: float = 560.0,
    draw_edges: bool = True,
) -> None:
    pts = project_onto_plane(positions)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = np.maximum(hi - lo, 1e-9)
    scale = size / extent.max()
    xy = (pts - lo) * scale + 16.0

    parts = [_HEADER]
    if draw_edges:
        for u, v in g.edge_list():
            parts.append(
                f'<path layer="edges" stroke="gray" pen="0.2">\n'
                f"{xy[u, 0]:.2f} {xy[u, 1]:.2f} m\n"
                f"{xy[v, 0]:.2f} {xy[v, 1]:.2f} l\n</path>\n"
            )
    for i in range(pts.shape[0]):
        parts.append(
            f'<use layer="nodes" name="mark/disk(sx)" '
            f'pos="{xy[i, 0]:.2f} {xy[i, 1]:.2f}" size="normal" stroke="black"/>\n'
        )
    parts.append("</page>\n</ipe>\n")
    with open(path, "w") as f:
        f.write("".join(parts))
