"""Materialized graph hierarchy for the multilevel embedder.

Counterpart of ``wembed_tpu/multilevel/hierarchy.py``, a re-design of the
reference's GraphHierarchy
(reference: src/embeddingLib/src/partition/GraphHierarchy.cpp:5-66) as flat
arrays: per layer a CSRGraph plus parent-pointer and contained-node-count
arrays.

NOTE on reference parity: the reference declares
NodeInformation::totalContainedNodes but never populates it
(GraphHierarchy.cpp:39-57), so LayeredEmbedder's expansion sphere radius
``numSiblings^(1/d)`` is effectively 0 (SURVEY.md §2.5) — children spawn
exactly on their parent and separate via the coincident-point random kicks.
We compute the true counts, and ``ExpansionMode`` selects whether expansion
reproduces the reference behavior (sphere radius 0) or uses them.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from ..graphs.algorithms import coarsen_graph
from ..graphs.csr import CSRGraph
from .label_prop import CoarseningResult


class ExpansionMode(enum.Enum):
    REFERENCE = 0  # sphere radius 0, as the reference effectively behaves
    SIBLING_SPHERE = 1  # radius = numSiblings^(1/d), as evidently intended


@dataclass(frozen=True)
class Layer:
    graph: CSRGraph
    parent: np.ndarray  # (n_layer,) cluster id in the next-coarser layer
    contained: np.ndarray  # (n_layer,) number of FINEST-layer vertices inside


@dataclass(frozen=True)
class GraphHierarchy:
    """layers[0] is the finest (original) graph, layers[-1] the coarsest."""

    layers: tuple[Layer, ...]

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @staticmethod
    def build(result: CoarseningResult) -> "GraphHierarchy":
        graphs = result.graphs
        # parent_pointers has two synthetic tail entries (all-into-one and
        # {-1}); real per-layer mappings are the first len(graphs)-1
        mappings = result.parent_pointers[: len(graphs) - 1]
        layers = []
        contained = np.ones(graphs[0].num_vertices, dtype=np.int64)
        for li, g in enumerate(graphs):
            if li < len(mappings):
                parent = np.asarray(mappings[li], dtype=np.int64)
            else:
                parent = np.zeros(g.num_vertices, dtype=np.int64)
            layers.append(Layer(graph=g, parent=parent, contained=contained))
            if li < len(mappings):
                nxt = graphs[li + 1].num_vertices
                agg = np.zeros(nxt, dtype=np.int64)
                np.add.at(agg, parent, contained)
                contained = agg
        return GraphHierarchy(layers=tuple(layers))

    @staticmethod
    def from_parents(graph: CSRGraph, parents: list[np.ndarray]) -> "GraphHierarchy":
        """The hierarchy of ``graph`` whose layer i maps into layer i + 1 by
        ``parents[i]``: each coarser graph contracted from the finer one by
        ``coarsen_graph``, as the coarsening itself contracts them (a
        checkpoint's restore, ``core/checkpoint.py``)."""
        graphs = [graph]
        for i, parent in enumerate(parents):
            if parent.shape[0] != graphs[-1].num_vertices:
                raise ValueError(
                    f"parent pointers of layer {i} cover {parent.shape[0]} vertices, the "
                    f"layer has {graphs[-1].num_vertices}: another finest graph?"
                )
            graphs.append(coarsen_graph(graphs[-1], parent)[0])
        return GraphHierarchy.build(
            CoarseningResult(parent_pointers=[np.asarray(p) for p in parents], graphs=graphs)
        )

    def num_siblings(self, layer_index: int) -> np.ndarray:
        """For each vertex of ``layer_index``, how many finest-layer
        vertices its PARENT contains (the intended expansion sphere
        volume)."""
        layer = self.layers[layer_index]
        parent_layer = self.layers[layer_index + 1]
        return parent_layer.contained[layer.parent]
