"""Stable public API, mirroring the reference's C++/pybind11 surface.

Counterpart of ``wembed_tpu/api.py`` (reference include/wembed.h:50-168,
python/bindings.cpp:11-100), flat and layered, single-device or on the
replicated multi-device backend, with an explicit ``device`` on
``createEmbedder``:

    import wembed_tpu_torch.api as wembed
    g = wembed.graphFromEdgeListFile("graph.edg")
    opts = wembed.Options(); opts.embeddingDimension = 2
    emb = wembed.createEmbedder(g, opts)          # device="cuda"
    emb.calculateEmbedding()
    coords = emb.getCoordinates()

``distributedMode="replicated"`` (the replicated backend) and
``distributedMode="halo"`` (the vertex-sharded one) run one rank a process
(``distributed/``): start them with ``python -m torch.distributed.run``,
or run one process alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from .core.embedder import Loss, WEmbedEmbedder
from .core.options import EmbedderOptions, WeightType
from .graphs import csr, io
from .multilevel import ExpansionMode, LayeredEmbedder
from .utils import rng as rng_mod
from .utils.timer import TimingResult, timings_to_string

# SpatialIndex enum values (include/wembed.h:24-27), kept for signature
# compatibility; the dense path uses no spatial index and the span path
# (n > dense_threshold) its own candidate windows.
IndexSNN = 1
IndexSprk = 2


@dataclass
class Edge:
    """(include/wembed.h:30-33)"""

    src: int
    dst: int

    def __repr__(self) -> str:
        return f"Edge({self.src}, {self.dst})"


@dataclass
class Options:
    """Public, curated subset of the embedder options with the reference's
    defaults (include/wembed.h:50-70), and the JAX package's extensions."""

    embeddingDimension: int = 4
    useUnitWeights: bool = False
    dimensionHint: float = -1.0
    layeredEmbedding: bool = False
    expansionMode: str = "sphere"

    indexType: int = IndexSprk
    attractionScale: float = 1.0
    repulsionScale: float = 1.0
    centreScale: float = 0.0
    edgeLength: float = 1.0
    expansionStretch: float = 1.0

    coolingFactor: float = 0.99
    learningRate: float = 10.0
    maxIterations: int = 1000
    positionMinChange: float = 1e-4

    distributedMode: str = "none"
    numDevices: int = -1
    multiHost: bool = False
    distributedMinLayerSize: int = 4096


def _translate_options(options: Options) -> EmbedderOptions:
    """Option translation (reference src/wembed.cpp:162-177)."""
    return EmbedderOptions(
        embedding_dimension=options.embeddingDimension,
        weight_type=WeightType.UNIT if options.useUnitWeights else WeightType.DEGREE,
        dimension_hint=options.dimensionHint,
        attraction_scale=options.attractionScale,
        repulsion_scale=options.repulsionScale,
        centre_scale=options.centreScale,
        edge_length=options.edgeLength,
        expansion_stretch=options.expansionStretch,
        cooling_factor=options.coolingFactor,
        learning_rate=options.learningRate,
        max_iterations=options.maxIterations,
        position_min_change=options.positionMinChange,
    )


class Graph:
    """Pimpl-style wrapper over the CSR arrays (include/wembed.h:72-103)."""

    def __init__(self, graph: csr.CSRGraph):
        self._graph = graph

    def getNumVertices(self) -> int:
        return self._graph.num_vertices

    def getNumEdges(self) -> int:
        return self._graph.num_edges

    def getEdges(self, v: int) -> List[int]:
        return list(
            range(int(self._graph.row_ptr[v]), int(self._graph.row_ptr[v + 1]))
        )

    def getNeighbors(self, v: int) -> List[int]:
        return self._graph.neighbors(v).tolist()

    def getNumNeighbors(self, v: int) -> int:
        return self._graph.num_neighbors(v)

    def getEdgeTarget(self, e: int) -> int:
        return int(self._graph.col_idx[e])

    def areNeighbors(self, v: int, u: int) -> bool:
        return self._graph.are_neighbors(v, u)

    def getEdgeList(self) -> List[Edge]:
        """Each undirected edge exactly once with src < dst
        (include/wembed.h:95-97)."""
        return [Edge(int(a), int(b)) for a, b in self._graph.edge_list()]

    def toString(self) -> str:
        return repr(self._graph)

    __repr__ = toString

    @property
    def csr(self) -> csr.CSRGraph:
        """The underlying array representation."""
        return self._graph


class Embedder:
    """(include/wembed.h:105-145)"""

    def __init__(self, impl: WEmbedEmbedder | LayeredEmbedder):
        self._embedder = impl

    def calculateStep(self) -> None:
        self._embedder.calculate_step()

    def isFinished(self) -> bool:
        return self._embedder.is_finished()

    def calculateEmbedding(self) -> None:
        self._embedder.calculate_embedding()

    # size accessors — reflect the CURRENT graph (changes across layers for
    # the layered embedder, include/wembed.h:118-121)
    def getNumVertices(self) -> int:
        return self._embedder.num_vertices

    def getEmbeddingDimension(self) -> int:
        return self._embedder.embedding_dimension

    def copyCoordinatesTo(self, out: np.ndarray) -> None:
        """Flat row-major copy (include/wembed.h:123-125)."""
        np.copyto(
            out.reshape(self.getNumVertices(), self.getEmbeddingDimension()),
            self._embedder.get_coordinates(),
        )

    def getCurrentGraph(self) -> Graph:
        if isinstance(self._embedder, LayeredEmbedder):
            return Graph(self._embedder.get_current_graph())
        return Graph(self._embedder.graph)

    def getCoordinates(self) -> List[List[float]]:
        """The n coordinates.  Under ``distributedMode="halo"`` each rank
        holds its own rows, so this (and ``getCoordinatesInto``,
        ``writeCoordinates``) is a collective: every rank calls it."""
        return self._embedder.get_coordinates().tolist()

    def getWeights(self) -> List[float]:
        return self._embedder.get_weights().tolist()

    def setCoordinates(self, coordinates: Sequence[Sequence[float]]) -> None:
        self._embedder.set_coordinates(np.asarray(coordinates, dtype=np.float64))

    def setWeights(self, weights: Sequence[float]) -> None:
        self._embedder.set_weights(np.asarray(weights, dtype=np.float64))

    def getTimings(self) -> List[TimingResult]:
        return self._embedder.get_timings()

    def getLoss(self) -> Loss:
        return self._embedder.get_loss()

    def writeCoordinates(self, filePath: str, writeWeights: bool = True) -> None:
        """Write the coordinates (a collective under halo, as
        ``getCoordinates``; every rank that calls it writes the file)."""
        io.write_coordinates(
            filePath,
            self._embedder.get_coordinates(),
            self._embedder.get_weights() if writeWeights else None,
        )

    @property
    def impl(self) -> WEmbedEmbedder | LayeredEmbedder:
        """The underlying embedder."""
        return self._embedder


def createEmbedder(
    graph: Graph, options: Options, device: torch.device | str = "cuda"
) -> Embedder:
    """(reference src/wembed.cpp:162-188) — a flat or layered embedder on
    ``device``.  With ``distributedMode="replicated"`` (``"halo"``) the
    flat embedder (or every layer of at least ``max(distributedMinLayerSize,
    2 x ranks)`` vertices) is a ``MultiChipEmbedder`` (``HaloEmbedder``) on
    this rank's share of ``device`` (``cuda``: ``cuda:LOCAL_RANK``);
    ``numDevices`` must be the number of ranks.  A rank is a process, so each joins the process group
    from the environment (``WEMBED_COORDINATOR`` / ``WEMBED_NUM_PROCESSES``
    / ``WEMBED_PROCESS_ID``, or ``torch.distributed.run``'s variables)
    whether or not ``multiHost`` is set, and makes a group of its own when
    there are none."""
    opts = _translate_options(options)
    if options.distributedMode not in ("none", "replicated", "halo"):
        raise ValueError(
            f"unknown distributedMode {options.distributedMode!r} "
            "(expected 'none', 'replicated', or 'halo')"
        )
    if options.distributedMode != "none":
        from .distributed import HaloEmbedder, MultiChipEmbedder, make_mesh

        dist_cls = HaloEmbedder if options.distributedMode == "halo" else MultiChipEmbedder
        mesh = make_mesh(None if options.numDevices < 0 else options.numDevices, device=device)
        if options.layeredEmbedding:
            return Embedder(
                LayeredEmbedder(
                    graph.csr, opts, verbose=False, expansion_mode=_expansion_mode(options),
                    embedder_factory=_distributed_layer_factory(
                        dist_cls, mesh, options.distributedMinLayerSize
                    ),
                    device=mesh.device, mesh=mesh,
                )
            )
        return Embedder(dist_cls(graph.csr, opts, mesh=mesh, verbose=False))
    if options.layeredEmbedding:
        return Embedder(
            LayeredEmbedder(
                graph.csr, opts, verbose=False,
                expansion_mode=_expansion_mode(options), device=device,
            )
        )
    return Embedder(WEmbedEmbedder(graph.csr, opts, verbose=False, device=device))


def _distributed_layer_factory(dist_cls, mesh, min_layer_size: int):
    """Per-layer embedder factory of a layered multi-device run
    (``wembed_tpu/api.py:_distributed_layer_factory``): layers below
    ``max(min_layer_size, 2 x ranks)`` vertices run on a single-device
    ``WEmbedEmbedder`` on every rank, since at coarse sizes the step's
    collective costs more than its work; the others on ``dist_cls``
    (``MultiChipEmbedder`` or ``HaloEmbedder``), where ``profile`` runs the
    normal step.  The ranks took rank 0's host stream when the
    ``LayeredEmbedder`` was built."""

    def factory(layer_graph, opts, **kw):
        if layer_graph.num_vertices < max(min_layer_size, 2 * mesh.size):
            return WEmbedEmbedder(layer_graph, opts, **kw)
        return dist_cls(layer_graph, opts, mesh=mesh, share_stream=False, **kw)

    return factory


def _expansion_mode(options: Options) -> ExpansionMode:
    return (
        ExpansionMode.REFERENCE
        if options.expansionMode == "reference"
        else ExpansionMode.SIBLING_SPHERE
    )


def graphFromEdges(edges: Sequence[Edge] | np.ndarray) -> Graph:
    """Each undirected edge should appear exactly once; vertex ids must be
    consecutive starting at 0 (include/wembed.h:149-151)."""
    if len(edges) and isinstance(edges[0], Edge):
        arr = np.asarray([[e.src, e.dst] for e in edges], dtype=np.int64)
    else:
        arr = np.asarray(edges, dtype=np.int64)
    return Graph(csr.from_edges(arr))


def graphFromEdgeListFile(
    filePath: str, comment: str = "#", delimiter: str = " "
) -> Graph:
    delim = None if delimiter in (" ", "\t") else delimiter
    return Graph(io.read_edge_list(filePath, comment, delim))


def graph_from_networkx(nx_graph) -> Graph:
    """Convert a networkx graph whose nodes are hashable labels into a
    ``Graph`` (relabelled to consecutive ids), the helper of the
    reference's Python example (python/examples/cli_example.py:46-63).
    Duck-typed: any object with ``nodes()`` and ``edges()`` will do, and
    networkx is not imported.

    Returns the Graph; the id mapping is available as ``.node_labels``
    (index -> original label)."""
    labels = list(nx_graph.nodes())
    index_of = {label: i for i, label in enumerate(labels)}
    arr = np.asarray(
        [[index_of[u], index_of[v]] for u, v in nx_graph.edges()], dtype=np.int64
    ).reshape(-1, 2)
    g = Graph(csr.from_edges(arr, num_vertices=len(labels)))
    g.node_labels = labels
    return g


def readCoordinatesFromFile(
    filePath: str, comment: str = "%", delimiter: str = ","
) -> List[List[float]]:
    return io.read_coordinates(filePath, comment, delimiter).tolist()


def timingsToString(timings: List[TimingResult]) -> str:
    return timings_to_string(timings)


def setSeed(seed: int) -> None:
    rng_mod.set_seed(seed)
