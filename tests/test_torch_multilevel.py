"""The port's multilevel stack against the JAX package's: the native label
propagation, the coarsening and the hierarchy array for array, and the
layered embedder layer by layer in f64 from the same host random stream."""

import os

import numpy as np
import pytest
import torch

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import PartitionerOptions as JaxPartitionerOptions
from wembed_tpu.core import WEmbedEmbedder as JaxEmbedder
from wembed_tpu.graphs import algorithms as jax_algorithms
from wembed_tpu.graphs import generators
from wembed_tpu.multilevel import GraphHierarchy as JaxHierarchy
from wembed_tpu.multilevel import LayeredEmbedder as JaxLayered
from wembed_tpu.multilevel import coarsen_all_layers as jax_coarsen_all_layers
from wembed_tpu.multilevel import label_prop as jax_lp
from wembed_tpu.utils import set_seed as jax_set_seed

from wembed_tpu_torch import api
from wembed_tpu_torch.cli import embed as embed_cli
from wembed_tpu_torch.core import EmbedderOptions, PartitionerOptions, WEmbedEmbedder
from wembed_tpu_torch.graphs import algorithms, io
from wembed_tpu_torch.graphs.csr import CSRGraph
from wembed_tpu_torch.kernels.fused_dense import fused_dense_forces_reference
from wembed_tpu_torch.multilevel import (
    ExpansionMode,
    GraphHierarchy,
    LayeredEmbedder,
    coarsen_all_layers,
    compact_cluster_ids,
)
from wembed_tpu_torch.multilevel import label_prop as lp
from wembed_tpu_torch.utils import set_seed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_GRAPH = os.path.join(REPO, "assets", "small_graph.edg")
PARITY_ITERATIONS = 6  # f64 trajectories of the two packages part by ~2x a step (Adam's sign)


def _graphs(n=300, seed=3):
    """(JAX graph, the same graph as the port's CSRGraph)."""
    g_j, _ = generators.geometric_graph(n, rng=np.random.default_rng(seed))
    return g_j, CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)


def _assert_same_graph(a, b):
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col_idx, b.col_idx)


@pytest.mark.parametrize("seed", [0, 1])
def test_label_propagation_matches_jax_and_python(seed):
    g_j, g_t = _graphs(200, seed=seed + 10)
    rng = np.random.default_rng(seed)
    ew = rng.uniform(0.5, 2.0, size=g_t.num_directed_edges)
    order = lp.label_propagation_order(g_t, 0, rng)
    np.testing.assert_array_equal(order, jax_lp.label_propagation_order(g_j, 0, rng))
    opts = PartitionerOptions()
    native = lp._run_label_propagation(g_t, ew, order, opts)
    python = jax_lp._label_propagation_python(
        g_j, ew, order, opts.max_iterations, opts.max_cluster_size
    )
    jax_native = jax_lp._run_label_propagation(g_j, ew, order, JaxPartitionerOptions())
    np.testing.assert_array_equal(native, python)
    np.testing.assert_array_equal(native, jax_native)
    assert np.unique(native).shape[0] < g_t.num_vertices


def test_aggressive_pass_matches_jax_and_python():
    g_j, g_t = _graphs(150, seed=5)
    ew = np.ones(g_t.num_directed_edges)
    prev = np.random.default_rng(1).integers(0, g_t.num_vertices, size=400)
    native = lp._run_aggressive(g_t, ew, prev)
    np.testing.assert_array_equal(native, jax_lp._aggressive_python(g_j, ew, prev))
    np.testing.assert_array_equal(native, jax_lp._run_aggressive(g_j, ew, prev))


def test_native_entry_points_validate_inputs():
    _, g_t = _graphs(60, seed=2)
    with pytest.raises(ValueError, match="edge weights"):
        lp._run_label_propagation(g_t, np.ones(3), np.arange(g_t.num_vertices), PartitionerOptions())
    with pytest.raises(ValueError, match="prev_parents"):
        lp._run_aggressive(g_t, np.ones(g_t.num_directed_edges), np.asarray([g_t.num_vertices]))


@pytest.mark.parametrize("fault", ["compile error", "no compiler"])
def test_host_build_raises_instead_of_falling_back(tmp_path, monkeypatch, fault):
    """The label propagation has no Python fallback: a host source that
    does not build raises."""
    from wembed_tpu_torch.kernels import _build

    (tmp_path / "broken.cpp").write_text('extern "C" int f() { return }\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    if fault == "no compiler":
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ (failed|not found)"):
        _build.load("broken", lambda lib: None)
    assert not list((tmp_path / "out").glob("*.so"))


def test_compact_cluster_ids_match_jax():
    raw = np.random.default_rng(4).integers(0, 50, size=200)
    np.testing.assert_array_equal(compact_cluster_ids(raw), jax_lp.compact_cluster_ids(raw))


def test_coarsen_graph_matches_jax():
    g_j, g_t = _graphs(250, seed=6)
    clusters = compact_cluster_ids(np.random.default_rng(2).integers(0, 60, size=g_t.num_vertices))
    coarse_t, map_t = algorithms.coarsen_graph(g_t, clusters)
    coarse_j, map_j = jax_algorithms.coarsen_graph(g_j, clusters)
    _assert_same_graph(coarse_t, coarse_j)
    np.testing.assert_array_equal(map_t, map_j)
    with pytest.raises(ValueError, match="gap-free"):
        algorithms.coarsen_graph(g_t, clusters + 1)


@pytest.mark.parametrize("order_type", [0, 1])
def test_coarsen_all_layers_matches_jax(order_type):
    g_j, g_t = _graphs(500, seed=11)
    res_t = coarsen_all_layers(
        g_t, opts=PartitionerOptions(order_type=order_type), rng=np.random.default_rng(7)
    )
    res_j = jax_coarsen_all_layers(
        g_j, opts=JaxPartitionerOptions(order_type=order_type), rng=np.random.default_rng(7)
    )
    assert len(res_t.graphs) == len(res_j.graphs) > 2
    for a, b in zip(res_t.graphs, res_j.graphs):
        _assert_same_graph(a, b)
    assert len(res_t.parent_pointers) == len(res_j.parent_pointers)
    for a, b in zip(res_t.parent_pointers, res_j.parent_pointers):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(res_t.edge_weights, res_j.edge_weights):
        np.testing.assert_array_equal(a, b)


def test_hierarchy_matches_jax():
    g_j, g_t = _graphs(400, seed=13)
    h_t = GraphHierarchy.build(coarsen_all_layers(g_t))
    h_j = JaxHierarchy.build(jax_coarsen_all_layers(g_j))
    assert h_t.num_layers == h_j.num_layers > 2
    for i, (a, b) in enumerate(zip(h_t.layers, h_j.layers)):
        _assert_same_graph(a.graph, b.graph)
        np.testing.assert_array_equal(a.parent, b.parent)
        np.testing.assert_array_equal(a.contained, b.contained)
        assert int(a.contained.sum()) == g_t.num_vertices
        if i + 1 < h_t.num_layers:
            np.testing.assert_array_equal(h_t.num_siblings(i), h_j.num_siblings(i))


def _min_pair_distance(pos: np.ndarray) -> float:
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float(d2.min())


class _NoKickEmbedder(WEmbedEmbedder):
    """The port's flat embedder, asserting before every step that no pair
    coincides, so that no random kick fires (the two packages draw kicks
    from different generators)."""

    def _step(self, state):
        assert _min_pair_distance(state.positions.numpy()) > 0
        return super()._step(state)


def _layered_pair(g_j, g_t, port_opts, **jax_kw):
    """Both layered embedders from the same seed, run to the end; returns
    (JAX per-layer embedders, port per-layer embedders, port layered)."""
    made_j, made_t = [], []

    def jax_factory(graph, opts, **kw):
        made_j.append(JaxEmbedder(graph, opts, **kw))
        return made_j[-1]

    def port_factory(graph, opts, **kw):
        made_t.append(_NoKickEmbedder(graph, opts, **kw))
        return made_t[-1]

    jax_set_seed(11)
    emb_j = JaxLayered(g_j, JaxOptions(**jax_kw), verbose=False, embedder_factory=jax_factory)
    emb_j.calculate_embedding()
    set_seed(11)
    emb_t = LayeredEmbedder(
        g_t, port_opts, verbose=False, embedder_factory=port_factory, device="cpu"
    )
    emb_t.calculate_embedding()
    return made_j, made_t, emb_t


@pytest.mark.parametrize("dense_threshold", [16384, 100])
def test_f64_layered_matches_jax_layer_by_layer(dense_threshold):
    """SIBLING_SPHERE expansion, f64: each layer starts from the JAX
    package's positions (same host draws in the same order) and ends within
    rtol 1e-8 of them after the same number of iterations.  With a
    threshold of 100 the port's finest layer takes the span path, which
    with no window truncated is the dense result."""
    g_j, g_t = _graphs(300, seed=3)
    kw = dict(embedding_dimension=2, dtype="float64", max_iterations=PARITY_ITERATIONS)
    made_j, made_t, emb_t = _layered_pair(
        g_j, g_t, EmbedderOptions(dense_threshold=dense_threshold, **kw), **kw
    )
    assert len(made_t) == len(made_j) == emb_t.hierarchy.num_layers >= 3
    paths = [r.path for r in emb_t.layer_records]
    assert paths[-1] == ("span" if dense_threshold == 100 else "dense")
    assert set(paths[:-1]) == {"dense"}
    for layer_j, layer_t, record in zip(made_j, made_t, emb_t.layer_records):
        assert layer_t.graph.num_vertices == layer_j.graph.num_vertices == record.n
        assert layer_t.iteration == int(layer_j.iteration) == record.iterations
        assert int(layer_t.state.overflow) == 0 and record.final_overflow == 0
        np.testing.assert_array_equal(layer_t.get_weights(), layer_j.get_weights())
        np.testing.assert_allclose(
            layer_t.get_coordinates(), layer_j.get_coordinates(), rtol=1e-8, atol=1e-8
        )
    assert emb_t.current_layer == 0 and emb_t.is_finished()
    assert emb_t.iteration == PARITY_ITERATIONS * len(made_t)
    assert emb_t.hierarchy_seconds > 0


def test_reference_expansion_runs_to_the_end():
    """REFERENCE expansion puts every child on its parent, so each expanded
    layer starts with coincident pairs that only the kicks separate."""
    _, g_t = _graphs(300, seed=3)
    starts = []

    def factory(graph, opts, **kw):
        emb = WEmbedEmbedder(graph, opts, **kw)
        zero = fused_dense_forces_reference(
            emb.state.positions, emb._inv_w, emb._dg.colors, emb._adj,
            dim=2, L=1.0, att_scale=1.0, rep_scale=1.0, additive=False,
        )[1]
        starts.append(int(zero.sum()))
        return emb

    set_seed(2)
    emb = LayeredEmbedder(
        g_t, EmbedderOptions(embedding_dimension=2, max_iterations=40), verbose=False,
        expansion_mode=ExpansionMode.REFERENCE, embedder_factory=factory, device="cpu",
    )
    emb.calculate_embedding()
    assert emb.is_finished() and emb.current_layer == 0
    assert starts[0] == 0 and all(c > 0 for c in starts[1:])  # the coarsest starts random
    for name in ("positions", "adam_m", "adam_v", "attract_loss", "repel_loss"):
        assert torch.isfinite(getattr(emb.state, name)).all()
    assert _min_pair_distance(emb.get_coordinates()) > 0


def test_step_by_step_reaches_is_finished():
    _, g_t = _graphs(200, seed=8)
    set_seed(4)
    emb = LayeredEmbedder(
        g_t, EmbedderOptions(embedding_dimension=2, max_iterations=15), verbose=False, device="cpu"
    )
    layers = emb.hierarchy.num_layers
    assert emb.current_layer == layers - 1 and emb.num_vertices < g_t.num_vertices
    steps = 0
    while not emb.is_finished():
        emb.calculate_step()
        steps += 1
        assert steps <= 15 * layers
    assert emb.current_layer == 0 and emb.num_vertices == g_t.num_vertices
    assert emb.iteration == steps == 15 * layers  # the expanding call also steps
    assert emb.get_coordinates().shape == (g_t.num_vertices, 2)
    records = emb.layer_records
    assert [r.iterations for r in records] == [15] * layers
    assert [r.path for r in records] == ["dense"] * layers
    assert all(r.loop_s > 0 and r.final_overflow == 0 for r in records)


def test_set_coordinates_and_weights_warn():
    _, g_t = _graphs(120, seed=9)
    emb = LayeredEmbedder(g_t, EmbedderOptions(embedding_dimension=2), verbose=False, device="cpu")
    before = emb.get_coordinates()
    with pytest.warns(UserWarning, match="no effect"):
        emb.set_coordinates(np.zeros_like(before))
    with pytest.warns(UserWarning, match="no effect"):
        emb.set_weights(np.ones(before.shape[0]))
    np.testing.assert_array_equal(emb.get_coordinates(), before)


def test_api_layered_embedding():
    api.setSeed(3)
    g = api.Graph(_graphs(200, seed=4)[1])
    emb = api.createEmbedder(
        g, api.Options(embeddingDimension=2, layeredEmbedding=True, maxIterations=30), device="cpu"
    )
    assert isinstance(emb.impl, LayeredEmbedder)
    assert emb.getCurrentGraph().getNumVertices() == emb.getNumVertices() < g.getNumVertices()
    emb.calculateEmbedding()
    assert emb.isFinished()
    assert emb.getCurrentGraph().getNumVertices() == emb.getNumVertices() == g.getNumVertices()
    assert np.isfinite(np.asarray(emb.getCoordinates())).all()
    assert [t.display_name for t in emb.getTimings()][:1] == ["Embedding"]


def test_api_layered_small_graph_matches_flat():
    """small_graph (5 vertices) is below the final layer size, so its
    hierarchy has one layer and the layered run is the flat one."""
    options = dict(embeddingDimension=2, maxIterations=200)
    api.setSeed(21)
    layered = api.createEmbedder(
        api.graphFromEdgeListFile(SMALL_GRAPH), api.Options(layeredEmbedding=True, **options),
        device="cpu",
    )
    layered.calculateEmbedding()
    api.setSeed(21)
    flat = api.createEmbedder(api.graphFromEdgeListFile(SMALL_GRAPH), api.Options(**options), device="cpu")
    flat.calculateEmbedding()
    assert layered.impl.hierarchy.num_layers == 1
    np.testing.assert_array_equal(np.asarray(layered.getCoordinates()), np.asarray(flat.getCoordinates()))
    assert layered.getLoss().total == flat.getLoss().total


def test_cli_layered(tmp_path):
    out = tmp_path / "emb.csv"
    rc = embed_cli.main(
        ["-i", SMALL_GRAPH, "-o", str(out), "--seed", "1", "--dim", "2", "--layered"],
        device="cpu",
    )
    assert rc == 0
    coords = io.read_coordinates(str(out))
    assert coords.shape == (5, 3)  # two coordinates and the weight
    assert np.isfinite(coords).all()


def _fields(cls) -> dict:
    """{name: default} of a dataclass; an enum default as its class name,
    member name and value (each package declares its own enums)."""
    import dataclasses
    import enum

    def plain(v):
        return (type(v).__name__, v.name, v.value) if isinstance(v, enum.Enum) else v

    return {f.name: plain(f.default) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize(
    "port,reference,omitted",
    [
        (PartitionerOptions, JaxPartitionerOptions, set()),
        # the JAX package's TPU kernel switches and its chunked dense path's
        # row block, which the port leaves out (core/options.py)
        (EmbedderOptions, JaxOptions, {"fused_dense", "fused_span", "block_size"}),
    ],
)
def test_options_take_the_reference_fields(port, reference, omitted):
    """The port's options dataclasses declare the JAX package's fields, in
    name and default, less the documented omissions; so a call written
    against the reference's constructor builds on the port."""
    got, want = _fields(port), _fields(reference)
    assert omitted <= set(want) and not omitted & set(got)
    assert got == {k: v for k, v in want.items() if k not in omitted}
    assert port(**{f: getattr(port(), f) for f in got}) == port()


def test_partitioner_options_take_num_hierarchies():
    assert PartitionerOptions(num_hierarchies=2).num_hierarchies == 2
    assert PartitionerOptions().num_hierarchies == JaxPartitionerOptions().num_hierarchies == 1
