"""The port's numpy-only graph, API and drawing modules against the JAX
package's (the same inputs, the same outputs, text for text), weight
dumping against the JAX package's lines, and debug checks."""

import jax
import numpy as np
import pytest
import torch

from wembed_tpu import api as jax_api
from wembed_tpu import draw as jax_draw
from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import WEmbedEmbedder as JaxEmbedder
from wembed_tpu.graphs import algorithms as jax_algorithms
from wembed_tpu.graphs import csr as jax_csr
from wembed_tpu.graphs import generators as jax_generators
from wembed_tpu.graphs import io as jax_io

from wembed_tpu_torch import api, draw
from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder
from wembed_tpu_torch.graphs import algorithms, csr, generators, io
from wembed_tpu_torch.graphs.csr import CSRGraph

torch.set_num_threads(1)


def _same_graph(a, b):
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col_idx, b.col_idx)
    np.testing.assert_array_equal(a.colors, b.colors)


@pytest.mark.parametrize("n,kw", [(300, {}), (500, dict(grid_size=30.0, radius=1.5)), (40, dict(radius=0.5))])
def test_geometric_graph_matches_jax(n, kw):
    g_t, c_t = generators.geometric_graph(n, rng=np.random.default_rng(n), **kw)
    g_j, c_j = jax_generators.geometric_graph(n, rng=np.random.default_rng(n), **kw)
    _same_graph(g_t, g_j)
    np.testing.assert_array_equal(c_t, c_j)


def test_algorithms_match_jax():
    g_t, _ = generators.geometric_graph(150, radius=1.2, rng=np.random.default_rng(1))
    g_j = jax_csr.CSRGraph(g_t.row_ptr, g_t.col_idx)
    split = csr.from_edges(np.asarray([[0, 1], [2, 3], [3, 4]]), num_vertices=7)
    split_j = jax_csr.CSRGraph(split.row_ptr, split.col_idx)
    for a, b in ((g_t, g_j), (split, split_j)):
        assert algorithms.num_connected_components(a) == jax_algorithms.num_connected_components(b)
        assert algorithms.is_connected(a) == jax_algorithms.is_connected(b)
        np.testing.assert_array_equal(algorithms.bfs_distances(a, 0), jax_algorithms.bfs_distances(b, 0))
    assert algorithms.num_connected_components(split) == 4 and not algorithms.is_connected(split)
    np.testing.assert_array_equal(
        algorithms.all_pairs_shortest_paths(g_t), jax_algorithms.all_pairs_shortest_paths(g_j)
    )
    np.testing.assert_array_equal(
        algorithms.all_pairs_shortest_paths(split), jax_algorithms.all_pairs_shortest_paths(split_j)
    )


def test_from_adjacency_and_induced_subgraph_match_jax():
    adj = {0: [1, 2], 3: [], 5: [4, 0]}
    _same_graph(csr.from_adjacency(adj), jax_csr.from_adjacency(adj))
    assert csr.from_adjacency({}).num_vertices == 0
    g_t, _ = generators.geometric_graph(120, rng=np.random.default_rng(7))
    g_j = jax_csr.CSRGraph(g_t.row_ptr, g_t.col_idx)
    ids = np.random.default_rng(0).permutation(g_t.num_vertices)[:50]
    sub_t, map_t = csr.induced_subgraph(g_t, ids)
    sub_j, map_j = jax_csr.induced_subgraph(g_j, ids)
    _same_graph(sub_t, sub_j)
    np.testing.assert_array_equal(map_t, map_j)


def test_bipartite_reader_and_column_splits_match_jax(tmp_path):
    p = tmp_path / "b.edg"
    p.write_text("#psizes 3 2\n0 3\n# a comment\n0 4\n1 3\n\n2 4 extra\n")
    _same_graph(io.read_bipartite_edge_list(str(p)), jax_io.read_bipartite_edge_list(str(p)))
    assert io.read_bipartite_edge_list(str(p)).colors.tolist() == [0, 0, 0, 1, 1]
    bad = tmp_path / "bad.edg"
    bad.write_text("0 1\n")
    with pytest.raises(ValueError, match="bipartite header"):
        io.read_bipartite_edge_list(str(bad))
    coords = np.arange(12.0).reshape(4, 3)
    for ours, theirs in ((io.split_last_column, jax_io.split_last_column),
                         (io.split_first_column, jax_io.split_first_column)):
        for a, b in zip(ours(coords), theirs(coords)):
            np.testing.assert_array_equal(a, b)


def test_graph_from_edges():
    g = api.graphFromEdges([api.Edge(0, 1), api.Edge(1, 2), api.Edge(2, 0)])
    assert g.getNumVertices() == 3 and g.getNumEdges() == 3
    h = api.graphFromEdges(np.asarray([[0, 1], [1, 2], [2, 0]]))
    np.testing.assert_array_equal(g.csr.col_idx, h.csr.col_idx)
    _same_graph(h.csr, jax_api.graphFromEdges(np.asarray([[0, 1], [1, 2], [2, 0]])).csr)
    assert api.graphFromEdges([]).getNumVertices() == 0


def test_graph_from_networkx_duck_typed():
    """Only ``nodes()`` and ``edges()`` are needed: a stand-in, since
    networkx is not a dependency of the port."""

    class FakeNx:
        def nodes(self):
            return ["a", "b", "c", "d", "e"]

        def edges(self):
            return [("a", "b"), ("b", "c"), ("c", "d"), ("d", "a")]

    g = api.graph_from_networkx(FakeNx())
    assert g.getNumVertices() == 5 and g.getNumEdges() == 4
    assert g.node_labels == ["a", "b", "c", "d", "e"]
    assert g.areNeighbors(0, 1) and not g.areNeighbors(0, 2)
    _same_graph(g.csr, jax_api.graph_from_networkx(FakeNx()).csr)


def test_svg_and_ipe_text_match_jax(tmp_path):
    g, coords = generators.geometric_graph(80, rng=np.random.default_rng(3))
    w = np.random.default_rng(4).pareto(2.0, g.num_vertices) + 1.0
    g_j = jax_csr.CSRGraph(g.row_ptr, g.col_idx)
    cases = [
        ("svg", lambda p, gg, mod: mod.write_svg(p, gg, coords, weights=w)),
        ("svg", lambda p, gg, mod: mod.write_svg(p, gg, coords[:, :1], draw_edges=False)),
        ("ipe", lambda p, gg, mod: mod.write_ipe(p, gg, coords)),
    ]
    for i, (ext, write) in enumerate(cases):
        ours, theirs = tmp_path / f"t{i}.{ext}", tmp_path / f"j{i}.{ext}"
        write(str(ours), g, draw)
        write(str(theirs), g_j, jax_draw)
        assert ours.read_text() == theirs.read_text()
    assert draw.weight_colors(w) == jax_draw.weight_colors(w)


def test_animation_drives_a_port_embedder(tmp_path):
    """``animate_embedding`` runs the port's API embedder to convergence,
    and the animated SVG of its frames is the JAX package's text."""
    api.setSeed(5)
    g, _ = generators.geometric_graph(60, rng=np.random.default_rng(2))
    emb = api.createEmbedder(api.Graph(g), api.Options(embeddingDimension=2, maxIterations=30), device="cpu")
    rec = draw.animate_embedding(emb, every=5)
    assert emb.isFinished() and len(rec) >= 3
    ours, theirs = tmp_path / "ours.svg", tmp_path / "theirs.svg"
    w = np.asarray(emb.getWeights())
    draw.write_animated_svg(str(ours), g, rec.frames, weights=w)
    jax_draw.write_animated_svg(str(theirs), jax_csr.CSRGraph(g.row_ptr, g.col_idx), rec.frames, weights=w)
    assert ours.read_text() == theirs.read_text()
    assert ours.read_text().count('attributeName="cx"') == g.num_vertices


def _pair(n=100, seed=6, **kw):
    g_j, _ = jax_generators.geometric_graph(n, rng=np.random.default_rng(seed))
    g_t = CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)
    coords = np.random.default_rng(seed).uniform(0, 8, size=(g_j.num_vertices, 2))
    emb_j = JaxEmbedder(g_j, JaxOptions(embedding_dimension=2, dtype="float64", **kw),
                        initial_coordinates=coords, verbose=False)
    emb_t = WEmbedEmbedder(g_t, EmbedderOptions(embedding_dimension=2, dtype="float64", **kw),
                           initial_coordinates=coords, verbose=False, device="cpu")
    return emb_j, emb_t


def test_dump_weights_lines_match_jax(tmp_path, monkeypatch):
    emb_j, emb_t = _pair(dump_weights=True, max_iterations=3)
    texts = []
    for name, emb in (("jax", emb_j), ("port", emb_t)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        emb.calculate_step()
        emb.calculate_step()
        emb.calculate_embedding()  # the host loop, one line a step
        texts.append((tmp_path / name / "weight_dump.txt").read_text())
    assert texts[0] == texts[1]
    lines = texts[1].splitlines(keepends=True)
    assert len(lines) == 3 and lines[0].endswith(" \n")
    assert [float(x) for x in lines[0].split()] == emb_t.get_weights().tolist()


def test_debug_checks_raise_on_an_injected_nan():
    debug_nans = jax.config.jax_debug_nans
    try:
        _, emb = _pair(debug_checks=True, max_iterations=5)
        emb.calculate_step()  # a clean step passes
        emb.calculate_embedding()
        assert emb.iteration == 5
        bad = emb.get_coordinates()
        bad[0, 0] = np.nan
        emb.set_coordinates(bad)
        with pytest.raises(FloatingPointError, match="non-finite entries in positions at iteration 6"):
            emb.calculate_step()
    finally:
        # the JAX embedder's debug_checks turn jax_debug_nans on for the
        # whole process, where later test files' bitcasts would raise
        jax.config.update("jax_debug_nans", debug_nans)
