"""The port's flat embedder as a whole against the JAX package's, from
identical coordinates and weights (the tests/reference_oracle.py pattern):
f64 trajectories against the jnp dense path, f32 steps against the Pallas
kernel in interpret mode, convergence, checkpoint hand-over and the API."""

import numpy as np
import pytest
import torch

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import RepulsionMode as JaxRepulsionMode
from wembed_tpu.core import WEmbedEmbedder as JaxEmbedder
from wembed_tpu.core import checkpoint as jax_checkpoint
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.graphs import generators

from wembed_tpu_torch import api, convert
from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder
from wembed_tpu_torch.graphs import from_edges, io
from wembed_tpu_torch.graphs.csr import CSRGraph
from wembed_tpu_torch.kernels.fused_dense import fused_dense_forces_reference
from wembed_tpu_torch.utils import set_seed

torch.set_num_threads(1)


def _graphs(d, seed=7):
    """(JAX graph, the same graph in the port's CSRGraph, coords, weights)."""
    rng = np.random.default_rng(seed)
    g_j, _ = generators.geometric_graph(120, rng=rng)
    g_t = CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)
    n = g_j.num_vertices
    coords = rng.uniform(0, n ** (1 / d), size=(n, d))
    w = jax_weights.initial_weights(g_j, JaxOptions(embedding_dimension=d))
    return g_j, g_t, coords, w


def _jax(g, coords, w, **kw):
    return JaxEmbedder(
        g, JaxOptions(**kw), initial_coordinates=coords, initial_weights=w, verbose=False
    )


def _port(g, coords, w, **kw):
    return WEmbedEmbedder(
        g, EmbedderOptions(**kw), initial_coordinates=coords, initial_weights=w,
        verbose=False, device="cpu",
    )


def _no_coincident_pairs(emb: WEmbedEmbedder) -> bool:
    """True when this step's force pass fires no random kick (the two
    packages draw kicks from different generators)."""
    s = emb.state
    zero = fused_dense_forces_reference(
        s.positions, emb._inv_w, emb._dg.colors, emb._adj,
        dim=emb.embedding_dimension, L=1.0, att_scale=1.0, rep_scale=1.0, additive=False,
    )[1]
    return int(zero.sum()) == 0


def _assert_same_step(emb_t, emb_j, rtol):
    np.testing.assert_allclose(emb_t.get_coordinates(), emb_j.get_coordinates(), rtol=rtol, atol=rtol)
    assert int(emb_t.state.num_rep_forces) == int(emb_j.state.num_rep_forces)
    assert emb_t.iteration == emb_j.iteration


def test_f64_trajectory_matches_jax_dense_path():
    g_j, g_t, coords, w = _graphs(2)
    kw = dict(embedding_dimension=2, dtype="float64")
    emb_j = _jax(g_j, coords, w, repulsion_mode=JaxRepulsionMode.DENSE, **kw)
    emb_t = _port(g_t, coords, w, **kw)
    for _ in range(10):
        assert _no_coincident_pairs(emb_t)
        emb_j.calculate_step()
        emb_t.calculate_step()
        _assert_same_step(emb_t, emb_j, rtol=1e-9)
        # the JAX package sums losses and the displacement in f32
        loss_t, loss_j = emb_t.get_loss(), emb_j.get_loss()
        np.testing.assert_allclose(loss_t.attractive, loss_j.attractive, rtol=1e-5)
        np.testing.assert_allclose(loss_t.repulsive, loss_j.repulsive, rtol=1e-5)
        np.testing.assert_allclose(
            float(emb_t.state.pos_change), float(emb_j.state.pos_change), rtol=1e-5
        )


@pytest.mark.parametrize("additive", [False, True])
def test_f32_steps_match_pallas_kernel(additive):
    # the inputs of tests/test_kernels.py:test_fused_matches_jnp_dense
    g_j, g_t, coords, w = _graphs(3, seed=7)
    kw = dict(embedding_dimension=3, dtype="float32", additive_weights=additive)
    emb_j = _jax(g_j, coords, w, repulsion_mode=JaxRepulsionMode.DENSE, fused_dense="interpret", **kw)
    emb_t = _port(g_t, coords, w, **kw)
    for _ in range(5):
        emb_j.calculate_step()
        emb_t.calculate_step()
        # and its tolerances (the Pallas kernel against the jnp path): f32
        # positions drift ~1e-4 from an f64 run, and a repulsion loss of a
        # few pairs near the dead-zone edge is a difference of near-equal terms
        np.testing.assert_allclose(
            emb_t.get_coordinates(), emb_j.get_coordinates(), rtol=3e-4, atol=2e-5
        )
        assert int(emb_t.state.num_rep_forces) == int(emb_j.state.num_rep_forces)
        np.testing.assert_allclose(
            float(emb_t.state.attract_loss), float(emb_j.state.attract_loss), rtol=1e-4
        )
        np.testing.assert_allclose(
            float(emb_t.state.repel_loss), float(emb_j.state.repel_loss), rtol=1e-4, atol=1e-5
        )


def test_small_graph_converges():
    set_seed(5)
    g = io.read_edge_list("assets/small_graph.edg")
    emb = WEmbedEmbedder(g, EmbedderOptions(embedding_dimension=2), verbose=False, device="cpu")
    emb.calculate_embedding()
    assert 0 < emb.iteration < emb.opts.max_iterations
    assert emb.is_finished()
    assert emb.get_loss().total < 0.5
    assert [t.display_name for t in emb.get_timings()] == ["Embedding"]


def test_jax_checkpoint_continues_identically(tmp_path):
    g_j, g_t, coords, w = _graphs(2, seed=11)
    kw = dict(embedding_dimension=2, dtype="float64")
    emb_j = _jax(g_j, coords, w, repulsion_mode=JaxRepulsionMode.DENSE, **kw)
    for _ in range(5):
        emb_j.calculate_step()
    path = str(tmp_path / "ckpt.npz")
    jax_checkpoint.save_checkpoint(path, emb_j)

    emb_t = _port(g_t, np.zeros_like(coords), np.ones_like(w), **kw)
    state, weights = convert.state_from_numpy(
        convert.load_jax_checkpoint(path), "cpu", torch.float64
    )
    emb_t.set_weights(weights)
    emb_t.state = state
    np.testing.assert_array_equal(emb_t.get_weights(), w)
    assert emb_t.iteration == 5
    for _ in range(5):
        assert _no_coincident_pairs(emb_t)
        emb_j.calculate_step()
        emb_t.calculate_step()
        _assert_same_step(emb_t, emb_j, rtol=1e-9)


def test_api_matches_embedder():
    path = "assets/small_graph.edg"
    api.setSeed(21)
    emb_a = api.createEmbedder(
        api.graphFromEdgeListFile(path), api.Options(embeddingDimension=2), device="cpu"
    )
    emb_a.calculateEmbedding()
    set_seed(21)
    emb_e = WEmbedEmbedder(
        io.read_edge_list(path), EmbedderOptions(embedding_dimension=2), verbose=False, device="cpu"
    )
    emb_e.calculate_embedding()
    assert emb_a.isFinished()
    np.testing.assert_array_equal(np.asarray(emb_a.getCoordinates()), emb_e.get_coordinates())
    np.testing.assert_array_equal(np.asarray(emb_a.getWeights()), emb_e.get_weights())
    assert emb_a.getLoss().total == emb_e.get_loss().total


def test_set_coordinates_copies_prefix_on_dimension_mismatch():
    g = io.read_edge_list("assets/small_graph.edg")
    coords = np.arange(15, dtype=np.float64).reshape(5, 3)
    emb = WEmbedEmbedder(
        g, EmbedderOptions(embedding_dimension=3), initial_coordinates=coords,
        verbose=False, device="cpu",
    )
    emb.set_coordinates(-np.ones((5, 2)))
    want = coords.copy()
    want[:, :2] = -1.0
    np.testing.assert_array_equal(emb.get_coordinates(), want)


def test_single_vertex_short_circuits():
    emb = WEmbedEmbedder(from_edges(np.empty((0, 2)), num_vertices=1), verbose=False, device="cpu")
    emb.calculate_step()
    assert emb.iteration == 1 and emb.is_finished()
    emb.calculate_embedding()
    assert emb.iteration == 1
