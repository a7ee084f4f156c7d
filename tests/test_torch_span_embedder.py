"""The port's embedder on the span path as a whole: its f64 trajectory
against the JAX package's f64 dense path from the same coordinates and
weights, convergence through the API, the routing of large graphs, and the
growth protocol around the loop."""

import dataclasses

import numpy as np
import pytest
import torch

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import RepulsionMode as JaxRepulsionMode
from wembed_tpu.core import WEmbedEmbedder as JaxEmbedder
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.graphs import generators as jax_generators

from wembed_tpu_torch import api
from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder
from wembed_tpu_torch.core import span_driver
from wembed_tpu_torch.graphs import from_edges, generators
from wembed_tpu_torch.graphs.csr import CSRGraph
from wembed_tpu_torch.kernels import span_sparse
from wembed_tpu_torch.utils import set_seed

torch.set_num_threads(1)


def _girg(n, seed, **kw):
    g, _, _ = generators.girg(n, dim=2, avg_degree=10, ple=2.5, rng=np.random.default_rng(seed), **kw)
    return g


def _span(g, coords=None, w=None, **kw):
    return WEmbedEmbedder(
        g, EmbedderOptions(repulsion_mode=RepulsionMode.BUCKET, **kw),
        initial_coordinates=coords, initial_weights=w, verbose=False, device="cpu",
    )


def _min_pair_distance(pos):
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float(d2.min())


@pytest.mark.parametrize("d", [2, 3])
def test_f64_span_trajectory_matches_jax_dense_path(d):
    """With no window truncated, the span path's active set is the dense
    one, so its f64 trajectory is the JAX package's f64 dense trajectory."""
    g_j, _, _ = jax_generators.girg(700, dim=2, avg_degree=10, ple=2.5, rng=np.random.default_rng(23))
    g_t = CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)
    n = g_j.num_vertices
    coords = np.random.default_rng(17).uniform(0, n ** (1 / d), size=(n, d))
    w = jax_weights.initial_weights(g_j, JaxOptions(embedding_dimension=d))
    emb_j = JaxEmbedder(
        g_j, JaxOptions(embedding_dimension=d, dtype="float64", repulsion_mode=JaxRepulsionMode.DENSE),
        initial_coordinates=coords, initial_weights=w, verbose=False,
    )
    emb_t = _span(g_t, coords, w, embedding_dimension=d, dtype="float64")
    assert emb_t._adj is None and emb_t._index.w > 0
    for _ in range(5):
        # no coincident pair: the two packages' kicks come from different generators
        assert _min_pair_distance(emb_t.get_coordinates()) > 0
        emb_j.calculate_step()
        emb_t.calculate_step()
        assert int(emb_t.state.overflow) == 0
        np.testing.assert_allclose(emb_t.get_coordinates(), emb_j.get_coordinates(), rtol=1e-9, atol=1e-9)
        assert emb_t.iteration == emb_j.iteration
        # the JAX package sums the losses and the displacement in f32
        np.testing.assert_allclose(emb_t.get_loss().attractive, emb_j.get_loss().attractive, rtol=1e-5)
        np.testing.assert_allclose(emb_t.get_loss().repulsive, emb_j.get_loss().repulsive, rtol=1e-5)
        np.testing.assert_allclose(float(emb_t.state.pos_change), float(emb_j.state.pos_change), rtol=1e-5)


def test_api_converges_on_the_span_path(monkeypatch):
    translate = api._translate_options
    monkeypatch.setattr(
        api, "_translate_options",
        lambda options: dataclasses.replace(translate(options), dense_threshold=100),
    )
    g = _girg(400, seed=3)
    api.setSeed(4)
    emb = api.createEmbedder(api.Graph(g), api.Options(embeddingDimension=2), device="cpu")
    assert emb.impl._index is not None
    emb.calculateEmbedding()
    assert emb.isFinished()
    assert 0 < emb.impl.iteration < 1000
    assert int(emb.impl.state.overflow) == 0
    assert np.isfinite(emb.getCoordinates()).all()
    assert 0 < emb.getLoss().total < float("inf")


def test_large_graph_takes_the_span_path():
    n = 16_500  # above the default dense_threshold of 16384
    rng = np.random.default_rng(0)
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    chords = rng.integers(0, n, size=(2 * n, 2))
    g = from_edges(np.concatenate([ring, chords]), num_vertices=n)
    set_seed(1)
    emb = api.createEmbedder(api.Graph(g), api.Options(embeddingDimension=2), device="cpu")
    impl = emb.impl
    assert impl._adj is None  # no (n, n) adjacency
    assert isinstance(impl._index, span_sparse.SpanIndex)
    # presize left the windows covering the starting positions
    assert impl._measure_needs()[1] == 0


def test_loop_grows_windows_from_nothing(monkeypatch):
    """As tests/test_kernels.py:375: presize under needs pinned to zero
    leaves every window at 0 tiles; the loop's own measurements then grow
    them back to full coverage within a few events."""
    g = _girg(600, seed=3)
    zero = lambda self: (np.zeros(self._index.blk_t.shape, np.int64), 0)  # noqa: E731
    with monkeypatch.context() as m:
        m.setattr(span_driver.SpanGrowthMixin, "_measure_needs", zero)
        set_seed(21)
        emb = _span(g, embedding_dimension=2, max_iterations=6, position_min_change=0.0)
    assert int(emb._index.blk_t.sum()) == 0
    emb.calculate_embedding()
    assert emb.iteration == 6
    assert int(emb.state.overflow) == 0
    assert np.isfinite(emb.get_coordinates()).all()
    assert 0 < emb._growth_events <= 12


def test_stale_overflow_resumes_without_growth():
    """As tests/test_kernels.py:546: needs that call the windows covered
    while the state carries an overflow mean the overflow is one step old;
    the protocol resumes without growth 3 times, then widens every live
    window by one tile."""
    g = _girg(600, seed=3)
    set_seed(13)
    emb = _span(g, embedding_dimension=2, max_iterations=3)
    emb.calculate_embedding()
    idx1 = emb._index._with_blk_t(np.minimum(emb._index.blk_t, 1).astype(np.int64))
    emb._swap_index(idx1)
    emb._measure_needs = lambda: (np.zeros((idx1.nb, idx1.num_rows), np.int64), 0)
    emb.state = dataclasses.replace(emb.state, overflow=torch.tensor(7))
    events = emb._growth_events
    for _ in range(3):
        assert emb._grow_spans() is True
        assert emb._index is idx1 and emb._growth_events == events
    assert emb._grow_spans() is True
    assert emb._index is not idx1 and emb._growth_events == events + 1
    grew = emb._index.blk_t.astype(np.int64) - idx1.blk_t
    assert grew.max() == 1 and grew.min() >= 0
    assert (grew[idx1.blk_t == 0] == 0).all()  # only live windows grew


def test_segment_boundaries_shrink_after_growth_free_segments(monkeypatch):
    """The loop pauses at every multiple of span_resize_interval and, after
    a segment without growth, shrinks the windows to their needs."""
    calls = []
    shrink = span_driver.SpanGrowthMixin._maybe_shrink_spans

    def counted(self):
        calls.append(self.iteration)
        shrink(self)

    monkeypatch.setattr(span_driver.SpanGrowthMixin, "_maybe_shrink_spans", counted)
    g = _girg(600, seed=3)
    set_seed(5)
    emb = _span(
        g, embedding_dimension=2, max_iterations=35, position_min_change=0.0,
        span_resize_interval=10,
    )
    # whole-row windows never overflow, so no segment sees growth
    full = np.broadcast_to(emb._index.row_tiles[None, :], emb._index.blk_t.shape)
    emb._swap_index(emb._index._with_blk_t(full))
    emb.calculate_embedding()
    assert emb.iteration == 35
    assert calls == [10, 20, 30]
    assert emb._growth_events == 0 and int(emb.state.overflow) == 0
