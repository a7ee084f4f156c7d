"""Negative sampling in the port (reference NewWEmbedEmbedder.cpp:250-252,
292-295): neighbour membership against the JAX package's, the sampled pass
from shared candidates against the JAX package and a per-pair numpy
oracle, the statistics of the draw against the exact repulsion, and a short
sampled embedding."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import forces as jax_forces
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.core.state import DeviceGraph as JaxDeviceGraph
from wembed_tpu.graphs import generators as jax_generators

from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder, forces
from wembed_tpu_torch.core.state import DeviceGraph
from wembed_tpu_torch.graphs import io
from wembed_tpu_torch.graphs.csr import CSRGraph
from wembed_tpu_torch.kernels.fused_dense import fused_dense_forces_reference
from wembed_tpu_torch.utils import set_seed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _case(n=150, seed=4, d=2, bipartite=False):
    """(JAX graph, port graph, positions (n, d), degree weights) of a
    geometric graph, at positions where repulsion is common."""
    rng = np.random.default_rng(seed)
    g_j, _ = jax_generators.geometric_graph(n, rng=rng)
    n = g_j.num_vertices
    if bipartite:
        g_j = g_j.with_colors((np.arange(n) % 2).astype(np.int32))
    g_t = CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)
    pos = rng.uniform(0, 0.5 * n ** (1 / d), size=(n, d))
    w = jax_weights.initial_weights(g_j, JaxOptions(embedding_dimension=d))
    return g_j, g_t, pos, w


def test_edge_membership_matches_jax():
    g_j, g_t, _, _ = _case()
    n = g_t.num_vertices
    rng = np.random.default_rng(1)
    src = np.concatenate([rng.integers(0, n, 4000), g_t.edge_src])
    dst = np.concatenate([rng.integers(0, n, 4000), g_t.col_idx])
    got = forces._edge_membership(
        DeviceGraph.build(g_t, CPU), torch.as_tensor(src), torch.as_tensor(dst)
    ).numpy()
    want = np.asarray(jax_forces._edge_membership(JaxDeviceGraph.build(g_j), src, dst))
    np.testing.assert_array_equal(got, want)
    assert got[4000:].all()  # every true edge
    assert 0 < got[:4000].sum() < 4000
    assert [g_t.are_neighbors(int(a), int(b)) for a, b in zip(src[:300], dst[:300])] == list(got[:300])


def _oracle(pos, inv_w, g, cand, opts):
    """Per pair, the reference's sampled repulsion
    (NewWEmbedEmbedder.cpp:250-252 draws k negatives a vertex, 292-295
    scales their force by n/k): (force, loss, count, zero_count)."""
    n, k = cand.shape
    L = opts.edge_length
    force = np.zeros_like(pos)
    loss, count = 0.0, 0
    zero = np.zeros(n, np.int64)
    for v in range(n):
        for u in cand[v]:
            if g.same_color(v, int(u)) or g.are_neighbors(v, int(u)):
                continue
            count += 1
            diff = pos[v] - pos[u]
            dist = np.sqrt(np.sum(diff * diff))
            ws = inv_w[v] + inv_w[u] if opts.additive_weights else inv_w[v] * inv_w[u]
            if dist == 0:
                zero[v] += 1
            elif dist * ws <= L:
                force[v] += opts.repulsion_scale * ws * (n / k) * diff / dist
                loss += L / ws - dist
    return force, loss, count, zero


@pytest.mark.parametrize("additive,bipartite", [(False, False), (True, True)])
def test_sampled_pass_matches_jax_and_oracle(additive, bipartite):
    """The same candidates (JAX's own ``randint`` draw for its key) through
    the JAX package's pass, the port's and the oracle: within 1e-12."""
    g_j, g_t, pos, w = _case(bipartite=bipartite)
    n, k = g_t.num_vertices, 8
    kw = dict(embedding_dimension=2, num_negative_samples=k, additive_weights=additive, repulsion_scale=1.5)
    inv_w = jax_weights.inv_exp_weights(w, 2)
    pos[3] = pos[4]  # one coincident pair
    key = jax.random.key(17)
    f_j, loss_j, count_j, zero_j = jax_forces.sampled_repulsion_forces(
        jnp.asarray(pos), jnp.asarray(inv_w), JaxDeviceGraph.build(g_j), JaxOptions(**kw), key
    )
    opts = EmbedderOptions(**kw)
    dg = DeviceGraph.build(g_t, CPU)
    cand = np.array(jax.random.randint(key, (n, k), 0, n))  # the JAX package's draw
    both = cand.copy()
    both[3, 0], both[4, 0] = 4, 3  # the coincident pair, drawn from both sides
    for c in (cand, both):
        f_t, loss_t, count_t, zero_t = forces._sampled_from_candidates(
            torch.as_tensor(pos), torch.as_tensor(inv_w), dg, opts, torch.as_tensor(c)
        )
        f_o, loss_o, count_o, zero_o = _oracle(pos, inv_w, g_t, c, opts)
        scale = np.abs(f_o).max()
        np.testing.assert_allclose(f_t.numpy(), f_o, rtol=1e-12, atol=1e-12 * scale)
        np.testing.assert_allclose(float(loss_t), loss_o, rtol=1e-12)
        assert int(count_t) == count_o > 0.4 * n * k
        np.testing.assert_array_equal(zero_t.numpy(), zero_o)
        if c is cand:
            np.testing.assert_allclose(np.asarray(f_j), f_o, rtol=1e-12, atol=1e-12 * scale)
            np.testing.assert_allclose(float(loss_j), loss_o, rtol=1e-6)  # summed in f32
            assert int(count_j) == count_o
            np.testing.assert_array_equal(np.asarray(zero_j), zero_o)
    assert zero_o[3] >= 1 and zero_o[4] >= 1


def test_sampled_force_is_unbiased():
    """The mean sampled force over 400 draws lies within 4 standard errors
    of the exact all-pairs repulsion (the dense kernel's plain version with
    the attraction scale at 0), vertex by vertex.  Drawn with replacement
    (the documented deviation from the reference's Floyd sampling): each of
    the k draws is a uniform vertex, invalid ones (itself, a neighbour, its
    colour) contribute 0, so n/k times the sum is an unbiased estimate."""
    _, g_t, pos, w = _case(n=60, seed=8)
    k, draws = 5, 400
    opts = EmbedderOptions(embedding_dimension=2, num_negative_samples=k)
    dg = DeviceGraph.build(g_t, CPU)
    p = torch.as_tensor(pos)
    inv_w = torch.as_tensor(jax_weights.inv_exp_weights(w, 2))
    gen = torch.Generator().manual_seed(3)
    samples = torch.stack(
        [forces.sampled_repulsion_forces(p, inv_w, dg, opts, gen)[0] for _ in range(draws)]
    ).numpy()
    exact = fused_dense_forces_reference(
        p, inv_w, dg.colors, forces.build_dense_adjacency(dg), dim=2, L=1.0, att_scale=0.0, rep_scale=1.0, additive=False
    )[0].numpy()
    assert np.abs(exact).max() > 0
    mean = samples.mean(axis=0)
    se = samples.std(axis=0, ddof=1) / np.sqrt(draws)
    assert np.all(np.abs(mean - exact) <= 4 * se + 1e-12)


def test_zero_samples_switch_repulsion_off():
    g = io.read_edge_list(os.path.join(REPO, "assets", "small_graph.edg"))
    set_seed(2)
    emb = WEmbedEmbedder(
        g, EmbedderOptions(embedding_dimension=2, num_negative_samples=0), verbose=False, device="cpu"
    )
    emb.calculate_step()
    assert emb.path == "sampled"
    assert float(emb.state.repel_loss) == 0.0 and int(emb.state.num_rep_forces) == 0


def test_sampled_embedding_converges():
    g = io.read_edge_list(os.path.join(REPO, "assets", "small_graph.edg"))
    set_seed(5)
    emb = WEmbedEmbedder(
        g, EmbedderOptions(embedding_dimension=2, num_negative_samples=3), verbose=False, device="cpu"
    )
    assert emb._adj is None and emb._index is None
    emb.calculate_embedding()
    assert 0 < emb.iteration < emb.opts.max_iterations and emb.is_finished()
    assert emb.get_loss().total < 0.5
    assert np.isfinite(emb.get_coordinates()).all()
