"""The partial span index (``index_size < 1``): from one shared member
sample the port's span path gives the JAX package's bucket path, the
port's own draw is an exact-size uniform sample of every doubling class,
and an ``index_size=0.5`` embedding converges and resumes bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import RepulsionMode as JaxRepulsionMode
from wembed_tpu.core import candidates as jax_candidates
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.core.state import DeviceGraph as JaxDeviceGraph
from wembed_tpu.graphs import generators as jax_generators

from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder
from wembed_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from wembed_tpu_torch.core.weights import initial_weights
from wembed_tpu_torch.graphs import generators
from wembed_tpu_torch.kernels import span_sparse
from wembed_tpu_torch.utils import set_seed

torch.set_num_threads(1)

HALF = dict(repulsion_mode=RepulsionMode.BUCKET, index_size=0.5)


def _girg(n, seed):
    return generators.girg(n, dim=2, avg_degree=10, ple=2.3, rng=np.random.default_rng(seed))[0]


# one dimension: the JAX bucket path compiles for ~40 s on the CPU for each
# new set of shapes, and the two cases share theirs
@pytest.mark.parametrize("d,additive", [(2, False), (2, True)])
def test_shared_sample_matches_the_jax_bucket_path(d, additive):
    """The JAX package's BucketIndex at index_size=0.5 draws its members
    (``build_structures``, ``in_index``); fed the same sample, the port's
    span repulsion gives the JAX bucket path's forces in f64 within rtol
    1e-9, the same candidate and coincident counts, both overflows 0.  The
    JAX package sums its losses in f32, hence their 1e-6."""
    g, _, _ = jax_generators.girg(900, dim=2, avg_degree=12, ple=2.2, rng=np.random.default_rng(d))
    n = g.num_vertices
    jopts = JaxOptions(
        embedding_dimension=d, dtype="float64", repulsion_mode=JaxRepulsionMode.BUCKET,
        index_size=0.5, additive_weights=additive,
    )
    opts = EmbedderOptions(embedding_dimension=d, additive_weights=additive, index_size=0.5)
    w = jax_weights.initial_weights(g, jopts)
    inv_w = jax_weights.inv_exp_weights(w, d)
    pos = np.random.default_rng(1).normal(size=(n, d)) * 2.0 * np.array([3.0, 1.5])
    pos[5::13] = pos[4::13][: pos[5::13].shape[0]]  # coincident pairs, counted alike

    jidx = jax_candidates.BucketIndex.build(w, jopts, g.edge_src, g.col_idx, span_scale=8.0)
    dg = JaxDeviceGraph.build(g)
    j_args = (jnp.asarray(pos), jnp.asarray(inv_w), jnp.asarray(w))
    key = jax.random.PRNGKey(7)
    structures = jax_candidates.build_structures(*j_args, dg.colors, jidx, jopts, key)
    in_index = np.asarray(structures.in_index)
    assert 0 < in_index.sum() < n
    f_j, rep_j, cnt_j, ovf_j, zc_j = jax_candidates.bucket_repulsion_forces(
        j_args[0], j_args[1], j_args[2], dg, jidx, jopts, key, structures=structures
    )

    idx = span_sparse.SpanIndex.build(w, opts, g.edge_src, g.col_idx, span_scale=8.0)
    assert idx.partial
    # the same strata: the JAX package's bucket sizes and sample sizes
    np.testing.assert_array_equal(
        idx.class_sizes[idx.class_sizes > 0], [b.members.shape[0] for b in jidx.buckets]
    )
    np.testing.assert_array_equal(
        idx.class_take[idx.class_sizes > 0], [b.sample_size for b in jidx.buckets]
    )
    t_args = (torch.tensor(pos), torch.tensor(inv_w), torch.tensor(w), torch.tensor(g.colors))
    f_t, rep_t, cnt_t, ovf_t, zc_t = span_sparse.span_repulsion_forces(
        *t_args, idx, opts, in_index=torch.tensor(in_index)
    )
    assert int(ovf_t) == int(ovf_j) == 0
    assert int(cnt_t) == int(cnt_j) > 0
    np.testing.assert_array_equal(zc_t.numpy(), np.asarray(zc_j))
    assert int(zc_t.sum()) > 0
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-9, atol=1e-9 * np.abs(f_j).max())
    np.testing.assert_allclose(float(rep_t), float(rep_j), rtol=1e-6)

    # the whole index instead: more candidates, so the sample did mask members
    whole = span_sparse.SpanIndex.build(w, EmbedderOptions(embedding_dimension=d, additive_weights=additive),
                                        g.edge_src, g.col_idx, span_scale=8.0)
    assert not whole.partial
    assert int(span_sparse.span_repulsion_forces(*t_args, whole, opts)[2]) > int(cnt_t)


def test_member_draw_is_an_exact_stratified_uniform_sample():
    """Every draw keeps exactly max(1, ceil(n_c / 2)) vertices of each
    doubling class c; over 200 draws each vertex is in the sample a share
    of the time within 4 standard errors of its class's take / size."""
    g = _girg(3000, seed=4)
    opts = EmbedderOptions(embedding_dimension=2, index_size=0.5)
    w = initial_weights(g, opts)
    idx = span_sparse.SpanIndex.build(w, opts, g.edge_src, g.col_idx)
    sizes = idx.class_sizes
    assert (sizes > 0).sum() >= 4
    want = np.where(sizes > 0, np.maximum(1, np.ceil(sizes * 0.5)), 0)
    np.testing.assert_array_equal(idx.class_take, want)
    gen = torch.Generator().manual_seed(11)
    draws = 200
    hits = np.zeros(g.num_vertices)
    for _ in range(draws):
        member = idx.draw_members(gen).numpy()
        np.testing.assert_array_equal(np.bincount(idx.class_of[member], minlength=sizes.shape[0]), want)
        hits += member
    p = (want / np.maximum(sizes, 1))[idx.class_of]
    se = np.sqrt(p * (1 - p) / draws)
    freq = hits / draws
    assert np.all(np.abs(freq - p) <= 4 * se + 1e-12)
    assert abs(freq.mean() - 0.5) < 0.01
    # a whole index draws nothing
    assert span_sparse.SpanIndex.build(w, EmbedderOptions(embedding_dimension=2), g.edge_src,
                                       g.col_idx).draw_members(gen) is None


def _embedder(g, seed, **kw):
    set_seed(seed)
    return WEmbedEmbedder(
        g, EmbedderOptions(embedding_dimension=2, **HALF, **kw), verbose=False, device="cpu"
    )


def test_half_index_embedding_converges():
    g = _girg(150, seed=2)
    emb = _embedder(g, 3)
    assert emb.path == "span" and emb._index.partial
    emb.calculate_embedding()
    assert 0 < emb.iteration < emb.opts.max_iterations
    assert emb.final_overflow == 0
    assert np.isfinite(emb.get_coordinates()).all()
    assert int(emb.state.num_rep_forces) > 0


def test_half_index_resumes_bit_for_bit(tmp_path):
    """A checkpoint holds the generator, so the resumed run draws the same
    member samples and continues bit for bit (f32, the card's type)."""
    g = _girg(300, seed=6)
    saved = _embedder(g, 1)
    for _ in range(6):
        saved.calculate_step()
    path = str(tmp_path / "half.npz")
    save_checkpoint(path, saved)
    resumed = _embedder(g, 2)
    load_checkpoint(path, resumed)
    for _ in range(6):
        saved.calculate_step()
        resumed.calculate_step()
    for name in ("positions", "adam_m", "adam_v", "attract_loss", "repel_loss", "num_rep_forces"):
        assert torch.equal(getattr(saved.state, name), getattr(resumed.state, name)), name
    assert saved.iteration == resumed.iteration == 12
