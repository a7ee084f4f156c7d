"""The plain versions of the hand kernels at dimensions the fast kernels do
not take (d = 16 and 33), where the card runs the general kernels, and in
f64: held against the JAX package's Pallas kernel (interpret mode, f32),
its jnp dense path (f64), and the span twin against the dense oracle
(f64).  Also the dense row range, and flat embeddings at d = 16 and in f64
converging on the CPU."""

import os

import numpy as np
import pytest
import torch

from test_torch_embedder import _assert_same_step, _graphs, _jax, _no_coincident_pairs, _port
from test_torch_fused_dense import _bits, _brute_force_f64, _inputs, _pallas

from wembed_tpu.core import RepulsionMode as JaxRepulsionMode
from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder
from wembed_tpu_torch.core.weights import initial_weights, inv_exp_weights
from wembed_tpu_torch.graphs import generators, io
from wembed_tpu_torch.kernels import fused_dense, span_sparse, span_sweep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(L=1.0, att_scale=1.0, rep_scale=1.0)


@pytest.mark.parametrize("n,d,coincident", [(300, 16, False), (300, 33, False), (1000, 16, True)])
def test_plain_dense_matches_pallas_kernel_at_large_d(n, d, coincident):
    """The Pallas kernel pads d to DPAD = 128, so it runs d = 16 and 33 as
    it runs d = 2: the same masks and counts, forces within the tolerance
    of tests/test_torch_fused_dense.py (its q * rowsum - coeff @ P form
    cancels)."""
    pos, invw, colors, adj = _inputs(n, d, coincident=coincident, seed=d)
    pos *= 0.3  # in the init cube, pairs at these d are beyond the dead zone
    f_j, z_j, att_j, rep_j, cnt_j = _pallas(pos, invw, colors, adj, False)
    f_t, z_t, att_t, rep_t, cnt_t = fused_dense.fused_dense_forces(
        torch.from_numpy(pos), torch.from_numpy(invw), torch.from_numpy(colors), _bits(adj),
        dim=d, additive=False, **KW,
    )
    assert int(cnt_t) == cnt_j > 0
    np.testing.assert_array_equal(z_t.numpy(), z_j.astype(np.int32))
    if coincident:
        assert int(z_t.sum()) > 0
    scale = float(np.abs(pos).max()) * _brute_force_f64(pos, invw, colors, adj, False)[2]
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(float(att_t), att_j, rtol=1e-5)
    np.testing.assert_allclose(float(rep_t), rep_j, rtol=1e-5)


@pytest.mark.parametrize("d", [16, 33])
def test_f64_trajectory_matches_jax_dense_path_at_large_d(d):
    """The port's dense step (the fused pass's plain version) against the
    JAX package's jnp dense path in f64 at d = 16 and 33, step by step
    while no coincident kick fires."""
    g_j, g_t, coords, w = _graphs(d)
    coords = coords * 0.3  # closer than the init cube, so that pairs repel
    kw = dict(embedding_dimension=d, dtype="float64")
    emb_j = _jax(g_j, coords, w, repulsion_mode=JaxRepulsionMode.DENSE, **kw)
    emb_t = _port(g_t, coords, w, **kw)
    assert emb_t.path == "dense"
    for _ in range(5):
        assert _no_coincident_pairs(emb_t)
        emb_j.calculate_step()
        emb_t.calculate_step()
        _assert_same_step(emb_t, emb_j, rtol=1e-9)
        if emb_t.iteration == 1:
            assert int(emb_t.state.num_rep_forces) > 0


def _span_case(n, d, seed):
    """A GIRG with degree weights at spread positions, and a span index of
    wide windows grown until none truncates (f64 tensors)."""
    rng = np.random.default_rng(seed)
    g, _, _ = generators.girg(n, dim=2, avg_degree=12, ple=2.2, rng=rng)
    n = g.num_vertices
    opts = EmbedderOptions(embedding_dimension=d)
    w = initial_weights(g, opts)
    pos = torch.tensor(rng.normal(size=(n, d)) * 0.05 * np.linspace(3.0, 1.0, d))
    args = (pos, torch.tensor(inv_exp_weights(w, d)), torch.tensor(w), torch.tensor(g.colors))
    idx = span_sparse.SpanIndex.build(w, opts, g.edge_src, g.col_idx, span_scale=8.0)
    for _ in range(6):
        s = span_sparse.build_span_structures(*args, idx, opts)
        grown = idx.grow_from_needs(s.need.numpy())
        if int(s.overflow) == 0 or grown is None:
            break
        idx = grown
    return g, opts, args, idx


@pytest.mark.parametrize("d", [16, 33])
def test_span_twin_equals_the_dense_oracle_in_f64_at_large_d(d):
    """As tests/test_torch_span.py::test_span_forces_equal_the_dense_oracle_in_f64,
    at the dimensions of the general kernels: with no window truncated the
    span path's active set is the dense path's, so in f64 the forces agree
    to rounding, and the coincident counts exactly."""
    g, opts, args, idx = _span_case(900, d, seed=d)
    pos = args[0]
    nbr = set(zip(g.edge_src.tolist(), g.col_idx.tolist()))
    pairs = [(v, v + 1) for v in range(0, g.num_vertices - 1, 11) if (v, v + 1) not in nbr]
    for a, b in pairs:
        pos[b] = pos[a]
    gen = torch.Generator().manual_seed(0)
    f_s, att_s, rep_s, _, ovf_s, zc_s = span_sparse.span_fused_forces(*args, idx, opts, gen)
    adj = fused_dense.adjacency_bits(torch.as_tensor(g.edge_src), torch.as_tensor(g.col_idx), g.num_vertices)
    f_d, zc_d, att_d, rep_d, _ = fused_dense.fused_dense_forces_reference(
        pos, args[1], args[3], adj, dim=d, additive=False, **KW
    )
    assert int(ovf_s) == 0
    np.testing.assert_array_equal(zc_s.numpy(), zc_d.numpy())
    assert int(zc_s.sum()) == 2 * len(pairs) > 0
    assert float(rep_d) > 0
    scale = float(f_d.abs().max())
    np.testing.assert_allclose(f_s.numpy(), f_d.numpy(), rtol=1e-9, atol=1e-9 * scale)
    np.testing.assert_allclose(float(att_s), float(att_d), rtol=1e-9)
    np.testing.assert_allclose(float(rep_s), float(rep_d), rtol=1e-9)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 2), (torch.float64, 16)])
def test_a_row_range_is_those_rows_of_the_whole_pass(dtype, d):
    """Rows [r0, r1) of the plain version are those rows of the whole call,
    bit for bit (each row is summed on its own), and the ranges of a cut
    add up to the whole pass's count and losses."""
    pos, invw, colors, adj = _inputs(1500, d, coincident=True, seed=7)
    args = (torch.from_numpy(pos).to(dtype), torch.from_numpy(invw).to(dtype),
            torch.from_numpy(colors), _bits(adj))
    kw = dict(dim=d, additive=False, **KW)
    whole = fused_dense.fused_dense_forces(*args, **kw)
    cuts = [(0, 433), (433, 1100), (1100, 1100), (1100, 1500)]
    parts = [fused_dense.fused_dense_forces(*args, **kw, rows=r) for r in cuts]
    for (r0, r1), part in zip(cuts, parts):
        assert part[0].shape == (r1 - r0, d) and part[0].dtype == dtype
        assert torch.equal(part[0], whole[0][r0:r1])
        assert torch.equal(part[1], whole[1][r0:r1])
    assert sum(int(p[4]) for p in parts) == int(whole[4]) > 0
    for k in (2, 3):
        np.testing.assert_allclose(sum(float(p[k]) for p in parts), float(whole[k]), rtol=1e-6)
    with pytest.raises(ValueError, match="row range"):
        fused_dense.fused_dense_forces(*args, **kw, rows=(10, 1501))


def test_the_kernel_checks_take_f64_and_refuse_mixed_types():
    """The CUDA path's checks (they do not depend on the device): f32 or
    f64 at any d, one floating type for every floating input."""
    pos, invw, colors, adj = _inputs(100, 16, seed=1)
    p, iw, c, a = torch.from_numpy(pos), torch.from_numpy(invw), torch.from_numpy(colors), _bits(adj)
    fused_dense._check(p, iw, c, a, 16)
    fused_dense._check(p.double(), iw.double(), c, a, 16)
    with pytest.raises(TypeError):
        fused_dense._check(p.double(), iw, c, a, 16)
    with pytest.raises(TypeError):
        fused_dense._check(p.half(), iw.half(), c, a, 16)


@pytest.mark.parametrize("dtype,d", [("float32", 16), ("float64", 2), ("float64", 16)])
def test_flat_embedding_converges_at_large_d_and_in_f64(dtype, d):
    graph = io.read_edge_list(os.path.join(REPO, "assets", "small_graph.edg"))
    emb = WEmbedEmbedder(
        graph, EmbedderOptions(embedding_dimension=d, dtype=dtype), verbose=False, device="cpu"
    )
    emb.calculate_embedding()
    assert 0 < emb.iteration < emb.opts.max_iterations
    assert emb.state.positions.dtype == getattr(torch, dtype)
    assert np.isfinite(emb.get_coordinates()).all()
    assert emb.get_coordinates().shape == (graph.num_vertices, d)


def test_span_sweep_plain_version_at_large_d_splits_like_the_kernel():
    """The sweep's plain version at d = 33 in f64 through work items of at
    most 2 tiles, and through two contiguous slices of them (two ranks'
    shares): the slices add up to the whole, counts exactly."""
    g, opts, args, idx = _span_case(1500, 33, seed=3)
    s = span_sparse.build_span_structures(*args, idx, opts)
    t = idx.tensors(torch.device("cpu"))
    sweep_args = (s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off)
    kw = dict(dim=33, L=1.0, rep_scale=1.0, additive=False)
    items = torch.tensor(span_sweep.work_items(idx.blk_t, 2))
    whole = span_sweep.span_sweep(*sweep_args, **kw, items=items)
    half = items.shape[0] // 2
    a = span_sweep.span_sweep(*sweep_args, **kw, items=items[:half])
    b = span_sweep.span_sweep(*sweep_args, **kw, items=items[half:])
    assert torch.equal(a[2] + b[2], whole[2]) and torch.equal(a[3] + b[3], whole[3])
    assert int(whole[2].sum()) > 0
    scale = float(whole[0].abs().max())
    np.testing.assert_allclose((a[0] + b[0]).numpy(), whole[0].numpy(), rtol=1e-12, atol=1e-12 * scale)
