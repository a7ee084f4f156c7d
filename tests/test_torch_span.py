"""The port's span path module by module against the JAX package's, on the
same inputs: the index skeleton and its window sizing, the per-step
structures, the sweep (plain PyTorch version against the Pallas kernel in
interpret mode), the force passes, the dense oracle in f64, and the growth
protocol's rules."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import candidates as jax_candidates
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.core.state import DeviceGraph as JaxDeviceGraph
from wembed_tpu.graphs import generators as jax_generators
from wembed_tpu.kernels import span_sparse as jax_span

from wembed_tpu_torch.core import EmbedderOptions
from wembed_tpu_torch.core import candidates
from wembed_tpu_torch.kernels import span_sparse, span_sweep
from wembed_tpu_torch.kernels.fused_dense import fused_dense_forces_reference

torch.set_num_threads(1)

ST = span_sparse._ST


class Case:
    """One graph with weights and positions, as arrays for both packages."""

    def __init__(self, n, d, *, additive=False, span_scale=4.0, spread=1.0,
                 isotropic=False, bipartite=False, coincident=False, seed=5):
        g, _, _ = jax_generators.girg(
            n, dim=2, avg_degree=12, ple=2.2, rng=np.random.default_rng(seed)
        )
        if bipartite:
            g = g.with_colors(np.arange(g.num_vertices, dtype=np.int32) % 2)
        self.g, self.n, self.d = g, g.num_vertices, d
        self.jopts = JaxOptions(embedding_dimension=d, additive_weights=additive)
        self.opts = EmbedderOptions(embedding_dimension=d, additive_weights=additive)
        self.w = jax_weights.initial_weights(g, self.jopts)
        self.inv_w = jax_weights.inv_exp_weights(self.w, d)
        # an anisotropic cloud unless asked otherwise: its top eigenvalues are
        # well apart, so 12 power iterations converge and both packages find
        # the same axes to ~1e-7 (see test_structures_of_an_isotropic_cloud)
        stretch = np.ones(d) if isotropic else np.array([3.0, 1.5, 1.0, 1.0])[:d]
        pos = np.random.default_rng(1).normal(size=(self.n, d)) * 2.0 * spread * stretch
        if coincident:
            pos[1::7] = pos[0::7][: pos[1::7].shape[0]]
        self.pos = pos.astype(np.float32)
        self.jidx = jax_span.SpanIndex.build(
            self.w, self.jopts, g.edge_src, g.col_idx, span_scale=span_scale
        )
        self.idx = span_sparse.SpanIndex.build(
            self.w, self.opts, g.edge_src, g.col_idx, span_scale=span_scale
        )

    def jax_args(self):
        return (
            jnp.asarray(self.pos), jnp.asarray(self.inv_w, jnp.float32),
            jnp.asarray(self.w, jnp.float32), JaxDeviceGraph.build(self.g).colors,
        )

    def torch_args(self, dtype=torch.float32):
        return (
            torch.tensor(self.pos, dtype=dtype), torch.tensor(self.inv_w, dtype=dtype),
            torch.tensor(self.w, dtype=dtype), torch.tensor(self.g.colors),
        )


# ------------------------------------------------------------------ index


SHARED_FIELDS = [
    "n", "d", "num_groups", "num_rows", "nb", "row_group", "row_sizes", "row_moff",
    "row_qoff", "row_pad_off", "row_tiles", "bmaxpow", "group_of", "class_bm2",
    "row_of_sorted", "sorted_moff", "sorted_shift_q", "src_of_pad", "blk_first",
    "blk_last", "blk_t", "blk_row", "span_scale",
]


@pytest.mark.parametrize("d,additive", [(2, False), (3, False), (2, True)])
def test_index_build_matches_jax(d, additive):
    c = Case(3000, d, additive=additive)
    for name in SHARED_FIELDS:
        np.testing.assert_array_equal(getattr(c.idx, name), getattr(c.jidx, name), err_msg=name)
    # the port has no dummy query block and no padded edge list
    np.testing.assert_array_equal(c.idx.src_of_q, c.jidx.src_of_q[: c.idx.nq])
    e = c.g.num_directed_edges
    np.testing.assert_array_equal(c.idx.edge_src, c.jidx.edge_src[:e])
    np.testing.assert_array_equal(c.idx.edge_dst, c.jidx.edge_dst[:e])
    np.testing.assert_array_equal(np.sqrt(c.idx.edge_bm2).astype(np.float32), c.jidx.edge_bmaxpow[:e])
    np.testing.assert_array_equal(c.idx.edge_row_ptr[:-1], c.jidx.edge_row_ptr[:-1])
    assert c.idx.edge_row_ptr[-1] == e
    assert c.idx.w == c.jidx.w == int(c.idx.blk_t.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_window_sizing_matches_jax(seed):
    c = Case(3000, 2)
    rng = np.random.default_rng(seed)
    shape = c.idx.blk_t.shape
    # a needs array with zero, small, large and row-capping needs, and
    # windows both above and below them
    needs = rng.choice([0, 1, 100, 300, 700, 5000], size=shape) * (rng.random(shape) < 0.7)
    widths = rng.integers(0, 4, size=shape)
    idx = c.idx._with_blk_t(np.minimum(widths, c.idx.row_tiles[None, :]))
    jidx = c.jidx._with_blk_t(np.minimum(widths, c.jidx.row_tiles[None, :]))
    np.testing.assert_array_equal(idx.blk_t, jidx.blk_t)
    for method, kw in [
        ("grow_from_needs", {}), ("grow_from_needs", dict(headroom=1.5)),
        ("resize_to_needs", {}), ("shrink_to_needs", {}), ("grow_all", {}),
    ]:
        got = getattr(idx, method)(needs, **kw)
        want = getattr(jidx, method)(needs, **kw)
        assert (got is None) == (want is None), method
        if got is not None:
            np.testing.assert_array_equal(got.blk_t, want.blk_t, err_msg=method)
            assert got.w == want.w
            assert got.can_grow() == want.can_grow()
    assert idx.grow_all() is not None and jidx.grow_all() is not None
    np.testing.assert_array_equal(idx.grow_all().blk_t, jidx.grow_all().blk_t)


# ------------------------------------------------------------- structures


def _structures(c: Case):
    s_j = jax_span.build_span_structures(*c.jax_args(), c.jidx, c.jopts)
    s_t = span_sparse.build_span_structures(*c.torch_args(), c.idx, c.opts)
    return s_j, s_t


@pytest.mark.parametrize(
    "kw",
    [dict(d=2), dict(d=3), dict(d=2, additive=True),
     # the starved case of tests/test_kernels.py:225: 1-tile windows, spread positions
     dict(d=2, span_scale=1e-6, spread=100.0)],
)
def test_structures_match_jax(kw):
    c = Case(3000, **kw)
    s_j, s_t = _structures(c)
    p = torch.tensor(c.pos)
    v_t = candidates._principal_axes2(p - p.mean(0))
    pj = jnp.asarray(c.pos)
    v_j = jax_candidates._principal_axes2(pj - jnp.mean(pj, axis=0))
    for a, b in zip(v_t, v_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for name in ("need", "start_tile", "rank_of", "block_of", "slot_of", "row_of"):
        np.testing.assert_array_equal(getattr(s_t, name).numpy(), np.asarray(getattr(s_j, name)), err_msg=name)
    assert int(s_t.overflow) == int(s_j.overflow)
    if kw.get("span_scale") == 1e-6:
        assert int(s_t.overflow) > 0
    # the records are the JAX package's channels in the port's row-major
    # layout; lw = L * w^(1/d) comes from each package's own f32 pow, which
    # differ by up to 1 ulp, so lw^2 by up to 3 ulp (3.6e-7)
    d, nq = c.d, c.idx.nq
    qdata = np.asarray(s_j.qdata).reshape(-1, s_j.qdata.shape[-1])[:nq]
    np.testing.assert_allclose(s_t.qrec.numpy(), qdata[:, : d + 3], rtol=3.6e-7)
    sdata = np.asarray(s_j.sdata).T
    np.testing.assert_allclose(
        s_t.srec.numpy(), sdata[:, [*range(d + 2), d + 3]], rtol=0
    )
    np.testing.assert_array_equal(s_t.qcol.numpy(), np.asarray(s_j.qcol).reshape(-1)[:nq])
    np.testing.assert_array_equal(s_t.scol.numpy(), np.asarray(s_j.scol)[0])


def test_structures_of_an_isotropic_cloud():
    """An isotropic Gaussian cloud has near-equal top eigenvalues, where 12
    power iterations are far from converged and amplify the ~1 ulp
    differences of the two packages' means and covariances (different
    summation orders) into ~1e-5 differences of the axes.  Projected values
    then move by ~1e-4, and the few members whose second-axis neighbour in
    their row is closer than that swap places: 8 of 2968 vertices here.
    Rows, blocks, window placement, needs and overflow stay equal."""
    c = Case(3000, 2, isotropic=True)
    s_j, s_t = _structures(c)
    for name in ("need", "start_tile", "block_of", "row_of"):
        np.testing.assert_array_equal(getattr(s_t, name).numpy(), np.asarray(getattr(s_j, name)), err_msg=name)
    assert int(s_t.overflow) == int(s_j.overflow)
    moved = s_t.rank_of.numpy() != np.asarray(s_j.rank_of)
    assert moved.sum() <= 8
    np.testing.assert_array_equal(moved, s_t.slot_of.numpy() != np.asarray(s_j.slot_of))


# ------------------------------------------------------------------ sweep


def _jax_records(s_j, idx_j, d):
    """The JAX package's kernel inputs in the port's layout."""
    nq = idx_j.nb * jax_span._Q
    q = np.asarray(s_j.qdata).reshape(-1, s_j.qdata.shape[-1])[:nq, : d + 3]
    s = np.asarray(s_j.sdata).T[:, [*range(d + 2), d + 3]]
    return (
        torch.tensor(q), torch.tensor(np.asarray(s_j.qcol).reshape(-1)[:nq]),
        torch.tensor(np.ascontiguousarray(s)), torch.tensor(np.asarray(s_j.scol)[0]),
        torch.tensor(idx_j.blk_t), torch.tensor(np.asarray(s_j.start_tile)),
        torch.tensor((idx_j.row_pad_off // ST).astype(np.int32)),
    )


@pytest.mark.parametrize(
    "kw",
    [dict(d=2), dict(d=3, additive=True), dict(d=2, bipartite=True, coincident=True)],
)
def test_sweep_matches_pallas_kernel(kw):
    c = Case(900, span_scale=8.0, **kw)
    d = c.d
    s_j = jax_span.build_span_structures(*c.jax_args(), c.jidx, c.jopts)
    out = np.asarray(jax_span.span_query(s_j, c.jidx, c.jopts, interpret=True))
    nq = c.jidx.nb * jax_span._Q
    out = out.reshape(-1, out.shape[-1])[:nq]
    q = np.asarray(s_j.qdata).reshape(-1, s_j.qdata.shape[-1])[:nq, :d]
    rowsum = out[:, d]
    force_j = q * rowsum[:, None] - out[:, :d]  # the TPU form, q*rowsum - coeff@S

    force, loss, count, zero = span_sweep.span_sweep_reference(
        *_jax_records(s_j, c.jidx, d), dim=d, L=1.0, rep_scale=1.0,
        additive=c.opts.additive_weights,
    )
    np.testing.assert_array_equal(count.numpy(), out[:, d + 2].astype(np.int32))
    np.testing.assert_array_equal(zero.numpy(), out[:, d + 3].astype(np.int32))
    if kw.get("coincident"):
        assert zero.sum() > 0
    assert count.sum() > 0
    np.testing.assert_allclose(loss.numpy(), out[:, d + 1], rtol=1e-5, atol=1e-5)
    # the TPU form cancels two terms of size |q| * rowsum, so its f32 error
    # is ~eps32 * that; the port sums coeff * (q - s) directly
    real = c.jidx.src_of_q[:nq] < c.n  # padding slots hold the 1e15 sentinel
    bound = 1e-6 * np.abs(q[real]).max() * rowsum.max()
    np.testing.assert_allclose(force.numpy(), force_j, rtol=1e-5, atol=bound)
    assert float(np.abs(force_j).max()) > 100 * bound


def test_sweep_wrapper_runs_the_plain_version_on_the_cpu():
    c = Case(900, 2, span_scale=8.0)
    args, _ = _port_sweep_args(c)
    before = span_sweep.span_sweep.launches
    got = span_sweep.span_sweep(*args, dim=2, L=1.0, rep_scale=1.0, additive=False)
    want = span_sweep.span_sweep_reference(*args, dim=2, L=1.0, rep_scale=1.0, additive=False)
    assert span_sweep.span_sweep.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no span_sweep kernel"):
        span_sweep.span_sweep(*(a.to("meta") for a in args), dim=2, L=1.0, rep_scale=1.0, additive=False)


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda a: (a[0].double(), *a[1:]), TypeError),  # f64 runs only on the CPU
        (lambda a: (a[0][:, :-1].contiguous(), *a[1:]), ValueError),  # record width
        (lambda a: (a[0], torch.stack([a[1], a[1]], 1)[:, 0], *a[2:]), ValueError),  # strided
        (lambda a: (a[0][:-1], a[1][:-1], *a[2:]), ValueError),  # not whole blocks
    ],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    """The checks the CUDA path runs before it launches (they do not depend
    on the device): anything the kernel does not take raises."""
    c = Case(900, 2, span_scale=8.0)
    args, _ = _port_sweep_args(c)
    span_sweep._check(*args, 2)
    with pytest.raises(error):
        span_sweep._check(*change(args), 2)


def _port_sweep_args(c: Case):
    s = span_sparse.build_span_structures(*c.torch_args(), c.idx, c.opts)
    t = c.idx.tensors(torch.device("cpu"))
    return (s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off), s


# ----------------------------------------------------------------- forces


def _mask_kicked_rows(c: Case):
    """Rows with a coincident edge: both packages kick such edges with a
    random unit vector from their own generators, which differ."""
    src, dst = c.g.edge_src, c.g.col_idx
    same = np.all(c.pos[src] == c.pos[dst], axis=1)
    keep = np.ones(c.n, bool)
    keep[src[same]] = False
    return keep


@pytest.mark.parametrize(
    "kw",
    [dict(d=2), dict(d=3), dict(d=2, additive=True), dict(d=2, bipartite=True, coincident=True)],
)
def test_forces_match_jax(kw):
    import jax

    c = Case(900, span_scale=8.0, **kw)
    j_args, t_args = c.jax_args(), c.torch_args()
    f_j, att_j, rep_j, cnt_j, ovf_j, zc_j = jax_span.span_fused_forces(
        *j_args, c.jidx, c.jopts, jax.random.PRNGKey(3), interpret=True
    )
    gen = torch.Generator().manual_seed(3)
    f_t, att_t, rep_t, cnt_t, ovf_t, zc_t = span_sparse.span_fused_forces(
        *t_args, c.idx, c.opts, gen
    )
    assert int(ovf_t) == int(ovf_j) == 0
    assert int(cnt_t) == int(cnt_j) > 0
    np.testing.assert_array_equal(zc_t.numpy(), np.asarray(zc_j))
    if kw.get("coincident"):
        assert int(zc_t.sum()) > 0
    keep = _mask_kicked_rows(c)
    assert keep.mean() > 0.9
    f_j = np.asarray(f_j)
    scale = np.abs(f_j).max()
    # the JAX kernel's q*rowsum - acc form cancels (~eps32 * |q| * rowsum,
    # ~1e-5 of max|force| here) and its edge pass reduces by cumsum and
    # boundary differences; the port sums directly and per segment
    np.testing.assert_allclose(f_t.numpy()[keep], f_j[keep], rtol=1e-4, atol=5e-5 * scale)
    np.testing.assert_allclose(float(att_t), float(att_j), rtol=1e-5)
    np.testing.assert_allclose(float(rep_t), float(rep_j), rtol=1e-4)

    r_j = jax_span.span_repulsion_forces(*j_args, c.jidx, c.jopts, interpret=True)
    r_t = span_sparse.span_repulsion_forces(*t_args, c.idx, c.opts)
    assert int(r_t[2]) == int(r_j[2]) == int(cnt_j)
    assert int(r_t[3]) == int(r_j[3]) == 0
    np.testing.assert_array_equal(r_t[4].numpy(), np.asarray(r_j[4]))
    rf_j = np.asarray(r_j[0])
    np.testing.assert_allclose(r_t[0].numpy(), rf_j, rtol=1e-4, atol=5e-5 * np.abs(rf_j).max())
    np.testing.assert_allclose(float(r_t[1]), float(r_j[1]), rtol=1e-4)


def _dense_f64(c: Case, pos):
    adj = torch.zeros((c.n, c.n), dtype=torch.uint8)
    adj[torch.as_tensor(c.g.edge_src, dtype=torch.int64), torch.as_tensor(c.g.col_idx, dtype=torch.int64)] = 1
    return fused_dense_forces_reference(
        pos, torch.tensor(c.inv_w), torch.tensor(c.g.colors), adj, dim=c.d, L=1.0,
        att_scale=1.0, rep_scale=1.0, additive=c.opts.additive_weights,
    )


@pytest.mark.parametrize(
    "kw", [dict(d=2), dict(d=3), dict(d=2, additive=True), dict(d=2, bipartite=True)]
)
def test_span_forces_equal_the_dense_oracle_in_f64(kw):
    """With no window truncated the span path's active set is the dense
    path's (the radius test is implied by dist * ws <= L), so in f64 the
    forces agree to rounding.  As tests/test_kernels.py:130."""
    c = Case(900, span_scale=8.0, **kw)
    pos = torch.tensor(c.pos, dtype=torch.float64)
    # coincident points that are not neighbours: the two paths count them alike
    src, dst = c.g.edge_src, c.g.col_idx
    nbr = set(zip(src.tolist(), dst.tolist()))
    pairs = [(v, v + 1) for v in range(0, c.n - 1, 9) if (v, v + 1) not in nbr]
    for a, b in pairs:
        pos[b] = pos[a]
    gen = torch.Generator().manual_seed(0)
    f_s, att_s, rep_s, cnt_s, ovf_s, zc_s = span_sparse.span_fused_forces(
        pos, *c.torch_args(torch.float64)[1:], c.idx, c.opts, gen
    )
    f_d, zc_d, att_d, rep_d, _ = _dense_f64(c, pos)
    assert int(ovf_s) == 0
    np.testing.assert_array_equal(zc_s.numpy(), zc_d.numpy())
    assert int(zc_s.sum()) == 2 * len(pairs) > 0
    scale = float(f_d.abs().max())
    np.testing.assert_allclose(f_s.numpy(), f_d.numpy(), rtol=1e-9, atol=1e-9 * scale)
    np.testing.assert_allclose(float(att_s), float(att_d), rtol=1e-9)
    np.testing.assert_allclose(float(rep_s), float(rep_d), rtol=1e-9)


# ------------------------------------------------------------ growth rules


def test_one_regrowth_from_measured_needs_covers():
    """As tests/test_kernels.py:247: starved 1-tile windows at spread
    positions overflow; one growth from the measured needs reaches overflow
    0 and the f64 dense oracle's forces."""
    c = Case(3000, 2, span_scale=1e-6, spread=50.0)
    args = c.torch_args(torch.float64)
    s = span_sparse.build_span_structures(*args, c.idx, c.opts)
    assert int(s.overflow) > 0
    grown = c.idx.grow_from_needs(s.need.numpy())
    assert grown is not None and grown.w > c.idx.w
    s2 = span_sparse.build_span_structures(*args, grown, c.opts)
    assert int(s2.overflow) == 0
    gen = torch.Generator().manual_seed(0)
    f_s, _, _, _, ovf, zc_s = span_sparse.span_fused_forces(*args, grown, c.opts, gen, structures=s2)
    f_d, zc_d, _, _, _ = _dense_f64(c, args[0])
    assert int(ovf) == 0
    np.testing.assert_array_equal(zc_s.numpy(), zc_d.numpy())
    scale = float(f_d.abs().max())
    np.testing.assert_allclose(f_s.numpy(), f_d.numpy(), rtol=1e-9, atol=1e-9 * scale)


def test_shrunk_windows_report_no_phantom_overflow():
    """As tests/test_kernels.py:308: windows of 0 tiles report as overflow
    the true truncated members, not their rank offsets, and growth keeps
    zero-need windows at 0 tiles."""
    c = Case(3000, 2)
    bare = c.idx._with_blk_t(np.zeros_like(c.idx.blk_t))
    s = span_sparse.build_span_structures(*c.torch_args(), bare, c.opts)
    needs = s.need.numpy()
    nonzero = int((needs > 0).sum())
    assert 0 < int(s.overflow) <= int(needs.sum())
    assert int(needs.sum()) - int(s.overflow) < nonzero * ST
    grown = bare.grow_from_needs(needs)
    assert grown is not None
    assert (grown.blk_t[needs == 0] == 0).all()
    assert (grown.blk_t[needs > 0] > 0).all()


def test_shrink_to_needs_reduces_and_stays_exact():
    """As tests/test_kernels.py:463: windows inflated to whole rows at spread
    positions shrink to the measured needs, still cover every candidate
    (the f64 dense oracle's forces), and a second shrink is a no-op."""
    c = Case(2500, 2, span_scale=8.0, spread=25.0, seed=7)
    args = c.torch_args(torch.float64)
    fat = c.idx._with_blk_t(np.broadcast_to(c.idx.row_tiles[None, :], c.idx.blk_t.shape))
    s = span_sparse.build_span_structures(*args, fat, c.opts)
    assert int(s.overflow) == 0
    needs = s.need.numpy()
    shrunk = fat.shrink_to_needs(needs)
    assert shrunk is not None and shrunk.w < fat.w
    gen = torch.Generator().manual_seed(0)
    f_s, _, _, _, ovf, zc_s = span_sparse.span_fused_forces(*args, shrunk, c.opts, gen)
    f_d, zc_d, _, _, _ = _dense_f64(c, args[0])
    assert int(ovf) == 0
    np.testing.assert_array_equal(zc_s.numpy(), zc_d.numpy())
    scale = float(f_d.abs().max())
    np.testing.assert_allclose(f_s.numpy(), f_d.numpy(), rtol=1e-9, atol=1e-9 * scale)
    assert shrunk.shrink_to_needs(needs) is None
