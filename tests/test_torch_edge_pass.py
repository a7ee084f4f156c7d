"""The span edge pass (``kernels/edge_pass.py``) in its three modes against
the JAX package, on the same inputs: attraction against
``core/forces.attraction_forces``; the sweep plus the fused or the
correction pass against ``span_fused_forces`` / ``span_repulsion_forces``
of both layouts (the Pallas sweep in interpret mode) in f32, against the
jnp dense oracle in f64, and with a partial index against the bucket path;
one rank's share of the edges; and the wrapper, which runs the plain
version for CPU tensors, takes rows of any width and rejects what the
CUDA kernel does not take.

The JAX package draws the edges' kicks from its own key; the port's pass
takes its kicks as an argument, so the tests hand it the JAX draw and
compare kicked rows too."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import RepulsionMode as JaxRepulsionMode
from wembed_tpu.core import candidates as jax_candidates
from wembed_tpu.core import forces as jax_forces
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.core.state import DeviceGraph as JaxDeviceGraph
from wembed_tpu.graphs import generators as jax_generators
from wembed_tpu.kernels import span_compact as jax_cells
from wembed_tpu.kernels import span_sparse as jax_span

from wembed_tpu_torch.core import EmbedderOptions
from wembed_tpu_torch.core.forces import edge_share, random_unit_vectors
from wembed_tpu_torch.core.step import Share
from wembed_tpu_torch.core.weights import inv_exp_weights
from wembed_tpu_torch.graphs import from_edges
from wembed_tpu_torch.kernels import edge_pass as ep
from wembed_tpu_torch.kernels import span_compact, span_sparse

torch.set_num_threads(1)

STRETCH = np.array([3.0, 1.5, 1.0, 1.0])  # anisotropic: both packages find the same axes
F32 = dict(rtol=1e-4, atol=5e-5)  # tests/test_torch_span.py:test_forces_match_jax (atol x max|force|)


class Case:
    """A GIRG with weights and positions, as arrays for both packages, and
    both packages' indexes of one layout: windows at span_scale 8, or cells
    grown until no block truncates (both cover every candidate)."""

    def __init__(self, n, d, *, layout="windows", additive=False, bipartite=False, coincident=False, seed=5):
        g, _, _ = jax_generators.girg(n, dim=2, avg_degree=12, ple=2.2, rng=np.random.default_rng(seed))
        if bipartite:
            g = g.with_colors(np.arange(g.num_vertices, dtype=np.int32) % 2)
        self.g, self.n, self.d, self.layout = g, g.num_vertices, d, layout
        self.jopts = JaxOptions(embedding_dimension=d, additive_weights=additive)
        self.opts = EmbedderOptions(embedding_dimension=d, additive_weights=additive)
        self.w = jax_weights.initial_weights(g, self.jopts)
        self.inv_w = jax_weights.inv_exp_weights(self.w, d)
        pos = np.random.default_rng(1).normal(size=(self.n, d)) * 2.0 * STRETCH[:d]
        if coincident:  # every 11th edge's endpoints coincide
            pos[g.col_idx[::11]] = pos[g.edge_src[::11]]
        self.pos = pos
        if layout == "windows":
            self.idx = span_sparse.SpanIndex.build(self.w, self.opts, g.edge_src, g.col_idx, span_scale=8.0)
            self.jidx = jax_span.SpanIndex.build(self.w, self.jopts, g.edge_src, g.col_idx, span_scale=8.0)
            return
        idx = span_compact.CellIndex.build(self.w, self.opts, g.edge_src, g.col_idx)
        for _ in range(8):
            s = idx.structures(*self.torch_args(), self.opts)
            grown = idx.grow_from_needs(s.need.numpy())
            if int(s.overflow) == 0 or grown is None:
                break
            idx = grown
        self.idx = idx
        self.jidx = jax_cells.CellIndex.build(self.w, self.jopts, g.edge_src, g.col_idx)._with_caps(idx.cap_t)

    def torch_args(self, dtype=torch.float32):
        return (
            torch.tensor(self.pos, dtype=dtype), torch.tensor(self.inv_w, dtype=dtype),
            torch.tensor(self.w, dtype=dtype), torch.tensor(self.g.colors),
        )

    def jax_args(self, dtype=jnp.float32):
        return (
            jnp.asarray(self.pos, dtype), jnp.asarray(self.inv_w, dtype),
            jnp.asarray(self.w, dtype), JaxDeviceGraph.build(self.g).colors,
        )

    def jax_kicks(self, key, dtype):
        """The JAX package's draw for these edges, as the port's (E, d)."""
        e = self.g.num_directed_edges
        rows = int(self.jidx.edge_src.shape[0])
        return np.asarray(jax_forces.random_unit_vectors(key, (rows,), self.d, dtype))[:e]


@functools.lru_cache(maxsize=None)
def case(n, d, **kw):
    return Case(n, d, **kw)


def port_pass(c: Case, mode, dtype=torch.float32, kicks=None, share=None, idx=None, in_index=None):
    """The sweep's plain version and ``edge_pass_reference`` over the
    edges of ``share`` (default: all), in the span step's form: (force,
    att_loss, rep_loss, rep_count, zero_count)."""
    idx = idx or c.idx
    pos, inv_w, w, colors = c.torch_args(dtype)
    s = idx.structures(pos, inv_w, w, colors, c.opts, None, in_index)
    force_k, rep_loss, rep_count, zero_k = span_sparse._sweep(s, idx, c.opts)
    t = idx.tensors(torch.device("cpu"))
    lo, hi, row_ptr = edge_share(t.edge_row_ptr, t.edge_src.shape[0], share)
    out = ep.edge_pass_reference(
        mode, pos, inv_w, t.edge_src[lo:hi], t.edge_dst[lo:hi], row_ptr, c.opts,
        kicks=None if kicks is None else torch.tensor(kicks, dtype=dtype)[lo:hi], structures=s,
        colors=colors, bm2=t.edge_bm2[lo:hi], in_index=in_index, force=force_k, zero_count=zero_k,
    )
    return out.force, out.att_loss, rep_loss - out.corr_loss, rep_count - out.corr_count, out.zero_count


def attraction_pass(c: Case, kicks, dtype, share=None):
    pos, inv_w, _, _ = c.torch_args(dtype)
    t = c.idx.tensors(torch.device("cpu"))
    lo, hi, row_ptr = edge_share(t.edge_row_ptr, t.edge_src.shape[0], share)
    return ep.edge_pass_reference(
        "attraction", pos, inv_w, t.edge_src[lo:hi], t.edge_dst[lo:hi], row_ptr, c.opts,
        kicks=torch.tensor(kicks, dtype=dtype)[lo:hi],
    )


def assert_forces(got, want, rtol, atol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol * np.abs(want).max())


# -------------------------------------------------------------- attraction


@pytest.mark.parametrize("d,dtype,additive,coincident", [
    (2, "float64", False, True), (3, "float64", True, False),
    (2, "float32", False, True), (4, "float32", False, False),
])
def test_attraction_matches_jax(d, dtype, additive, coincident):
    """The attraction mode against ``wembed_tpu/core/forces.attraction_forces``
    with the same kicks: f64 within rtol 1e-9 (the JAX package sums the
    loss in f32, hence its 1e-6), f32 within test_forces_match_jax's
    tolerance."""
    c = case(900, d, additive=additive, coincident=coincident)
    key = jax.random.PRNGKey(4)
    jdtype = jnp.float64 if dtype == "float64" else jnp.float32
    tdtype = getattr(torch, dtype)
    dg = JaxDeviceGraph.build(c.g)
    f_j, loss_j = jax_forces.attraction_forces(
        jnp.asarray(c.pos, jdtype), jnp.asarray(c.inv_w, jdtype), dg, c.jopts, key
    )
    kicks = np.asarray(jax_forces.random_unit_vectors(key, (dg.edge_src.shape[0],), d, jdtype))
    out = attraction_pass(c, kicks[: c.g.num_directed_edges], tdtype)
    src, dst = c.g.edge_src, c.g.col_idx
    assert np.all(c.pos[src] == c.pos[dst], axis=1).any() == coincident
    rtol, atol = (1e-9, 1e-9) if dtype == "float64" else (F32["rtol"], F32["atol"])
    assert_forces(out.force.numpy(), f_j, rtol, atol)
    np.testing.assert_allclose(float(out.att_loss), float(loss_j), rtol=1e-6 if dtype == "float64" else 1e-5)
    assert out.zero_count is None and out.corr_loss is None and out.corr_count is None


# --------------------------------------------------------- the span modes


@pytest.mark.parametrize("kw", [
    dict(d=2), dict(d=3), dict(d=2, additive=True), dict(d=2, bipartite=True, coincident=True),
    dict(d=3, layout="cells"), dict(d=4, layout="cells", coincident=True),
])
def test_span_modes_match_jax_f32(kw):
    """The sweep plus the fused pass against ``span_fused_forces`` (windows)
    or ``cell_fused_forces`` (cells), and plus the correction against the
    repulsion-only functions, the Pallas sweep in interpret mode: counts
    and zero counts equal, forces and losses within test_forces_match_jax's
    tolerances (the JAX sweep forms its force as q * rowsum - acc, and its
    edge pass sums by cumsum differences)."""
    n = 1500 if kw.get("layout") == "cells" else 900
    c = case(n, **kw)
    key = jax.random.PRNGKey(3)
    cells = c.layout == "cells"
    fused, repulsion = (
        (jax_cells.cell_fused_forces, jax_cells.cell_repulsion_forces) if cells
        else (jax_span.span_fused_forces, jax_span.span_repulsion_forces)
    )
    j_args = c.jax_args()
    f_j, att_j, rep_j, cnt_j, ovf_j, zc_j = fused(*j_args, c.jidx, c.jopts, key, interpret=True)
    f_t, att_t, rep_t, cnt_t, zc_t = port_pass(c, "fused", kicks=c.jax_kicks(key, jnp.float32))
    assert int(ovf_j) == 0
    assert int(cnt_t) == int(cnt_j) > 0
    np.testing.assert_array_equal(zc_t.numpy(), np.asarray(zc_j))
    assert_forces(f_t.numpy(), f_j, **F32)
    np.testing.assert_allclose(float(att_t), float(att_j), rtol=1e-5)
    np.testing.assert_allclose(float(rep_t), float(rep_j), rtol=2e-4)

    r_j = repulsion(*j_args, c.jidx, c.jopts, interpret=True)
    r_t = port_pass(c, "correction")
    assert r_t[1] is None
    assert int(r_t[3]) == int(r_j[2]) == int(cnt_j)
    np.testing.assert_array_equal(r_t[4].numpy(), np.asarray(r_j[4]))
    assert_forces(r_t[0].numpy(), r_j[0], **F32)
    np.testing.assert_allclose(float(r_t[2]), float(r_j[1]), rtol=2e-4)
    if kw.get("coincident"):  # the sweep counted coincident neighbours, and the pass took them back
        s = c.idx.structures(*c.torch_args(), c.opts)
        assert int(span_sparse._sweep(s, c.idx, c.opts)[3].sum()) > int(zc_t.sum())


def _dense_f64(c: Case, key):
    """The JAX package's jnp passes in f64: attraction (with its kicks) and
    the exact all-pairs repulsion."""
    dg = JaxDeviceGraph.build(c.g)
    pos, inv_w = jnp.asarray(c.pos, jnp.float64), jnp.asarray(c.inv_w, jnp.float64)
    f_a, loss_a = jax_forces.attraction_forces(pos, inv_w, dg, c.jopts, key)
    f_r, loss_r, count_r, zero_r = jax_forces.dense_repulsion_forces(
        pos, inv_w, jax_forces.build_dense_adjacency(dg), dg.colors, c.jopts
    )
    kicks = np.asarray(jax_forces.random_unit_vectors(key, (dg.edge_src.shape[0],), c.d, jnp.float64))
    return np.asarray(f_a), float(loss_a), np.asarray(f_r), float(loss_r), np.asarray(zero_r), kicks


@pytest.mark.parametrize("kw", [
    dict(d=2, coincident=True), dict(d=3, additive=True), dict(d=2, bipartite=True),
    dict(d=3, layout="cells", coincident=True),
])
def test_span_modes_match_the_dense_oracle_f64(kw):
    """In f64 with no window truncated, sweep plus correction is the JAX
    package's exact all-pairs repulsion, and sweep plus fused pass that
    plus its attraction, within rtol 1e-9; zero counts equal (coincident
    neighbours counted by the sweep are taken back).  The JAX package sums
    its losses in f32, hence their 1e-6."""
    n = 1500 if kw.get("layout") == "cells" else 900
    c = case(n, **kw)
    key = jax.random.PRNGKey(6)
    f_a, loss_a, f_r, loss_r, zero_r, kicks = _dense_f64(c, key)
    kicks = kicks[: c.g.num_directed_edges]
    f, _, rep, _, zc = port_pass(c, "correction", torch.float64)
    np.testing.assert_array_equal(zc.numpy(), zero_r)
    assert_forces(f.numpy(), f_r, 1e-9, 1e-9)
    np.testing.assert_allclose(float(rep), loss_r, rtol=1e-6)
    f, att, rep, _, zc = port_pass(c, "fused", torch.float64, kicks=kicks)
    np.testing.assert_array_equal(zc.numpy(), zero_r)
    assert_forces(f.numpy(), f_a + f_r, 1e-9, 1e-9)
    np.testing.assert_allclose(float(att), loss_a, rtol=1e-6)
    np.testing.assert_allclose(float(rep), loss_r, rtol=1e-6)
    if kw.get("coincident"):
        src, dst = c.g.edge_src, c.g.col_idx
        assert np.all(c.pos[src] == c.pos[dst], axis=1).any()


def test_partial_index_matches_the_jax_bucket_path():
    """Under a partial index (``index_size=0.5``) the pass tests dst's
    membership: fed the JAX bucket path's member sample, the sweep plus
    the correction is its repulsion in f64 within rtol 1e-9, and the
    sweep plus the fused pass that plus the JAX attraction; counts and
    zero counts equal.  As tests/test_torch_partial_index.py."""
    c = case(900, 2, coincident=True)
    half = EmbedderOptions(embedding_dimension=2, index_size=0.5)
    idx = span_sparse.SpanIndex.build(c.w, half, c.g.edge_src, c.g.col_idx, span_scale=8.0)
    assert idx.partial
    jopts = JaxOptions(embedding_dimension=2, dtype="float64", repulsion_mode=JaxRepulsionMode.BUCKET,
                       index_size=0.5)
    jidx = jax_candidates.BucketIndex.build(c.w, jopts, c.g.edge_src, c.g.col_idx, span_scale=8.0)
    dg = JaxDeviceGraph.build(c.g)
    pos, inv_w, w = jnp.asarray(c.pos), jnp.asarray(c.inv_w), jnp.asarray(c.w)
    key = jax.random.PRNGKey(7)
    structures = jax_candidates.build_structures(pos, inv_w, w, dg.colors, jidx, jopts, key)
    f_r, rep_r, cnt_r, ovf_r, zc_r = jax_candidates.bucket_repulsion_forces(
        pos, inv_w, w, dg, jidx, jopts, key, structures=structures
    )
    f_a, loss_a = jax_forces.attraction_forces(pos, inv_w, dg, jopts, key)
    kicks = np.asarray(jax_forces.random_unit_vectors(key, (dg.edge_src.shape[0],), 2, jnp.float64))
    in_index = torch.tensor(np.asarray(structures.in_index))
    assert 0 < int(in_index.sum()) < c.n

    f, _, rep, cnt, zc = port_pass(c, "correction", torch.float64, idx=idx, in_index=in_index)
    assert int(ovf_r) == 0 and int(cnt) == int(cnt_r) > 0
    np.testing.assert_array_equal(zc.numpy(), np.asarray(zc_r))
    assert_forces(f.numpy(), f_r, 1e-9, 1e-9)
    np.testing.assert_allclose(float(rep), float(rep_r), rtol=1e-6)
    f, att, rep, cnt, zc = port_pass(c, "fused", torch.float64, kicks=kicks[: c.g.num_directed_edges],
                                     idx=idx, in_index=in_index)
    assert int(cnt) == int(cnt_r)
    np.testing.assert_array_equal(zc.numpy(), np.asarray(zc_r))
    assert_forces(f.numpy(), np.asarray(f_a) + np.asarray(f_r), 1e-9, 1e-9)
    np.testing.assert_allclose(float(att), float(loss_a), rtol=1e-6)


# ------------------------------------------------------------------ shares


@pytest.mark.parametrize("mode", ep.MODES)
def test_shares_add_up_to_the_whole_pass(mode):
    """Three ranks' shares of the edges (``core/step.py:Share``, each
    rank's segments clipped to its range) add up to the whole pass in f64
    within rtol 1e-9, counts exactly; the kicks are drawn whole and sliced.
    The whole pass is the one held against the JAX package above."""
    c = case(900, 2, coincident=True)
    kicks = c.jax_kicks(jax.random.PRNGKey(2), jnp.float64)
    parts = []
    for rank in range(3):
        share = Share(rank, 3, None)
        if mode == "attraction":
            out = attraction_pass(c, kicks, torch.float64, share)
            parts.append((out.force, out.att_loss))
        else:
            parts.append(port_pass(c, mode, torch.float64, kicks=kicks, share=share))
    if mode == "attraction":
        whole = attraction_pass(c, kicks, torch.float64)
        assert_forces(sum(p[0] for p in parts).numpy(), whole.force.numpy(), 1e-9, 1e-9)
        np.testing.assert_allclose(float(sum(p[1] for p in parts)), float(whole.att_loss), rtol=1e-9)
        return
    whole = port_pass(c, mode, torch.float64, kicks=kicks)
    # each rank's partial holds the whole sweep: take two of the three back
    s = c.idx.structures(*c.torch_args(torch.float64), c.opts)
    force_k, rep_k, count_k, zero_k = span_sparse._sweep(s, c.idx, c.opts)
    force = sum(p[0] for p in parts) - 2 * force_k
    assert_forces(force.numpy(), whole[0].numpy(), 1e-9, 1e-9)
    assert int(sum(p[3] for p in parts) - 2 * count_k) == int(whole[3])
    assert torch.equal(sum(p[4] for p in parts) - 2 * zero_k, whole[4])
    np.testing.assert_allclose(float(sum(p[2] for p in parts) - 2 * rep_k), float(whole[2]), rtol=1e-9)
    if mode == "fused":
        np.testing.assert_allclose(float(sum(p[1] for p in parts)), float(whole[1]), rtol=1e-9)


# ----------------------------------------------------------------- wrapper


def _wrapper_inputs(mode, dtype=torch.float32):
    c = case(900, 2, coincident=True)
    pos, inv_w, w, colors = c.torch_args(dtype)
    s = c.idx.structures(pos, inv_w, w, colors, c.opts)
    force_k, _, _, zero_k = span_sparse._sweep(s, c.idx, c.opts)
    t = c.idx.tensors(torch.device("cpu"))
    kicks = torch.tensor(c.jax_kicks(jax.random.PRNGKey(1), jnp.float32), dtype=dtype)
    args = [pos, inv_w, t.edge_src, t.edge_dst, t.edge_row_ptr, c.opts]
    kw = dict(kicks=kicks)
    if mode != "attraction":
        kw.update(structures=s, colors=colors, bm2=t.edge_bm2, force=force_k, zero_count=zero_k)
    return args, kw


@pytest.mark.parametrize("mode", ep.MODES)
def test_wrapper_runs_the_plain_version_on_the_cpu(mode):
    """CPU tensors go through ``edge_pass_reference``: the same results bit
    for bit, and no kernel launch counted."""
    args, kw = _wrapper_inputs(mode)
    before = ep.edge_pass.launches
    got = ep.edge_pass(mode, *args, **kw)
    want = ep.edge_pass_reference(mode, *args, **kw)
    assert ep.edge_pass.launches == before
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert (got.zero_count is None) == (mode == "attraction")


def _wide_inputs(mode, d):
    """A random graph of 200 vertices whose vertex 0 has 60 more edges (more
    than one thread of the kernel folds alone) at dimension ``d``, in f64,
    at distances around the edge length, with the plain sweep's force and
    counts over its windows."""
    rng = np.random.default_rng(d)
    n = 200
    hub = np.stack([np.zeros(60, np.int64), rng.choice(np.arange(1, n), 60, replace=False)], 1)
    g = from_edges(np.r_[rng.integers(0, n, size=(4 * n, 2)), hub], num_vertices=n)
    w = rng.pareto(2.0, n) + 1.0
    opts = EmbedderOptions(embedding_dimension=d)
    idx = span_sparse.SpanIndex.build(w, opts, g.edge_src, g.col_idx)
    pos = torch.tensor(rng.uniform(0.0, np.sqrt(6.0 / d), size=(n, d)))
    inv_w, colors = torch.tensor(inv_exp_weights(w, d)), torch.arange(n, dtype=torch.int32)
    t = idx.tensors(torch.device("cpu"))
    kicks = random_unit_vectors(torch.Generator().manual_seed(7), t.edge_src.shape[0], d, torch.float64)
    args = [pos, inv_w, t.edge_src, t.edge_dst, t.edge_row_ptr, opts]
    kw = dict(kicks=kicks)
    if mode != "attraction":
        s = idx.structures(pos, inv_w, torch.tensor(w), colors, opts)
        force_k, _, _, zero_k = span_sparse._sweep(s, idx, opts)
        kw.update(structures=s, colors=colors, bm2=t.edge_bm2, force=force_k, zero_count=zero_k)
    return args, kw


@pytest.mark.parametrize("mode", ep.MODES)
@pytest.mark.parametrize("d", [300, 2100])
def test_wrapper_takes_rows_of_any_width(mode, d):
    """Rows wider than a CTA of the kernel (256 threads) and than its
    staging buffer (2048 values), with a vertex of more edges than one
    thread folds alone: the wrapper takes them and gives the plain
    version's results, and vertex 0's attraction row is the f64 sum of its
    edges' pulls within rtol 1e-12."""
    args, kw = _wide_inputs(mode, d)
    got = ep.edge_pass(mode, *args, **kw)
    want = ep.edge_pass_reference(mode, *args, **kw)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert bool(torch.isfinite(got.force).all())
    if mode != "attraction":
        return
    pos, inv_w, src, dst, row_ptr, opts = (a.numpy() if torch.is_tensor(a) else a for a in args)
    hub = slice(row_ptr[0], row_ptr[1])
    assert hub.stop - hub.start > 32
    diff = pos[dst[hub]] - pos[0]
    dist = np.sqrt((diff * diff).sum(axis=1))
    ws = inv_w[0] * inv_w[dst[hub]]
    coeff = np.where(dist * ws > opts.edge_length, opts.attraction_scale * ws / dist, 0.0)
    assert 0 < np.count_nonzero(coeff) < coeff.shape[0]
    np.testing.assert_allclose(got.force[0].numpy(), (coeff[:, None] * diff).sum(axis=0), rtol=1e-12)


@pytest.mark.parametrize("mode,change,error", [
    ("sideways", {}, ValueError),
    ("fused", {"positions": lambda t: t.to(torch.float16)}, TypeError),
    ("fused", {"src": lambda t: t.to(torch.int32)}, TypeError),
    ("correction", {"row_ptr": lambda t: t[:-1]}, ValueError),
    ("fused", {"kicks": lambda t: None}, ValueError),
    ("attraction", {"kicks": lambda t: t[:, :1]}, ValueError),
    ("correction", {"structures": lambda t: None}, ValueError),
    ("fused", {"colors": lambda t: t.to(torch.int64)}, TypeError),
    ("correction", {"force": lambda t: t.t().contiguous().t()}, ValueError),
    ("attraction", {"device": "meta"}, ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(mode, change, error):
    """On either device the wrapper checks modes, dtypes, shapes,
    contiguity, the mode's inputs and the device before it runs anything;
    a device other than the CPU or a CUDA card has no kernel."""
    args, kw = _wrapper_inputs("fused" if mode == "sideways" else mode)
    names = ["positions", "inv_w", "src", "dst", "row_ptr"]
    for name, fn in change.items():
        if name == "device":  # every input there: only the kernel is missing
            args[:5] = [a.to(fn) for a in args[:5]]
            kw = {k: v.to(fn) for k, v in kw.items()}
        elif name in names:
            args[names.index(name)] = fn(args[names.index(name)])
        else:
            kw[name] = fn(kw[name])
    with pytest.raises(error):
        ep.edge_pass(mode, *args, **kw)
