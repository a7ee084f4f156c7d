"""The span structures build's kernels (``kernels/span_build.py``) through
their plain versions, against the JAX package on the same inputs: the
principal axes against ``_principal_axes2`` / ``_principal_axes3`` (f64 to
1e-12, f32 to 1e-6, degenerate clouds included), and the restructured
build of both span layouts in f64 against the JAX package's build (the
integer outputs equal, the records to 1e-12), with and without a member
sample and given windows; the wrappers' CPU route, their checks, their
launch counters and the cached radius factors."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import candidates as jax_candidates
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.core.state import DeviceGraph as JaxDeviceGraph
from wembed_tpu.graphs import generators as jax_generators
from wembed_tpu.kernels import span_compact as jax_cells
from wembed_tpu.kernels import span_sparse as jax_span

from wembed_tpu_torch import kernels
from wembed_tpu_torch.core import EmbedderOptions
from wembed_tpu_torch.core import candidates
from wembed_tpu_torch.kernels import span_build, span_compact, span_sparse

torch.set_num_threads(1)

F64 = torch.float64
Q = span_sparse._Q


# ------------------------------------------------------------- principal axes


def _cloud(n: int, d: int, seed: int) -> np.ndarray:
    """Centred rows of an anisotropic Gaussian cloud in a random basis: each
    axis 0.7 times the spread of the one before, so consecutive eigenvalues
    stand ~2x apart (12 power iterations converge to ~2e-4) and the third
    axis is at most ~4x below the first (its f32 deflation residue small)."""
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.normal(size=(d, d)))
    x = (rng.normal(size=(n, d)) * 3.0 * 0.7 ** np.arange(d)) @ basis.T
    return x - x.mean(axis=0)


def _jax_axes(x: np.ndarray, k: int):
    fn = jax_candidates._principal_axes2 if k == 2 else jax_candidates._principal_axes3
    return [np.asarray(v) for v in fn(jnp.asarray(x))]


def _port_axes(x: np.ndarray, k: int):
    fn = candidates._principal_axes2 if k == 2 else candidates._principal_axes3
    return [v.numpy() for v in fn(torch.tensor(x))]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d,k", [(1, 2), (2, 2), (3, 2), (4, 2), (9, 2), (1, 3), (2, 3), (3, 3), (4, 3), (9, 3)])
def test_principal_axes_match_jax(d, k, dtype):
    """The plain version folds every product and norm in ascending k where
    the JAX package takes XLA's dots: f64 agrees to 1e-12, f32 to 1e-6.
    At d < k the last axis is what the deflation leaves of rounding: at
    most 1e-12 in f64 in both packages, and in f32 (where the residue
    passes the 1e-12 test) a unit vector of noise, so only the leading
    axes are compared there."""
    x = _cloud(2000, d, seed=10 + d).astype(dtype)
    got, want = _port_axes(x, k), _jax_axes(x, k)
    assert all(v.dtype == dtype and v.shape == (d,) for v in got)
    tol = 1e-12 if dtype == np.float64 else 1e-6
    compared = k if (d >= k or dtype == np.float64) else d
    for a, b in zip(got[:compared], want[:compared]):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    for i in range(min(d, k)):  # the real axes are unit vectors, each orthogonal to the others
        assert abs(np.linalg.norm(got[i].astype(np.float64)) - 1.0) < 10 * tol
        for j in range(i):
            assert abs(float(got[i].astype(np.float64) @ got[j])) < 10 * tol
    if d < k and dtype == np.float64:
        assert np.abs(got[-1]).max() <= 1e-12


@pytest.mark.parametrize("k", [2, 3])
def test_principal_axes_of_degenerate_clouds(k):
    """Where an iterate or an axis vanishes the norm rules decide: every
    point equal (a zero covariance: each iteration keeps the normalised
    start, and the second axis is the rounding left of it, at most 1e-12,
    left unnormalised), and points on a coordinate axis (v1 that axis
    exactly, the deflated covariance exactly zero, v2 the start with its
    first coordinate taken off, normalised), both as the JAX package
    computes them; points on a skew line give v1 the line and later axes
    unit vectors orthogonal to it."""
    d = 3
    same = np.zeros((500, d))  # every point equal, centred
    got, want = _port_axes(same, k), _jax_axes(same, k)
    start = (1.0 + np.arange(d) * 1e-3) / np.linalg.norm(1.0 + np.arange(d) * 1e-3)
    np.testing.assert_allclose(got[0], start, rtol=1e-15, atol=0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert all(np.abs(v).max() <= 1e-12 for v in got[1:])

    t = np.random.default_rng(3).normal(size=500) * 4.0
    on_axis = np.zeros((500, d))
    on_axis[:, 0] = t - t.mean()
    got, want = _port_axes(on_axis, k), _jax_axes(on_axis, k)
    assert np.array_equal(got[0], [1.0, 0.0, 0.0])
    assert got[1][0] == 0.0 and abs(np.linalg.norm(got[1]) - 1.0) < 1e-15
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)

    u = np.array([1.0, 2.0, 2.0]) / 3.0
    line = (t - t.mean())[:, None] * u[None, :]
    got, want = _port_axes(line, k), _jax_axes(line, k)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.abs(got[0]), u, rtol=1e-12)
    for v in got[1:]:
        assert np.all(np.isfinite(v))
        assert abs(float(v @ got[0])) < 1e-12
        assert abs(np.linalg.norm(v) - 1.0) < 1e-12 or np.abs(v).max() <= 1e-12


def test_axes_plain_version_folds_in_ascending_order():
    """The plain version's products are the ones the kernel folds: w_i =
    sum_k c[i, k] v[k] left to right, the norm the sqrt of a left fold of
    squares, so one power step is reproduced by a Python loop of
    separately rounded f32 operations."""
    x = _cloud(300, 5, seed=4)
    c = torch.tensor(x.T @ x, dtype=torch.float32)
    v = torch.linspace(1.0, 2.0, 5, dtype=torch.float32)
    w = span_build._matvec(c, v)
    cn, vn, wn = c.numpy(), v.numpy(), w.numpy()
    for i in range(5):
        s = cn[i, 0] * vn[0]
        for k in range(1, 5):
            s = s + cn[i, k] * vn[k]
        assert s.dtype == np.float32 and wn[i] == s
    acc = wn[0] * wn[0]
    for k in range(1, 5):
        acc = acc + wn[k] * wn[k]
    assert span_build._fold(w, w).item() == acc


# ---------------------------------------------------------- the whole build


class Case:
    """A GIRG with initial weights and positions whose values are f32 (so
    the JAX package's f32 build and the port's f64 build read the same
    numbers), as arrays for both packages, with both layouts' indexes.
    The graphs and positions are those of ``tests/test_torch_span.py``'s
    and ``tests/test_torch_cells.py``'s cases: anisotropic clouds whose
    projections have no pair closer than the JAX package's f32 build
    resolves, so its order is the f64 order."""

    def __init__(self, n: int, d: int, *, seed: int = 5, stretch=(3.0, 1.5, 1.0, 1.0)):
        g, _, _ = jax_generators.girg(n, dim=2, avg_degree=12, ple=2.2, rng=np.random.default_rng(seed))
        self.g, self.n, self.d = g, g.num_vertices, d
        self.jopts = JaxOptions(embedding_dimension=d)
        self.opts = EmbedderOptions(embedding_dimension=d)
        self.w = jax_weights.initial_weights(g, self.jopts).astype(np.float32)
        self.inv_w = jax_weights.inv_exp_weights(self.w, d).astype(np.float32)
        self.pos = (np.random.default_rng(1).normal(size=(self.n, d)) * 2.0 * np.asarray(stretch)[:d]).astype(
            np.float32)
        self.idx = span_sparse.SpanIndex.build(self.w, self.opts, g.edge_src, g.col_idx, span_scale=4.0)
        self.jidx = jax_span.SpanIndex.build(self.w, self.jopts, g.edge_src, g.col_idx, span_scale=4.0)

    def jax_args(self):
        return (jnp.asarray(self.pos), jnp.asarray(self.inv_w), jnp.asarray(self.w),
                JaxDeviceGraph.build(self.g).colors)

    def torch_args(self, dtype=F64):
        return (torch.tensor(self.pos, dtype=dtype), torch.tensor(self.inv_w, dtype=dtype),
                torch.tensor(self.w, dtype=dtype), torch.tensor(self.g.colors))

    def query_rows(self, slot_of: np.ndarray, nq: int) -> np.ndarray:
        """The query records in f64 from the inputs, each vertex at its
        query slot, sentinels elsewhere."""
        d, L = self.d, float(self.opts.edge_length)
        iw = self.inv_w.astype(np.float64)
        lw = L * np.power(self.w.astype(np.float64), 1.0 / d)
        rows = np.zeros((nq, d + 3))
        rows[:, :d], rows[:, d] = 1e15, 1.0
        rows[slot_of] = np.concatenate(
            [self.pos.astype(np.float64), iw[:, None], (lw * lw)[:, None], (1.0 / iw)[:, None]], axis=1)
        return rows


@functools.lru_cache(maxsize=None)
def case(d: int) -> Case:
    return Case(3000, d)


def _assert_records(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("windows", ["index", "given"])
def test_windows_build_matches_jax_in_f64(d, sampled, windows):
    """The port's build in f64 (axes, records and windows through their
    plain versions) against the JAX package's f32 build on the same
    f32-valued inputs: start tiles, needs, overflow, the four inverse
    maps and the colours equal; the records to 1e-12 of the f64 values
    they gather (the JAX order's).  ``sampled``: a member sample, whose
    non-members get the member sentinel and a zero radius factor (the JAX
    build has no sample: the rest is unchanged); ``given``: windows of
    at most one tile handed to the build (the index's are wider), which
    truncate."""
    c = case(d)
    idx, jidx, blk_t = c.idx, c.jidx, None
    if windows == "given":
        narrow = np.minimum(c.idx.blk_t, 1)
        jidx = jidx._with_blk_t(narrow)
        blk_t = torch.tensor(narrow, dtype=torch.int64)  # any integer type, made int32 by the build
    in_index = None
    if sampled:
        in_index = torch.tensor(np.random.default_rng(d).random(c.n) < 0.6)
    s = span_sparse.build_span_structures(*c.torch_args(), idx, c.opts, blk_t, in_index)
    s_j = jax_span.build_span_structures(*c.jax_args(), jidx, c.jopts)
    assert s.qrec.dtype == s.srec.dtype == F64
    for name in ("need", "start_tile", "rank_of", "block_of", "slot_of", "row_of"):
        np.testing.assert_array_equal(getattr(s, name).numpy(), np.asarray(getattr(s_j, name)), err_msg=name)
    assert int(s.overflow) == int(s_j.overflow)
    assert (int(s.overflow) > 0) == (windows == "given")
    nq = idx.nq
    np.testing.assert_array_equal(s.qcol.numpy(), np.asarray(s_j.qcol).reshape(-1)[:nq])
    np.testing.assert_array_equal(s.scol.numpy(), np.asarray(s_j.scol)[0])
    _assert_records(s.qrec.numpy(), c.query_rows(np.asarray(s_j.slot_of), nq))
    # the members: slot -> sorted rank -> vertex, the JAX order from its maps
    order = np.empty(c.n, np.int64)
    order[idx.row_moff[np.asarray(s_j.row_of)] + np.asarray(s_j.rank_of)] = np.arange(c.n)
    member = np.ones(c.n, bool) if in_index is None else in_index.numpy()
    iw = c.inv_w.astype(np.float64)
    vals = np.concatenate([
        np.where(member[:, None], c.pos.astype(np.float64), -1e15), iw[:, None],
        np.where(member, idx.class_bm2.astype(np.float64), 0.0)[:, None], (1.0 / iw)[:, None]], axis=1)
    sentinel = np.r_[np.full(d, -1e15), 1.0, 0.0, 0.0]
    want = np.concatenate([vals[order], sentinel[None]])[idx.src_of_pad]
    _assert_records(s.srec.numpy(), want)
    if sampled:
        assert (s.srec.numpy()[:, 0] == -1e15).sum() > (idx.src_of_pad == c.n).sum()


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("weight", ["inf", "nan"])
def test_windows_match_jax_at_unbounded_reach(d, weight):
    """Every 97th vertex's weight +inf or NaN, so the largest radius factor
    of every query block that holds one is too: with +inf every row is in
    reach and each window's bounds are -inf and +inf, where the stop is
    the row's own size (a search over +inf padding past the row's end
    would give the longest row); with NaN no row is in reach.  Start
    tiles, needs and overflow equal the JAX package's f32 build's, with
    windows of at most one tile (so that they overflow)."""
    c = case(d)
    w = c.w.copy()
    w[::97] = np.float32(weight)
    narrow = np.minimum(c.idx.blk_t, 1)
    pos, inv_w, _, colors = c.jax_args()
    s_j = jax_span.build_span_structures(pos, inv_w, jnp.asarray(w), colors, c.jidx._with_blk_t(narrow), c.jopts)
    tpos, tinv_w, _, tcolors = c.torch_args()
    blk_t = torch.tensor(narrow)
    s = span_sparse.build_span_structures(tpos, tinv_w, torch.tensor(w, dtype=F64), tcolors, c.idx, c.opts, blk_t)
    for name in ("need", "start_tile"):
        np.testing.assert_array_equal(getattr(s, name).numpy(), np.asarray(getattr(s_j, name)), err_msg=name)
    assert int(s.overflow) == int(s_j.overflow) > 0
    # the blocks that hold such a vertex: every window its whole row, or none
    need = s.need.numpy()[np.unique(s.block_of.numpy()[::97])]
    sizes = c.idx.row_sizes
    assert sizes.min() < sizes.max()
    np.testing.assert_array_equal(need, np.broadcast_to(sizes if weight == "inf" else 0, need.shape))


@functools.lru_cache(maxsize=None)
def cell_case(d: int):
    """A cell index at capacities the port measures at the case's
    positions (grown until nothing truncates, then resized to the needs,
    as the embedder's presize does), and the JAX index of those
    capacities."""
    c = Case(3000, d, seed=7, stretch=(3.0, 2.0, 1.3, 0.8))
    idx = span_compact.CellIndex.build(c.w, c.opts, c.g.edge_src, c.g.col_idx)
    for _ in range(8):
        s = span_compact.build_cell_structures(*c.torch_args(), idx, c.opts)
        grown = idx.grow_from_needs(s.need.numpy())
        if int(s.overflow) == 0 or grown is None:
            break
        idx = grown
    idx = idx.resize_to_needs(s.need.numpy()) or idx
    jidx = jax_cells.CellIndex.build(c.w, c.jopts, c.g.edge_src, c.g.col_idx)._with_caps(idx.cap_t)
    return c, idx, jidx


@pytest.mark.parametrize("d", [3, 4])
@pytest.mark.parametrize("caps", ["index", "given"])
def test_cells_build_matches_jax_in_f64(d, caps):
    """The cell layout's build in f64 (its three axes through
    ``principal_axes``) against the JAX package's f32 build: needs,
    overflow, the inverse maps, each window and prefix and the colours
    equal; the member records' positions, inverse weights and radius
    factors equal the JAX values and their last channel is 1 / invw to
    1e-12; the query records to 1e-12.  ``given``: one-tile capacities
    handed to the build, which truncate."""
    c, idx, jidx = cell_case(d)
    blk_t = None
    if caps == "given":
        one = np.minimum(idx.cap_t, 1)
        idx, jidx = idx._with_caps(one), jidx._with_caps(one)
        blk_t = torch.tensor(one[:, None], dtype=torch.int32)
    s = span_compact.build_cell_structures(*c.torch_args(), idx, c.opts, blk_t)
    s_j = jax_cells.build_cell_structures(*c.jax_args(), jidx, c.jopts)
    np.testing.assert_array_equal(s.need.numpy(), np.asarray(s_j.need))
    assert int(s.overflow) == int(s_j.overflow)
    assert (int(s.overflow) > 0) == (caps == "given")
    for name in ("rank_of", "block_of", "slot_of", "row_of"):
        np.testing.assert_array_equal(getattr(s, name).numpy(), np.asarray(getattr(s_j, name)), err_msg=name)
    cov = np.asarray(s_j.covtab)
    for k, name in enumerate(("start", "stop", "prefix")):
        np.testing.assert_array_equal(getattr(s, name).numpy().reshape(-1), cov[:, k], err_msg=name)
    nca, nq = idx.w * span_sparse._ST, idx.nq
    np.testing.assert_array_equal(s.scol.numpy(), np.asarray(s_j.scol)[0, :nca])
    np.testing.assert_array_equal(s.qcol.numpy(), np.asarray(s_j.qcol).reshape(-1)[:nq])
    srec, sdata = s.srec.numpy(), np.asarray(s_j.sdata).T[:nca]
    # slots past a block's members hold the member sentinel (the JAX
    # package's rounded to f32)
    dead = srec[:, 0] == -1e15
    np.testing.assert_array_equal(dead, sdata[:, 0] == np.float32(-1e15))
    np.testing.assert_array_equal(srec[dead], np.broadcast_to(np.r_[np.full(d, -1e15), 1.0, 0.0, 0.0],
                                                              (int(dead.sum()), d + 3)))
    np.testing.assert_array_equal(srec[~dead, : d + 2], sdata[~dead, : d + 2].astype(np.float64))
    _assert_records(srec[~dead, d + 2], 1.0 / srec[~dead, d])
    _assert_records(s.qrec.numpy(), c.query_rows(np.asarray(s_j.slot_of), nq))


# ------------------------------------------------------------------ wrappers


def _pieces(c: Case, dtype=F64, in_index=None):
    """The wrappers' inputs at the case's positions, as the build makes them."""
    pos, inv_w, w, colors = c.torch_args(dtype)
    t = c.idx.tensors(torch.device("cpu"))
    _, proj = span_build.principal_frame(pos, 2)
    y = proj[0]
    x = proj[1] if c.d >= 2 else y
    order1 = span_sparse._argsort_by(y, t.group_of)
    order = order1[span_sparse._argsort_by(x[order1], t.row_key)]
    vrec = c.idx.vertex_records(w, inv_w, colors, dtype, float(c.opts.edge_length))
    return dict(order=order, order1=order1, positions=pos, vrec=vrec, x=x, y=y, t=t, in_index=in_index,
                centered=pos - pos.mean(0))


def _counts():
    return (span_build.principal_frame.launches, span_build.principal_axes.launches,
            span_build.span_records.launches, span_build.span_windows.launches)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("sampled", [False, True])
def test_wrappers_run_the_plain_versions_on_the_cpu(dtype, sampled):
    """On CPU tensors each wrapper returns its plain version's outputs,
    bitwise, and counts no launch."""
    c = case(2)
    in_index = torch.tensor(np.random.default_rng(0).random(c.n) < 0.5) if sampled else None
    p = _pieces(c, dtype, in_index)
    before = _counts()
    cov = p["centered"].T @ p["centered"]
    for k in (2, 3):
        assert torch.equal(span_build.principal_axes(cov, k), span_build.principal_axes_reference(cov, k))
        for a, b in zip(span_build.principal_frame(p["positions"], k),
                        span_build.principal_frame_reference(p["positions"], k)):
            assert torch.equal(a, b)
    args = (p["order"], p["positions"], p["vrec"], p["x"], p["y"], p["t"], in_index)
    got, want = span_build.span_records(*args), span_build.span_records_reference(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got.qrec.shape == (c.idx.nq, 5) and got.srec.shape == (c.idx.npa, 5)
    blk_t = c.idx.blk_t_tensor(torch.device("cpu"))
    wargs = (got.sorted, p["y"], p["order1"], p["t"], blk_t)
    for a, b in zip(span_build.span_windows(*wargs), span_build.span_windows_reference(*wargs)):
        assert torch.equal(a, b)
    assert _counts() == before


def test_launch_counters_are_kept_with_the_step_graphs():
    """The build's four counters are among the counters a captured step
    takes back and adds at each replay (``kernels.counters``)."""
    before = kernels.counters()
    assert len(before) == len(kernels._COUNTERS)
    wrappers = {fn for fn, _ in kernels._COUNTERS}
    assert {span_build.principal_frame, span_build.principal_axes, span_build.span_records,
            span_build.span_windows} <= wrappers
    kernels.add_to_counters(tuple(range(1, len(before) + 1)))
    after = kernels.counters()
    assert all(a - b == i + 1 for i, (a, b) in enumerate(zip(after, before)))
    kernels.add_to_counters(tuple(b - a for a, b in zip(after, before)))
    assert kernels.counters() == before


@pytest.mark.parametrize(
    "call,error",
    [
        (lambda p: span_build.principal_axes(torch.zeros(3, 2, dtype=F64), 2), ValueError),
        (lambda p: span_build.principal_axes(torch.eye(3, dtype=F64), 4), ValueError),
        (lambda p: span_build.principal_axes(torch.eye(3, dtype=torch.int64), 2), TypeError),
        (lambda p: span_build.principal_axes(torch.eye(3, dtype=F64).to("meta"), 2), ValueError),
        (lambda p: span_build.span_records(p["order"].to(torch.int32), *_rest(p)), TypeError),
        (lambda p: span_build.span_records(p["order"][:-1], *_rest(p)), ValueError),
        (lambda p: span_build.span_records(p["order"], p["positions"], p["vrec"].float(), *_rest(p)[2:]),
         TypeError),
        (lambda p: span_build.span_records(p["order"], *_rest(p)[:2], p["x"].float(), *_rest(p)[3:]),
         TypeError),
        (lambda p: span_build.span_records(*(v.to("meta") if torch.is_tensor(v) else v
                                             for v in (p["order"], *_rest(p)[:4])), p["t"]), ValueError),
        (lambda p: span_build.span_windows(torch.zeros(2, 3, dtype=F64), p["y"], p["order1"], p["t"],
                                           p["blk"]), ValueError),
        (lambda p: span_build.span_windows(p["sorted"], p["y"], p["order1"], p["t"], p["blk"][:, :-1]),
         ValueError),
        (lambda p: span_build.span_windows(p["sorted"].float(), p["y"].float(), p["order1"], p["t"],
                                           p["blk"]), None),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, error):
    """The checks every wrapper runs before it picks a route: wrong shapes,
    dtypes and devices raise (a meta tensor has no kernel).  The last case
    is sound (f32 throughout) and runs."""
    c = case(2)
    p = _pieces(c)
    p["sorted"] = span_build.span_records(*_rest_all(p)).sorted
    p["blk"] = c.idx.blk_t_tensor(torch.device("cpu"))
    if error is None:
        call(p)
        return
    with pytest.raises(error):
        call(p)


def _rest(p):
    return (p["positions"], p["vrec"], p["x"], p["y"], p["t"])


def _rest_all(p):
    return (p["order"], *_rest(p))


def test_radius_factors_are_made_once_a_weights_tensor():
    """``SpanIndex.lwpow`` keeps L * w^(1/d) for the weights tensor it was
    made from (a resized index shares it) and makes it again for a new
    tensor, another dtype, or weights changed in place."""
    c = case(2)
    w = torch.tensor(c.w, dtype=F64)
    a = c.idx.lwpow(w, F64, 1.0)
    assert c.idx.lwpow(w, F64, 1.0) is a
    assert c.idx._with_blk_t(np.minimum(c.idx.blk_t, 1)).lwpow(w, F64, 1.0) is a
    assert torch.equal(a, 1.0 * torch.pow(w, 0.5))
    assert c.idx.lwpow(w.clone(), F64, 1.0) is not a
    assert c.idx.lwpow(w, torch.float32, 1.0).dtype == torch.float32
    w.mul_(4.0)
    assert torch.equal(c.idx.lwpow(w, F64, 1.0), 2.0 * a)
