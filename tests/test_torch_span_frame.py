"""The span build's principal frame and static vertex record
(``kernels/span_build.py``) on the CPU: ``principal_frame``'s plain
version against numpy in f64 (its trees and left folds recomputed) and
against the JAX package's ``_principal_axes2`` / ``_principal_axes3`` and
``centered @ v`` (rtol 1e-12 in f64, 1e-5 in f32), at d = 1, 2, 4, 8 and
the general route's d = 9, degenerate clouds included; the tree's -0.0
padding, which lets the kernels cut it into CTA chunks; the vertex record
made once a weights tensor; the wrappers' CPU route and their checks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wembed_tpu.core import candidates as jax_candidates

from wembed_tpu_torch import kernels
from wembed_tpu_torch.core import EmbedderOptions
from wembed_tpu_torch.kernels import span_build, span_sparse

torch.set_num_threads(1)

F64 = torch.float64


def _cloud(n: int, d: int, seed: int) -> np.ndarray:
    """An anisotropic Gaussian cloud in a random basis, off the origin:
    each axis 0.7 times the spread of the one before (consecutive
    eigenvalues ~2x apart, as ``tests/test_torch_span_build.py``'s)."""
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return (rng.normal(size=(n, d)) * 3.0 * 0.7 ** np.arange(d)) @ basis.T + rng.uniform(-5.0, 5.0, size=d)


def _np_tree(a: np.ndarray) -> np.ndarray:
    """The pairwise tree over axis 0 in ``a``'s dtype, recursively: the
    rows padded with -0.0 to a power of two, each half summed alone."""
    n = a.shape[0]
    p = 1 << max(n - 1, 0).bit_length()
    a = np.concatenate([a, np.full((p - n, *a.shape[1:]), -0.0, a.dtype)])

    def tree(lo, hi):
        return a[lo] if hi - lo == 1 else tree(lo, (lo + hi) // 2) + tree((lo + hi) // 2, hi)

    return tree(0, p)


def _np_axes(cov: np.ndarray, k: int, iters: int = span_build.ITERS) -> list[np.ndarray]:
    """``principal_axes_reference`` in numpy f64, every fold left to right."""

    def fold(a, b):
        s = a[0] * b[0]
        for i in range(1, a.shape[0]):
            s = s + a[i] * b[i]
        return s

    def matvec(c, v):
        return np.array([fold(row, v) for row in c])

    def power(c):
        d = c.shape[0]
        v = 1.0 + np.arange(d) * 1e-3
        v = v / np.sqrt(fold(v, v))
        for _ in range(iters):
            w = matvec(c, v)
            norm = np.sqrt(fold(w, w))
            v = w / norm if norm > 0 else v
        return v

    def normalised(v):
        norm = np.sqrt(fold(v, v))
        return v / norm if norm > 1e-12 else v

    v1 = power(cov)
    cov1 = cov - fold(v1, matvec(cov, v1)) * np.outer(v1, v1)
    v2 = power(cov1)
    axes = [v1, normalised(v2 - fold(v2, v1) * v1)]
    if k == 3:
        v2 = axes[1]
        v3 = power(cov1 - fold(v2, matvec(cov1, v2)) * np.outer(v2, v2))
        axes.append(normalised(v3 - fold(v3, v1) * v1 - fold(v3, v2) * v2))
    return axes


def _np_frame(x: np.ndarray, k: int):
    """The fast route's spec in numpy f64: tree mean, centring, tree
    covariance, the axes, the projections as left folds."""
    n, d = x.shape
    c = x - _np_tree(x) / n
    cov = np.empty((d, d))
    for i in range(d):
        for j in range(i, d):
            cov[i, j] = cov[j, i] = _np_tree(c[:, i] * c[:, j])
    axes = _np_axes(cov, k)
    proj = []
    for v in axes:
        s = c[:, 0] * v[0]
        for j in range(1, d):
            s = s + c[:, j] * v[j]
        proj.append(s)
    return axes, proj


def _jax_frame(x: np.ndarray, k: int):
    fn = jax_candidates._principal_axes2 if k == 2 else jax_candidates._principal_axes3
    xj = jnp.asarray(x)
    centred = xj - jnp.mean(xj, axis=0)
    axes = fn(centred)
    return [np.asarray(v) for v in axes], [np.asarray(centred @ v) for v in axes]


def _assert_frame(got, want, tol: float, compared: int, scale: float) -> None:
    """Axes to ``tol``, projections to ``tol`` and ``tol * scale`` (the
    centred cloud's extent: a noise axis projects to noise)."""
    axes, proj = got
    for a in range(compared):
        np.testing.assert_allclose(axes[a], want[0][a], rtol=tol, atol=tol)
        np.testing.assert_allclose(proj[a], want[1][a], rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d,k", [(1, 2), (2, 2), (4, 2), (8, 2), (9, 2), (2, 3), (4, 3), (8, 3), (9, 3)])
def test_frame_matches_numpy_and_jax(d, k, dtype):
    """The plain version's axes and projections against the spec recomputed
    in numpy f64 and against the JAX package's axes and ``centered @ v``:
    f64 to 1e-12, f32 to 1e-5.  At d < k the last axis is the rounding the
    deflation leaves (noise in f32), so f32 compares the leading d; d = 9
    is the general route (torch's mean and covariance product)."""
    x = _cloud(3000, d, seed=20 + d).astype(dtype)
    axes, proj = span_build.principal_frame_reference(torch.tensor(x), k)
    assert axes.dtype == proj.dtype == torch.from_numpy(x).dtype
    assert axes.shape == (k, d) and proj.shape == (k, 3000)
    got = ([v.numpy() for v in axes], [p.numpy() for p in proj])
    tol = 1e-12 if dtype == np.float64 else 1e-5
    compared = k if (d >= k or dtype == np.float64) else d
    scale = float(np.abs(x - x.mean(axis=0)).max())
    _assert_frame(got, _jax_frame(x, k), tol, compared, scale)
    if d <= span_build.MAX_FAST_DIM:
        _assert_frame(got, _np_frame(x.astype(np.float64), k), tol, compared, scale)


@pytest.mark.parametrize("k", [2, 3])
def test_frame_of_degenerate_clouds(k):
    """Every point equal (the tree mean exact, the centred rows exactly 0:
    the axes are the normalised start and the rounding left of it, every
    projection 0) and points on a skew line (v1 the line, the projections
    on it the line coordinate), as the JAX package computes them."""
    d = 3
    same = np.full((700, d), 1.5)
    axes, proj = span_build.principal_frame_reference(torch.tensor(same), k)
    start = (1.0 + np.arange(d) * 1e-3) / np.linalg.norm(1.0 + np.arange(d) * 1e-3)
    np.testing.assert_allclose(axes[0].numpy(), start, rtol=1e-15, atol=0)
    assert torch.all(proj == 0)
    _assert_frame(([v.numpy() for v in axes], [p.numpy() for p in proj]), _jax_frame(same, k), 1e-12, k, 1.0)

    t = np.random.default_rng(3).normal(size=700) * 4.0
    u = np.array([1.0, 2.0, 2.0]) / 3.0
    line = t[:, None] * u[None, :] + 2.0
    axes, proj = span_build.principal_frame_reference(torch.tensor(line), k)
    np.testing.assert_allclose(np.abs(axes[0].numpy()), u, rtol=1e-12)
    np.testing.assert_allclose(np.abs(proj[0].numpy()), np.abs(t - t.mean()), rtol=1e-9, atol=1e-9)
    want = _jax_frame(line, k)
    np.testing.assert_allclose(axes[0].numpy(), want[0][0], rtol=1e-12, atol=1e-12)
    for v in axes[1:].numpy():
        assert np.all(np.isfinite(v)) and abs(float(v @ axes[0].numpy())) < 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_tree_is_the_kernels_chunked_tree(dtype):
    """``_tree_sum`` is numpy's recursive pairwise tree bitwise, pads with
    -0.0 (a column of -0.0 sums to -0.0), is unchanged at a longer
    power-of-two length, and equals the kernels' decomposition: aligned
    chunks summed alone, then rounds of the same chunked tree over the
    partials (here chunks of 16 rows, so three rounds)."""
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.normal(size=(1000, 3)) * 10.0 ** rng.integers(-3, 4, size=(1000, 3)), dtype=dtype)
    a[:, 2] = -0.0
    got = span_build._tree_sum(a)
    assert torch.equal(got, torch.tensor(_np_tree(a.numpy())))
    assert str(got[2].item()) == "-0.0"
    longer = torch.cat([a, torch.full((3096, 3), -0.0, dtype=dtype)])
    assert torch.equal(span_build._tree_sum(longer), got)

    def chunked(rows, chunk=16):
        while rows.shape[0] > 1:
            pad = -rows.shape[0] % chunk
            rows = torch.cat([rows, torch.full((pad, rows.shape[1]), -0.0, dtype=dtype)])
            rows = torch.stack([span_build._tree_sum(rows[i:i + chunk]) for i in range(0, rows.shape[0], chunk)])
        return rows[0]

    assert torch.equal(chunked(a), got)


def _index(n: int = 3000, d: int = 2, seed: int = 8):
    rng = np.random.default_rng(seed)
    w = rng.pareto(2.0, n) + 1.0
    src, dst = rng.integers(0, n, size=(2, 4 * n))
    keep = src != dst
    pairs = np.unique(np.sort(np.stack([src[keep], dst[keep]], 1), axis=1), axis=0)
    esrc = np.concatenate([pairs[:, 0], pairs[:, 1]])
    edst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.argsort(esrc, kind="stable")
    opts = EmbedderOptions(embedding_dimension=d)
    idx = span_sparse.SpanIndex.build(w, opts, esrc[order], edst[order])
    return idx, w, rng


def test_vertex_records_are_made_once_a_weights_tensor():
    """``SpanIndex.vertex_records`` holds [iw, lw * lw, 1 / iw, colour
    bits, bm2, lw, 0, 0] (the colour an int32 in the low word), is kept for
    the weights, inverse weights and colours it was made from (a resized
    index shares it), and is made again for new weights, weights or
    inverse weights changed in place, new colours and another dtype."""
    idx, w_np, rng = _index()
    w = torch.tensor(w_np, dtype=F64)
    inv_w = torch.tensor(rng.uniform(0.5, 2.0, size=idx.n), dtype=F64)
    colors = torch.tensor(rng.integers(0, 7, size=idx.n), dtype=torch.int32)
    rec = idx.vertex_records(w, inv_w, colors, F64, 1.5)
    lw = 1.5 * torch.pow(w, 1.0 / idx.d)
    want = torch.stack([inv_w, lw * lw, 1.0 / inv_w, torch.zeros_like(w), torch.tensor(idx.class_bm2, dtype=F64),
                        lw, torch.zeros_like(w), torch.zeros_like(w)], dim=1)
    assert rec.shape == (idx.n, span_build.VREC_WIDTH)
    assert torch.equal(rec[:, [0, 1, 2, 4, 5, 6, 7]], want[:, [0, 1, 2, 4, 5, 6, 7]])
    assert torch.equal(rec.view(torch.int32)[:, 6], colors) and torch.all(rec.view(torch.int32)[:, 7] == 0)
    assert idx.vertex_records(w, inv_w, colors, F64, 1.5) is rec
    assert idx._with_blk_t(np.minimum(idx.blk_t, 1)).vertex_records(w, inv_w, colors, F64, 1.5) is rec
    assert idx.vertex_records(w.clone(), inv_w, colors, F64, 1.5) is not rec
    assert idx.vertex_records(w, inv_w, colors.clone(), F64, 1.5) is not rec
    f32 = idx.vertex_records(w, inv_w, colors, torch.float32, 1.5)
    assert f32.dtype == torch.float32 and torch.equal(f32.view(torch.int32)[:, 3], colors)
    rec = idx.vertex_records(w, inv_w, colors, F64, 1.5)
    inv_w.mul_(2.0)
    again = idx.vertex_records(w, inv_w, colors, F64, 1.5)
    assert again is not rec and torch.equal(again[:, 0], 2.0 * rec[:, 0])
    w.mul_(4.0)
    assert torch.equal(idx.vertex_records(w, inv_w, colors, F64, 1.5)[:, 5], 2.0 ** (2.0 / idx.d) * again[:, 5])


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("d", [1, 2, 9])
def test_frame_wrapper_runs_the_plain_version_on_the_cpu(d, dtype):
    """On a CPU tensor ``principal_frame`` is its plain version, bitwise,
    and counts no launch; at d > 8 that is the general route."""
    x = torch.tensor(_cloud(1500, d, seed=d), dtype=dtype)
    before = kernels.counters()
    for k in (2, 3):
        got, want = span_build.principal_frame(x, k), span_build.principal_frame_reference(x, k)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    if d > span_build.MAX_FAST_DIM:
        centred = x - torch.mean(x, dim=0)
        axes = span_build.principal_axes_reference(centred.T @ centred, 2)
        assert torch.equal(span_build.principal_frame(x, 2)[0], axes)
    assert kernels.counters() == before


def _records_inputs():
    idx, w_np, rng = _index()
    pos = torch.tensor(rng.normal(size=(idx.n, 2)))
    w = torch.tensor(w_np, dtype=F64)
    colors = torch.tensor(rng.integers(0, 7, size=idx.n), dtype=torch.int32)
    vrec = idx.vertex_records(w, 1.0 / w, colors, F64, 1.0)
    t = idx.tensors(torch.device("cpu"))
    _, proj = span_build.principal_frame(pos, 2)
    order = torch.argsort(proj[1])
    return dict(order=order, pos=pos, vrec=vrec, x=proj[1], y=proj[0], t=t)


@pytest.mark.parametrize(
    "call,error",
    [
        (lambda p: span_build.principal_frame(p["pos"], 4), ValueError),
        (lambda p: span_build.principal_frame(p["pos"].long(), 2), TypeError),
        (lambda p: span_build.principal_frame(p["pos"][:, 0], 2), ValueError),
        (lambda p: span_build.principal_frame(p["pos"][:0], 2), ValueError),
        (lambda p: span_build.principal_frame(p["pos"].to("meta"), 2), ValueError),
        (lambda p: span_build.span_records(p["order"], p["pos"], p["vrec"][:, :4], p["x"], p["y"], p["t"]),
         ValueError),
        (lambda p: span_build.span_records(p["order"], p["pos"].float(), p["vrec"], p["x"].float(),
                                           p["y"].float(), p["t"]), TypeError),
        (lambda p: span_build.span_records(p["order"], p["pos"], p["vrec"], p["x"], p["y"],
                                           p["t"]._replace(src_of_pad=p["t"].src_of_pad.long())), TypeError),
        (lambda p: span_build.span_records(p["order"], p["pos"], p["vrec"], p["x"], p["y"],
                                           p["t"]._replace(src_of_q=p["t"].src_of_q[:-1])), ValueError),
    ],
)
def test_frame_and_records_reject_what_the_kernels_do_not_take(call, error):
    """k other than 2 or 3, integer positions, a 1-D or empty array and a
    device with no kernel for the frame; a vertex record of the wrong
    width or dtype, a 64-bit slot map and a query map of a part block for
    the records."""
    p = _records_inputs()
    with pytest.raises(error):
        call(p)
