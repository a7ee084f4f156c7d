"""The general kernels' widths on the CPU: f32 at d > 8 and f64.

The plain versions against the JAX package's Pallas kernels in interpret
mode at d = 9, 24 and 32 (beside the d = 16 and 33 cases of
tests/test_torch_general_kernels.py), f64 trajectories at d = 9 against the
JAX package's jnp dense path, the general kernels' constants in the CUDA
sources against what the wrappers size their buffers by, the wrappers' CPU
route and checks at these widths, and numpy transcriptions of the general
kernels' folds (each row's active columns in column order, each slot's
candidates in member order) against the plain versions and against the
torch transcriptions that ``chip_smoke.py`` holds the kernels to, bitwise,
on the card."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_embedder import _assert_same_step, _graphs, _jax, _no_coincident_pairs, _port
from test_torch_fused_dense import _bits, _brute_force_f64, _inputs, _pallas
from test_torch_general_kernels import _span_case
from test_torch_span import Case, _jax_records

from wembed_tpu.core import RepulsionMode as JaxRepulsionMode
from wembed_tpu.kernels import span_sparse as jax_span
from wembed_tpu_torch.kernels import fused_dense, span_sparse, span_sweep

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from chip_smoke import dense_fold, sweep_fold  # noqa: E402

torch.set_num_threads(1)

KW = dict(L=1.0, att_scale=1.0, rep_scale=1.0)
CSRC = REPO / "wembed_tpu_torch" / "csrc"


# ------------------------------------------------ against the Pallas kernels


@pytest.mark.parametrize("d", [9, 24, 32])
def test_plain_dense_matches_pallas_kernel_at_wide_d(d):
    """The Pallas kernel pads d to DPAD = 128, so d = 9, 24 and 32 are its
    d = 2 layout: the same masks and counts, forces within the tolerance of
    tests/test_torch_general_kernels.py."""
    pos, invw, colors, adj = _inputs(300, d, coincident=True, seed=d)
    pos *= 0.3  # in the init cube, pairs at these d are beyond the dead zone
    f_j, z_j, att_j, rep_j, cnt_j = _pallas(pos, invw, colors, adj, False)
    f_t, z_t, att_t, rep_t, cnt_t = fused_dense.fused_dense_forces(
        torch.from_numpy(pos), torch.from_numpy(invw), torch.from_numpy(colors), _bits(adj),
        dim=d, additive=False, **KW,
    )
    assert int(cnt_t) == cnt_j > 0
    np.testing.assert_array_equal(z_t.numpy(), z_j.astype(np.int32))
    assert int(z_t.sum()) > 0
    scale = float(np.abs(pos).max()) * _brute_force_f64(pos, invw, colors, adj, False)[2]
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(float(att_t), att_j, rtol=1e-5)
    np.testing.assert_allclose(float(rep_t), rep_j, rtol=1e-5)


@pytest.mark.parametrize("d,spread", [(9, 0.4), (24, 0.1), (32, 0.1)])
def test_plain_sweep_matches_pallas_kernel_at_wide_d(d, spread):
    """The sweep's plain version on the JAX package's structures (an
    isotropic cloud: the stretched one has 4 axes), through work items of at
    most 3 tiles, against the Pallas sweep in interpret mode: counts exact,
    the loss and the forces within tests/test_torch_span.py's tolerances
    (the TPU form q * rowsum - coeff @ S cancels).  The cloud is narrower
    at a larger d, so that pairs repel."""
    c = Case(900, d, span_scale=8.0, isotropic=True, spread=spread, coincident=True)
    s_j = jax_span.build_span_structures(*c.jax_args(), c.jidx, c.jopts)
    out = np.asarray(jax_span.span_query(s_j, c.jidx, c.jopts, interpret=True))
    nq = c.jidx.nb * jax_span._Q
    out = out.reshape(-1, out.shape[-1])[:nq]
    q = np.asarray(s_j.qdata).reshape(-1, s_j.qdata.shape[-1])[:nq, :d]
    rowsum = out[:, d]
    force_j = q * rowsum[:, None] - out[:, :d]
    items = torch.tensor(span_sweep.work_items(c.jidx.blk_t, 3))
    force, loss, count, zero = span_sweep.span_sweep_reference(
        *_jax_records(s_j, c.jidx, d), dim=d, L=1.0, rep_scale=1.0, additive=False, items=items,
    )
    np.testing.assert_array_equal(count.numpy(), out[:, d + 2].astype(np.int32))
    np.testing.assert_array_equal(zero.numpy(), out[:, d + 3].astype(np.int32))
    assert count.sum() > 0 and zero.sum() > 0
    np.testing.assert_allclose(loss.numpy(), out[:, d + 1], rtol=1e-5, atol=1e-5)
    real = c.jidx.src_of_q[:nq] < c.n
    bound = 1e-6 * np.abs(q[real]).max() * rowsum.max()
    np.testing.assert_allclose(force.numpy(), force_j, rtol=1e-5, atol=bound)
    assert float(np.abs(force_j).max()) > 100 * bound


def test_f64_trajectory_matches_jax_dense_path_at_d9():
    """The port's dense step against the JAX package's jnp dense path in
    f64 at d = 9, step by step while no coincident kick fires."""
    g_j, g_t, coords, w = _graphs(9)
    coords = coords * 0.3
    kw = dict(embedding_dimension=9, dtype="float64")
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


# ------------------------------------------------------------- constants


def _constexpr(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_general_kernel_constants_match_the_wrappers():
    """The general kernels' shapes, read from the CUDA sources: the fewest
    rows a dense CTA (the wrapper sizes its per-CTA partials by it), the
    column tile and its 32-column groups (one uint4 of adjacency words a
    row), the slabs, and the sweep's sub-tile (its candidate bits fit one
    32-bit word and it divides a tile); the sweep's scratch is (items,
    d + 3, Q) whatever the kernel's shape."""
    dense = (CSRC / "fused_dense.cu").read_text()
    warps = _constexpr(dense, "kThreads") // 32
    assert warps * _constexpr(dense, "kGenMinRowsPerWarp") == fused_dense.GENERAL_ROWS_PER_BLOCK == 16
    assert _constexpr(dense, "kGenJC") == 4
    assert "kGenTileC = 32 * kGenJC" in dense
    options = re.search(r"const int options\[3\] = \{([\d, ]+)\}", dense).group(1)
    rows = [int(v) for v in options.split(",")]
    assert rows == sorted(rows, reverse=True) and min(rows) == _constexpr(dense, "kGenMinRowsPerWarp")
    slab = dict(re.findall(r"struct GenSlab<(float|double)> \{\s*static constexpr int value = (\d+);", dense))
    assert slab == {"float": "16", "double": "8"}

    sweep = (CSRC / "span_sweep.cu").read_text()
    assert (_constexpr(sweep, "kQ"), _constexpr(sweep, "kST")) == (span_sweep.Q, span_sweep.ST)
    cfg = {t: (ds, mb) for t, ds, mb in re.findall(
        r"struct GenCfg<(float|double)> \{\s*static constexpr int DS = (\d+);\s*static constexpr int MB = (\d+);",
        sweep,
    )}
    assert set(cfg) == {"float", "double"}
    for ds, mb in cfg.values():
        ds, mb = int(ds), int(mb)
        assert ds >= 8 and mb <= 32 and span_sweep.ST % mb == 0 and mb % 4 == 0
    scratch = torch.empty((3, 24 + 3, span_sweep.Q))
    items = torch.zeros((3, 4), dtype=torch.int32)
    span_sweep._check_scratch(scratch, items, torch.float32, 24, torch.device("cpu"))
    with pytest.raises(ValueError, match="scratch"):
        span_sweep._check_scratch(scratch, items, torch.float32, 25, torch.device("cpu"))


# ------------------------------------------------ the wrappers at wide d


@pytest.mark.parametrize("d,dtype", [(9, torch.float32), (24, torch.float32), (40, torch.float32),
                                     (9, torch.float64)])
def test_dense_wrapper_cpu_route_and_checks_at_wide_d(d, dtype):
    """CPU tensors take the plain version, bit for bit, and count no launch;
    the CUDA path's checks take f32 and f64 at these widths and refuse a
    wrong width, mixed types and half precision."""
    pos, invw, colors, adj = _inputs(200, d, seed=d)
    args = (torch.from_numpy(pos).to(dtype), torch.from_numpy(invw).to(dtype), torch.from_numpy(colors),
            _bits(adj))
    kw = dict(dim=d, additive=False, **KW)
    before = (fused_dense.fused_dense_forces.launches, fused_dense.fused_dense_forces.launches_general)
    got = fused_dense.fused_dense_forces(*args, **kw)
    want = fused_dense.fused_dense_forces_reference(*args, **kw)
    assert (fused_dense.fused_dense_forces.launches, fused_dense.fused_dense_forces.launches_general) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fused_dense._check(*args, d)
    with pytest.raises(ValueError, match="shape"):
        fused_dense._check(*args, d + 1)
    with pytest.raises(TypeError):
        fused_dense._check(args[0], args[1].to(torch.float64 if dtype == torch.float32 else torch.float32),
                           *args[2:], d)
    with pytest.raises(TypeError):
        fused_dense._check(args[0].half(), args[1].half(), *args[2:], d)


@pytest.mark.parametrize("d,dtype", [(9, torch.float32), (24, torch.float64)])
def test_sweep_wrapper_cpu_route_and_checks_at_wide_d(d, dtype):
    """The sweep's wrapper on CPU tensors is its plain version, bit for bit,
    with no launch counted; its checks take these widths and refuse a
    record of another width or type."""
    g, opts, args, idx = _span_case(600, d, seed=d)
    args = tuple(a.to(dtype) if a.is_floating_point() else a for a in args)
    s = span_sparse.build_span_structures(*args, idx, opts)
    t = idx.tensors(torch.device("cpu"))
    sweep_args = (s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off)
    items = torch.tensor(span_sweep.work_items(idx.blk_t))
    kw = dict(dim=d, L=1.0, rep_scale=1.0, additive=False, items=items)
    before = (span_sweep.span_sweep.launches, span_sweep.span_sweep.launches_general)
    got = span_sweep.span_sweep(*sweep_args, **kw)
    want = span_sweep.span_sweep_reference(*sweep_args, **kw)
    assert (span_sweep.span_sweep.launches, span_sweep.span_sweep.launches_general) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[2].sum()) > 0
    span_sweep._check(*sweep_args, items, d)
    with pytest.raises(ValueError):
        span_sweep._check(*sweep_args, items, d + 1)
    with pytest.raises(TypeError):
        span_sweep._check(sweep_args[0].half(), *sweep_args[1:], items, d)


# ------------------------------------------------------ the kernels' folds


def _numpy_dense_fold(pos, invw, colors, adj):
    """The general dense kernel's force and coincident counts in numpy,
    scalar by scalar in the positions' type: each row's active columns in
    ascending order, acc = acc + coeff * (p_r - p_c) from +0."""
    t = pos.dtype.type
    n, d = pos.shape
    force = np.zeros((n, d), pos.dtype)
    zero = np.zeros(n, np.int32)
    one, tiny = t(1.0), t(1e-30)
    for r in range(n):
        diff = pos[r][None, :] - pos
        dist2 = np.zeros(n, pos.dtype)
        for k in range(d):
            dist2 = dist2 + diff[:, k] * diff[:, k]
        ws = invw[r] * invw
        wd = dist2 * (ws * ws)
        nbr = adj[r] != 0
        rep = ~nbr & (colors[r] != colors) & (wd <= one)
        att = nbr & (wd > one)
        posd = dist2 > 0
        zero[r] = np.sum(~posd & (nbr | rep))
        acc = np.zeros(d, pos.dtype)
        for c in np.flatnonzero((rep & posd) | att):
            inv = one / max(np.sqrt(dist2[c]), tiny)
            coeff = (one * ws[c]) * inv if rep[c] else -((one * ws[c]) * inv)
            acc = acc + coeff * (pos[r] - pos[c])
        force[r] = acc
    return force, zero


@pytest.mark.parametrize("d,dtype", [(9, np.float32), (17, np.float32), (24, np.float32), (33, np.float32),
                                     (40, np.float32), (9, np.float64), (24, np.float64)])
def test_dense_column_order_fold_matches_the_plain_version(d, dtype):
    """The fold the general dense kernel keeps (that of the kernel it replaced): each row's
    active columns added in column order.  Against the plain version (a
    pairwise sum) within the kernels' comparison tolerance, counts exact;
    and the torch transcription ``chip_smoke.py`` holds the kernel to on the
    card is the numpy fold bit for bit, a row range those rows."""
    pos, invw, colors, adj = _inputs(300, d, coincident=True, seed=d)
    pos, invw = (pos * 0.3).astype(dtype), invw.astype(dtype)
    force, zero = _numpy_dense_fold(pos, invw, colors, adj)
    args = (torch.from_numpy(pos), torch.from_numpy(invw), torch.from_numpy(colors), _bits(adj))
    kw = dict(dim=d, additive=False, **KW)
    f_p, z_p, _, _, cnt = fused_dense.fused_dense_forces_reference(*args, **kw)
    assert int(cnt) > 0 and int(z_p.sum()) > 0
    np.testing.assert_array_equal(zero, z_p.numpy())
    tol = 1e-5 if dtype == np.float32 else 1e-12
    scale = float(f_p.abs().max())
    np.testing.assert_allclose(force, f_p.numpy(), rtol=tol, atol=tol * scale)
    f_t, z_t = dense_fold(*args, **kw)
    np.testing.assert_array_equal(f_t.numpy().view(np.uint8), force.view(np.uint8))
    np.testing.assert_array_equal(z_t.numpy(), zero)
    f_r, _ = dense_fold(*args, **kw, rows=(40, 170))
    assert torch.equal(f_r, f_t[40:170])


def _numpy_sweep_fold(qrec, qcol, srec, scol, members, d):
    """One item's scratch (d + 3, 256) of the general sweep in numpy,
    scalar by scalar: each slot's candidates in member order from +0."""
    t = qrec.dtype.type
    one = t(1.0)
    out = np.zeros((d + 3, qrec.shape[0]), qrec.dtype)
    for slot in range(qrec.shape[0]):
        q = qrec[slot]
        acc, lsum, cnt, zc = np.zeros(d, qrec.dtype), t(0.0), 0, 0
        for m in members:
            s = srec[m]
            dist2 = t(0.0)
            for k in range(d):
                diff = q[k] - s[k]
                dist2 = dist2 + diff * diff
            if not (dist2 <= q[d + 1] * s[d + 1] and qcol[slot] != scol[m]):
                continue
            cnt += 1
            if not dist2 > 0:
                zc += 1
                continue
            ws = q[d] * s[d]
            if not dist2 * (ws * ws) <= one:
                continue
            dist = np.sqrt(dist2)
            coeff = (one * ws) * (one / dist)
            acc = acc + coeff * (q[:d] - s[:d])
            lsum = lsum + ((one * q[d + 2]) * s[d + 2] - dist)
        out[:d, slot], out[d, slot], out[d + 1, slot], out[d + 2, slot] = acc, lsum, cnt, zc
    return out


@pytest.mark.parametrize("d,dtype", [(9, torch.float32), (24, torch.float32), (40, torch.float32),
                                     (9, torch.float64)])
def test_sweep_member_order_fold_matches_the_plain_version(d, dtype):
    """The fold the general sweep keeps (that of the kernel it replaced): each slot's
    candidates of an item in walk order.  The torch transcription that
    ``chip_smoke.py`` holds the kernel's scratch to is the numpy fold bit
    for bit on the items checked one by one, and reduced in item order it
    agrees with the plain version, counts exactly."""
    g, opts, args, idx = _span_case(600, d, seed=d)
    args = tuple(a.to(dtype) if a.is_floating_point() else a for a in args)
    s = span_sparse.build_span_structures(*args, idx, opts)
    t = idx.tensors(torch.device("cpu"))
    sweep_args = (s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off)
    items = torch.tensor(span_sweep.work_items(idx.blk_t, 2))
    kw = dict(dim=d, L=1.0, rep_scale=1.0, additive=False)
    scratch = sweep_fold(*sweep_args, **kw, items=items)
    _, stile, item = span_sweep._item_tiles(items, s.blk_t, s.start_tile, t.tile_off)
    q3 = s.qrec.view(-1, span_sweep.Q, d + 3).numpy()
    qc3 = s.qcol.view(-1, span_sweep.Q).numpy()
    for i in (0, items.shape[0] // 2, items.shape[0] - 1):
        members = np.concatenate([np.arange(st * span_sweep.ST, (st + 1) * span_sweep.ST)
                                  for st in stile[item == i].tolist()])
        blk = int(items[i, 0])
        want = _numpy_sweep_fold(q3[blk], qc3[blk], s.srec.numpy(), s.scol.numpy(), members, d)
        np.testing.assert_array_equal(scratch[i].numpy().view(np.uint8), want.view(np.uint8))
    force, loss, count, zero = span_sweep.span_reduce_reference(scratch, items, idx.nb, d)
    f_p, l_p, c_p, z_p = span_sweep.span_sweep_reference(*sweep_args, **kw, items=items)
    assert torch.equal(count, c_p) and torch.equal(zero, z_p) and int(count.sum()) > 0
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    scale = float(f_p.abs().max())
    np.testing.assert_allclose(force.numpy(), f_p.numpy(), rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(loss.numpy(), l_p.numpy(), rtol=tol, atol=tol * float(l_p.abs().max()))
