"""The port's fused force pass (plain PyTorch version, which CPU tensors
run) against the JAX package's Pallas kernel in interpret mode, on the
same inputs in f32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wembed_tpu.kernels import fused_dense as jax_fused
from wembed_tpu_torch.kernels import fused_dense as torch_fused

torch.set_num_threads(1)

KW = dict(L=1.0, att_scale=1.0, rep_scale=1.0)


def _inputs(n, d, *, bipartite=False, coincident=False, seed=0):
    """Positions in the init cube, heavy-tailed weights, a random symmetric
    adjacency with ~8 neighbours a vertex."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, n ** (1 / d), size=(n, d)).astype(np.float32)
    if coincident:
        dup = pos[1::7]
        dup[:] = pos[0::7][: dup.shape[0]]
    w = rng.pareto(2.0, n) + 1.0
    invw = ((w * n / w.sum()) ** (-1.0 / d)).astype(np.float32)
    colors = (np.arange(n) % 2 if bipartite else np.arange(n)).astype(np.int32)
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    keep = src != dst
    adj = np.zeros((n, n), np.uint8)
    adj[src[keep], dst[keep]] = 1
    adj[dst[keep], src[keep]] = 1
    return pos, invw, colors, adj


def _pallas(pos, invw, colors, adj, additive):
    """The Pallas kernel on inputs padded as wembed_tpu/core/step.py:310-315."""
    n, d = pos.shape
    n_pad = max(256, -(-n // 256) * 256)
    pp = np.zeros((n_pad, jax_fused.DPAD), np.float32)
    pp[:n, :d] = pos
    ip = np.ones(n_pad, np.float32)
    ip[:n] = invw
    cp = np.full(n_pad, -1, np.int32)
    cp[:n] = colors
    ap = np.zeros((n_pad, n_pad), np.uint8)
    ap[:n, :n] = adj
    f, z, a, r, c = jax_fused.fused_dense_forces(
        jnp.asarray(pp), jnp.asarray(ip), jnp.asarray(cp), jnp.asarray(ap),
        n=n, dim=d, additive=additive, interpret=True, **KW,
    )
    return np.asarray(f)[:n, :d], np.asarray(z)[:n], float(a), float(r), int(c)


def _bits(adj):
    """The port's bit adjacency of a dense 0/1 matrix."""
    src, dst = np.nonzero(adj)
    return torch_fused.adjacency_bits(torch.from_numpy(src), torch.from_numpy(dst), adj.shape[0])


def _port(pos, invw, colors, adj, additive):
    out = torch_fused.fused_dense_forces(
        torch.from_numpy(pos), torch.from_numpy(invw), torch.from_numpy(colors),
        _bits(adj), dim=pos.shape[1], additive=additive, **KW,
    )
    return tuple(t.numpy() for t in out)


def _brute_force_f64(pos, invw, colors, adj, additive):
    """(repulsion-candidate count, coincident counts, max_v sum_u |coeff_vu|)
    in f64 numpy, pair by pair over the whole matrix."""
    p, iw = pos.astype(np.float64), invw.astype(np.float64)
    d2 = np.zeros((p.shape[0], p.shape[0]))
    for k in range(p.shape[1]):
        d2 += (p[:, None, k] - p[None, :, k]) ** 2
    ws = iw[:, None] + iw[None, :] if additive else iw[:, None] * iw[None, :]
    nbr = adj != 0
    wd2 = d2 * ws * ws
    rep = ~nbr & (colors[:, None] != colors[None, :]) & (wd2 <= 1.0)
    active = (rep & (d2 > 0)) | (nbr & (wd2 > 1.0))
    coeff = np.where(active, ws / np.sqrt(np.where(d2 > 0, d2, 1.0)), 0.0)
    zero = ((d2 <= 0) & (nbr | rep)).sum(axis=1)
    return int(rep.sum()), zero, float(coeff.sum(axis=1).max())


@pytest.mark.parametrize(
    "n,d,additive,bipartite,coincident",
    [
        (120, 2, False, False, False),
        (120, 3, True, False, False),
        (1000, 2, True, False, False),
        (1000, 3, False, True, True),
        (2048, 3, False, False, False),
        (2048, 2, False, True, True),
    ],
)
def test_port_matches_pallas_kernel(n, d, additive, bipartite, coincident):
    # every n has n_pad <= 1024 or a multiple of 1024, where the Pallas grid
    # covers every column (see test_port_counts_every_pair for the others)
    pos, invw, colors, adj = _inputs(n, d, bipartite=bipartite, coincident=coincident)
    f_j, z_j, att_j, rep_j, cnt_j = _pallas(pos, invw, colors, adj, additive)
    f_t, z_t, att_t, rep_t, cnt_t = _port(pos, invw, colors, adj, additive)

    # both evaluate the masks with the same f32 operations in the same order
    # (per-dimension differences, dist2 * ws^2 against L^2): counts are exact
    assert int(cnt_t) == cnt_j
    np.testing.assert_array_equal(z_t, z_j.astype(np.int32))
    if coincident:
        assert z_t.sum() > 0
    # The Pallas kernel forms p_v * rowsum - coeff @ P, two terms of size
    # |p| * sum|coeff| that cancel, so its f32 error is ~eps32 * that size;
    # the port sums coeff * (p_v - p_u) directly.  Hence atol scales with
    # max|p| * max_v sum_u |coeff_vu|; rtol 1e-5 covers summation order.
    scale = float(np.abs(pos).max()) * _brute_force_f64(pos, invw, colors, adj, additive)[2]
    np.testing.assert_allclose(f_t, f_j, rtol=1e-5, atol=1e-6 * scale)
    # losses are f32 sums of up to n^2 terms in different orders
    np.testing.assert_allclose(float(att_t), att_j, rtol=1e-5)
    np.testing.assert_allclose(float(rep_t), rep_j, rtol=1e-5)


@pytest.mark.parametrize("n", [1000, 1100])
def test_port_counts_every_pair(n):
    """The Pallas grid is (n_pad / 256, n_pad / 1024) with n_pad a multiple
    of 256 (wembed_tpu/kernels/fused_dense.py:172), so for n_pad > 1024 and
    n_pad % 1024 != 0 its last columns are never visited.  The port visits
    every pair: its counts equal an f64 brute force at n = 1100, where the
    Pallas kernel counts fewer."""
    rng = np.random.default_rng(42)
    side = int(n ** 0.5)
    # grid positions (multiples of 1/64 below 34): every difference, square
    # and sum is exact in f32 and f64, so the counts cannot differ by rounding
    pos = (rng.integers(0, side * 64, size=(n, 2)) / 64.0).astype(np.float32)
    invw = np.ones(n, np.float32)
    colors = np.arange(n, dtype=np.int32)
    adj = np.zeros((n, n), np.uint8)

    count, zero, _ = _brute_force_f64(pos, invw, colors, adj, False)
    _, z_t, _, _, cnt_t = _port(pos, invw, colors, adj, False)
    assert int(cnt_t) == count
    np.testing.assert_array_equal(z_t, zero)

    cnt_j = _pallas(pos, invw, colors, adj, False)[4]
    if n == 1000:
        assert cnt_j == count
    else:
        assert cnt_j < count


@pytest.mark.parametrize("n", [1000, 1024, 1100])
def test_bit_adjacency_unpacks_to_the_u8_adjacency(n):
    """The device-built bit adjacency (one int32 word per 32 columns, the
    last word ragged unless 32 divides n) unpacks to the u8 matrix that the
    JAX package builds, repeated and one-way edges included."""
    from wembed_tpu_torch.core import forces
    from wembed_tpu_torch.core.state import DeviceGraph
    from wembed_tpu_torch.graphs import from_edges

    rng = np.random.default_rng(n)
    g = from_edges(rng.integers(0, n, size=(6 * n, 2)), num_vertices=n)
    bits = forces.build_dense_adjacency(DeviceGraph.build(g, torch.device("cpu")))
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (n, -(-n // 32))
    u8 = np.zeros((n, n), np.uint8)
    u8[g.edge_src, g.col_idx] = 1
    assert u8.sum() > 4 * n and u8[:, -1].any()
    np.testing.assert_array_equal(torch_fused.neighbour_mask(bits, slice(0, n), n).numpy(), u8 != 0)
    # bit c % 32 of word c // 32, every bit of the sign word included
    words = bits.numpy().view(np.uint32)
    for v, c in zip(*np.nonzero(u8[:50])):
        assert words[v, c // 32] >> (c % 32) & 1
    assert int(np.unpackbits(words.view(np.uint8)).sum()) == int(u8.sum())
    src = np.r_[g.edge_src[:7], g.edge_src[:7]]  # a repeated pair sets its bit once
    dst = np.r_[g.col_idx[:7], g.col_idx[:7]]
    twice = torch_fused.adjacency_bits(torch.from_numpy(src), torch.from_numpy(dst), n)
    np.testing.assert_array_equal(twice.numpy(), torch_fused.adjacency_bits(
        torch.from_numpy(src[:7]), torch.from_numpy(dst[:7]), n).numpy())
