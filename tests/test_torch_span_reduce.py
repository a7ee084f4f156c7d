"""The span sweep's reduction (each query block's work items added in item
order) on the CPU: its plain version, ``span_sweep.span_reduce_reference``,
bitwise against a fold written as a plain loop over the items, on tables
with empty, one-item and long blocks and slices cut inside blocks, with
-0.0, infinities, NaN and subnormals among the values; and the sweep's
plain version through it against the JAX package's Pallas sweep in
interpret mode."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.core.state import DeviceGraph as JaxDeviceGraph
from wembed_tpu.graphs import generators as jax_generators
from wembed_tpu.kernels import span_sparse as jax_span

from wembed_tpu_torch.core import EmbedderOptions
from wembed_tpu_torch.kernels import span_sparse, span_sweep

torch.set_num_threads(1)

Q = span_sweep.Q
MAX_COUNT = 4 * 256 * 256  # candidates of one item's slot: 4 tiles of 256 members


def _scratch(per_block, d: int, dtype, seed: int):
    """(scratch (items, d + 3, Q), items (items, 4) int32) of ``per_block[b]``
    items of block b: float channels of mixed magnitudes with -0.0 (also as
    the first item of half of every block's slots), +-inf, NaN (some with a
    payload) and subnormals; counts up to MAX_COUNT, as int32 bits in the
    fast layout and as values in the general one."""
    real = np.float64 if dtype == torch.float64 else np.float32
    bits, nan = (np.uint64, 0x7FF4000000000001) if real == np.float64 else (np.uint32, 0x7FA00001)
    rng = np.random.default_rng(seed)
    per_block = np.asarray(per_block, np.int64)
    n = int(per_block.sum())
    shape = (n, d + 1, Q)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)).astype(real)
    pick = rng.random(shape)
    x[pick < 0.05] = -0.0
    x[(pick >= 0.05) & (pick < 0.055)] = np.inf
    x[(pick >= 0.055) & (pick < 0.06)] = -np.inf
    x[(pick >= 0.06) & (pick < 0.065)] = np.nan
    x.view(bits)[(pick >= 0.065) & (pick < 0.07)] = nan
    sub = (pick >= 0.07) & (pick < 0.12)
    x[sub] = (rng.normal(size=int(sub.sum())) * np.finfo(real).tiny / 4).astype(real)
    first = (np.cumsum(per_block) - per_block)[per_block > 0]
    x[first, :, : Q // 2] = -0.0
    counts = rng.integers(0, MAX_COUNT + 1, size=(n, 2, Q))
    general = dtype == torch.float64 or d > span_sweep.MAX_DIM
    counts = counts.astype(real) if general else counts.astype(np.int32).view(np.float32)
    items = np.zeros((n, 4), np.int32)
    items[:, 0] = np.repeat(np.arange(per_block.shape[0]), per_block)
    return torch.from_numpy(np.concatenate([x, counts], axis=1)), torch.from_numpy(items)


def _loop_fold(scratch, items, nb: int, d: int):
    """The reduction as a plain loop over the items in table order: each
    block's float channels from +0.0, acc = acc + x item by item (numpy,
    elementwise over the slots), its counts as int32 sums."""
    x = scratch.numpy()
    general = scratch.dtype == torch.float64 or d > span_sweep.MAX_DIM
    acc = np.zeros((nb, d + 1, Q), x.dtype)
    counts = np.zeros((nb, 2, Q), np.int32)
    for i, b in enumerate(items[:, 0].tolist()):
        with np.errstate(invalid="ignore", over="ignore"):  # inf - inf, and overflow, as the kernel rounds them
            acc[b] = acc[b] + x[i, : d + 1]
        tally = x[i, d + 1 :].astype(np.int32) if general else x[i, d + 1 :].view(np.int32)
        counts[b] = counts[b] + tally
    return (acc[:, :d].transpose(0, 2, 1).reshape(nb * Q, d), acc[:, d].reshape(-1),
            counts[:, 0].reshape(-1), counts[:, 1].reshape(-1))


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else t
    return np.ascontiguousarray(a).view(np.uint64 if a.itemsize == 8 else np.uint32)


def _assert_bitwise(got, want):
    for name, a, b in zip(("force", "loss", "count", "zero"), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    per_block=st.lists(st.integers(0, 5), min_size=1, max_size=9),
    d=st.integers(1, 10),
    f64=st.booleans(),
    cut=st.tuples(st.floats(0, 1), st.floats(0, 1)),
    seed=st.integers(0, 2**16),
)
def test_reduce_reference_is_a_loop_fold(per_block, d, f64, cut, seed):
    """Any table (empty blocks anywhere, first and last included; one-item
    blocks), any d on both layouts, and a contiguous slice of the table
    (one rank's share), which may start and end inside blocks."""
    dtype = torch.float64 if f64 else torch.float32
    scratch, items = _scratch(per_block, d, dtype, seed)
    nb = len(per_block)
    _assert_bitwise(span_sweep.span_reduce_reference(scratch, items, nb, d), _loop_fold(scratch, items, nb, d))
    lo, hi = sorted(int(c * items.shape[0]) for c in cut)
    part = (scratch[lo:hi], items[lo:hi])
    _assert_bitwise(span_sweep.span_reduce_reference(*part, nb, d), _loop_fold(*part, nb, d))


@pytest.mark.parametrize("d,dtype", [(1, torch.float32), (2, torch.float32), (4, torch.float32),
                                     (9, torch.float32), (2, torch.float64)])
def test_reduce_reference_on_long_blocks_and_slices(d, dtype):
    """Blocks of more than 256 items beside empty first, middle and last
    blocks and one-item blocks; slices that start and end inside the long
    blocks; -0.0 as a one-item block's value comes out +0.0."""
    per_block = [0, 3, 1, 0, 300, 1, 7, 257, 0]
    scratch, items = _scratch(per_block, d, dtype, seed=d)
    nb = len(per_block)
    got = span_sweep.span_reduce_reference(scratch, items, nb, d)
    _assert_bitwise(got, _loop_fold(scratch, items, nb, d))
    one = 5 * Q  # block 5 holds one item, -0.0 in its first half of slots
    zeros = got[1][one : one + Q // 2]
    assert bool(torch.all(zeros == 0)) and not bool(torch.signbit(zeros).any())
    assert bool(torch.isnan(got[0]).any()) and bool(torch.isinf(got[1]).any())
    assert int(got[2].max()) > MAX_COUNT  # sums of several items
    for lo, hi in [(10, 200), (150, 610), (305, 573), (0, 4), (4, 304)]:
        part = (scratch[lo:hi], items[lo:hi])
        _assert_bitwise(span_sweep.span_reduce_reference(*part, nb, d), _loop_fold(*part, nb, d))


def test_reduce_reference_without_items_gives_zeros():
    scratch, items = _scratch([0, 0, 0], 2, torch.float32, seed=0)
    force, loss, count, zero = span_sweep.span_reduce_reference(scratch, items, 3, 2)
    assert force.shape == (3 * Q, 2) and count.dtype == torch.int32
    assert not bool(force.any() or loss.any() or count.any() or zero.any())
    assert not bool(torch.signbit(force).any())


def test_reduce_wrapper_runs_the_plain_version_on_the_cpu():
    """``span_reduce`` takes the plain version for CPU tensors and counts no
    launch; the scratch check of the CUDA path refuses what the kernel does
    not take."""
    scratch, items = _scratch([2, 0, 5], 3, torch.float32, seed=4)
    before = span_sweep.span_reduce.launches
    _assert_bitwise(span_sweep.span_reduce(scratch, items, 3, 3), _loop_fold(scratch, items, 3, 3))
    assert span_sweep.span_reduce.launches == before
    dev = scratch.device
    span_sweep._check_scratch(scratch, items, torch.float32, 3, dev)
    for bad in (scratch.double(), scratch[:, :-1], scratch[:-1], scratch.transpose(0, 1)):
        with pytest.raises(ValueError):
            span_sweep._check_scratch(bad, items, torch.float32, 3, dev)


# --------------------------------------------- the sweep through the reduction


class _Case:
    """A GIRG, its weights and positions, and both packages' span indexes
    with the same random windows: blocks without tiles, with one and with
    several (cut into work items of one tile, blocks hold 0, 1 and several
    items)."""

    def __init__(self, n: int, d: int, seed: int = 5):
        g, _, _ = jax_generators.girg(n, dim=2, avg_degree=12, ple=2.2, rng=np.random.default_rng(seed))
        self.g, self.d = g, d
        self.jopts = JaxOptions(embedding_dimension=d)
        self.opts = EmbedderOptions(embedding_dimension=d)
        self.w = jax_weights.initial_weights(g, self.jopts)
        self.inv_w = jax_weights.inv_exp_weights(self.w, d)
        stretch = np.array([3.0, 1.5, 1.0, 1.0])[:d]
        self.pos = (np.random.default_rng(1).normal(size=(g.num_vertices, d)) * 2.0 * stretch).astype(np.float32)
        jidx = jax_span.SpanIndex.build(self.w, self.jopts, g.edge_src, g.col_idx, span_scale=8.0)
        idx = span_sparse.SpanIndex.build(self.w, self.opts, g.edge_src, g.col_idx, span_scale=8.0)
        rng = np.random.default_rng(seed + 1)
        widths = rng.integers(1, 7, size=jidx.blk_t.shape) * (rng.random(jidx.blk_t.shape) < 0.7)
        widths[::4] = 0  # blocks without tiles
        widths[1::4] = 0
        widths[1::4, 0] = 1  # blocks of one tile: one item
        widths = np.minimum(widths, jidx.row_tiles[None, :])
        self.jidx, self.idx = jidx._with_blk_t(widths), idx._with_blk_t(widths)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sweep_through_the_reduction_matches_pallas_kernel(d, dtype):
    """``span_sweep_reference(items=)``, each item's partials in the kernels'
    scratch layout then ``span_reduce_reference``, against the JAX
    package's ``span_query`` in interpret mode on the same records (the
    port's f64 run takes the JAX package's f32 records exactly).  Counts
    exactly; the loss to 1e-5; the force to 1e-5 and an absolute bound of
    1e-6 |q| rowsum, since the TPU form q * rowsum - coeff @ S cancels two
    terms of that size in f32, where the port sums coeff * (q - s)."""
    c = _Case(2000, d)
    s_j = jax_span.build_span_structures(
        jnp.asarray(c.pos), jnp.asarray(c.inv_w, jnp.float32), jnp.asarray(c.w, jnp.float32),
        JaxDeviceGraph.build(c.g).colors, c.jidx, c.jopts)
    out = np.asarray(jax_span.span_query(s_j, c.jidx, c.jopts, interpret=True))
    nq = c.jidx.nb * jax_span._Q
    out = out.reshape(-1, out.shape[-1])[:nq]
    q = np.asarray(s_j.qdata).reshape(-1, s_j.qdata.shape[-1])[:nq, : d + 3]
    srec = np.asarray(s_j.sdata).T[:, [*range(d + 2), d + 3]]
    args = (
        torch.tensor(q, dtype=dtype), torch.tensor(np.asarray(s_j.qcol).reshape(-1)[:nq]),
        torch.tensor(np.ascontiguousarray(srec), dtype=dtype), torch.tensor(np.asarray(s_j.scol)[0]),
        torch.tensor(c.jidx.blk_t), torch.tensor(np.asarray(s_j.start_tile)),
        torch.tensor((c.jidx.row_pad_off // span_sparse._ST).astype(np.int32)),
    )
    items = torch.tensor(span_sweep.work_items(c.jidx.blk_t, 1))
    per_block = np.bincount(items[:, 0].numpy(), minlength=c.jidx.nb)
    assert (per_block == 0).any() and (per_block == 1).any() and (per_block > 2).any()
    scratch = torch.empty((items.shape[0], d + 3, Q), dtype=dtype)
    force, loss, count, zero = span_sweep.span_sweep(
        *args, dim=d, L=1.0, rep_scale=1.0, additive=False, items=items, scratch=scratch)
    _assert_bitwise((force, loss, count, zero), tuple(
        t.numpy() for t in span_sweep.span_reduce(scratch, items, c.jidx.nb, d)))
    np.testing.assert_array_equal(count.numpy(), out[:, d + 2].astype(np.int32))
    np.testing.assert_array_equal(zero.numpy(), out[:, d + 3].astype(np.int32))
    assert count.sum() > 0
    empty = np.repeat(per_block == 0, Q)
    assert not force[empty].any() and not count[empty].any()
    np.testing.assert_allclose(loss.numpy(), out[:, d + 1], rtol=1e-5, atol=1e-5)
    rowsum = out[:, d]
    force_j = q[:, :d] * rowsum[:, None] - out[:, :d]
    real = c.jidx.src_of_q[:nq] < c.g.num_vertices  # padding slots hold the 1e15 sentinel
    bound = 1e-6 * np.abs(q[real, :d]).max() * rowsum.max()
    np.testing.assert_allclose(force.numpy(), force_j, rtol=1e-5, atol=bound)
    assert float(np.abs(force_j).max()) > 100 * bound


def test_the_block_sum_is_the_index_add_of_the_items():
    """On the CPU the fold from +0.0 in item order is what the sweep's plain
    version did before (``index_add_`` of each block's items into zeros),
    bitwise, on finite partials."""
    c = _Case(900, 2, seed=7)
    args = (c.pos, c.inv_w, c.w)
    s = span_sparse.build_span_structures(
        *(torch.tensor(a, dtype=torch.float32) for a in args), torch.tensor(c.g.colors), c.idx, c.opts)
    t = c.idx.tensors(torch.device("cpu"))
    sweep_args = (s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off)
    items = torch.tensor(span_sweep.work_items(c.idx.blk_t, 1))
    scratch = torch.empty((items.shape[0], 5, Q))
    got = span_sweep.span_sweep(*sweep_args, dim=2, L=1.0, rep_scale=1.0, additive=False, items=items,
                                scratch=scratch)
    block = items[:, 0].long()
    nb = c.idx.nb
    force = torch.zeros((nb, Q, 2)).index_add_(0, block, scratch[:, :2].transpose(1, 2))
    loss = torch.zeros((nb, Q)).index_add_(0, block, scratch[:, 2])
    counts = torch.zeros((nb, 2, Q), dtype=torch.int32).index_add_(0, block, scratch[:, 3:].view(torch.int32))
    _assert_bitwise(got, (force.reshape(-1, 2).numpy(), loss.reshape(-1).numpy(),
                          counts[:, 0].reshape(-1).numpy(), counts[:, 1].reshape(-1).numpy()))
    assert int(got[2].sum()) > 0
