"""The span windows kernel's search and reductions, held on the CPU against
the JAX package's search and the plain version
(``kernels/span_build.py:span_windows_reference``).

The kernel (``csrc/span_build.cu:span_windows_kernel``) runs only on the
card, so its arithmetic is transcribed here in numpy, round for round:

- ``search_bounds``: one bound (a group of 4 lanes for the start, the
  next 4 for the stop) over its row's own values, for x < v (x <= v on
  the right): 0 or the row's size where the row's first value does not
  go before or its last does, and else 4-ary rounds of 4 pivots;
- ``windows_transcription``: the whole kernel, block by block.

The JAX package searches each row with ``bsearch``
(``wembed_tpu/kernels/span_sparse.py:1196``), a closure inside its build;
``jax_bsearch`` transcribes it probe for probe.  The JAX build itself is
held against the plain version in ``tests/test_torch_span_build.py``,
unbounded reach included.

(a) the search against ``jax_bsearch`` and the plain version's search
(``span_build._row_search``), both sides, and against
``torch.searchsorted`` where neither the row nor the value holds NaN,
under hypothesis: rows of 1-5,000 values (16^k and 16^k +- 1 among them)
from a small set (ties, -0.0 beside +0.0, +-inf) or spread (evenly, or
skewed), some ending in NaN; searched values from the set, NaN, +-inf,
any float, members of the row and values between its ends;
(b) the plain version's outputs do not move when the slots inside each
query block are permuted or when zero radius factors and positions flip
sign, so the order of the kernel's reductions cannot show in them;
(c) the whole transcription against the plain version on an index's
tables at random positions, on the adversarial inputs ``chip_smoke.py``
hands the kernel on the card, and on synthetic indexes of more than 256
rows and a longest row of 16^k and 16^k + 1, in f32 and f64."""

import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from wembed_tpu_torch.core import EmbedderOptions
from wembed_tpu_torch.core.weights import inv_exp_weights
from wembed_tpu_torch.graphs import from_edges
from wembed_tpu_torch.kernels import span_build, span_sparse

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import adversarial_windows_inputs, synthetic_windows_case  # noqa: E402

torch.set_num_threads(1)

FAN = 4  # csrc/span_build.cu kFan: lanes a bound, pivots a round
Q = span_build._Q
ST = span_build._ST


# --------------------------------------------------------- the transcription


def goes_before(x, v, right: bool):
    """``goes_before`` (csrc/span_build.cu), the JAX package's tests: x < v,
    or x <= v on the right."""
    return (x <= v) if right else (x < v)


def jax_bsearch(xs, row_lo, size, v, right: bool):
    """The JAX package's ``bsearch`` (wembed_tpu/kernels/span_sparse.py:1196-
    1215) for many searches at once: max(size).bit_length() + 1 branchless
    halvings of [row_lo, row_lo + size), each probe clamped into the
    array; the bound as a rank in the row."""
    row_lo, size = np.asarray(row_lo, np.int64), np.asarray(size, np.int64)
    lo, hi = row_lo.copy(), row_lo + size
    n = xs.shape[0]
    for _ in range(int(size.max()).bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        pred = goes_before(xs[np.minimum(mid, n - 1)], v, right)
        lo = np.where(active & pred, mid + 1, lo)
        hi = np.where(active & ~pred, mid, hi)
    return lo - row_lo


def search_bounds(xs, row_lo, size, v, right: bool):
    """The kernel's bound for many windows at once, as ``settled_bound``
    and the search of ``span_windows_kernel`` find it, round for round:
    (bounds, rounds of the FAN-ary search).

    The bound is 0 where the row's first value does not go before, the
    row's size where its last value does, and else in [1, size - 1] =
    [lo, hi]: a round tests pivot lo + (k + 1) s - 1 on lane k, s =
    ceil((hi - lo) / FAN), pivots at or past hi testing false; the ballot's
    popcount c moves lo to lo + c s and hi to at most lo + c s + s - 1."""
    row_lo, size = np.asarray(row_lo, np.int64), np.asarray(size, np.int64)
    first, last = xs[row_lo], xs[row_lo + size - 1]
    first_after = ~goes_before(first, v, right)
    last_before = goes_before(last, v, right)
    settled = np.select([first_after, last_before], [0, size], -1)
    searched = settled < 0
    lo = np.where(searched, 1, 0)
    hi = np.where(searched, size - 1, 0)
    k = np.arange(1, FAN + 1)
    rounds = 0
    while (hi > lo).any():
        m = hi - lo
        step = (m + FAN - 1) // FAN
        q = lo[:, None] + k[None, :] * step[:, None] - 1
        probed = (m[:, None] > 0) & (q < hi[:, None])
        x = xs[row_lo[:, None] + np.where(probed, q, 0)]
        votes = (probed & goes_before(x, v[:, None], right)).sum(axis=1)
        active = hi > lo
        nxt = lo + votes * step
        hi = np.where(active, np.minimum(hi, nxt + step - 1), hi)
        lo = np.where(active, nxt, lo)
        rounds += 1
    return np.where(searched, lo, settled), rounds


def windows_transcription(sorted_xyl, y, order1, t, blk_t):
    """``span_windows_kernel`` in numpy, in the kernel's order: the block's
    extrema over its slots, each (block, row) window's reach and overlap,
    both bounds by ``search_bounds`` for the windows in reach, then the
    slide, the need and the overflow in int64."""
    xs, ys, lws = (a.numpy() for a in sorted_xyl)
    T = xs.dtype.type
    n = xs.shape[0]
    nb, rr = t.blk_first.shape[0], t.row_lo.shape[0]
    src = t.src_of_q.numpy().astype(np.int64).reshape(nb, Q)
    valid = src < n
    slot = np.where(valid, src, 0)
    big = T(np.finfo(xs.dtype).max)
    maxlw = np.where(valid, lws[slot], T(0)).max(axis=1)  # a NaN wins, as in max_nan
    ymin = np.where(valid, ys[slot], big).min(axis=1)
    ymax = np.where(valid, ys[slot], -big).max(axis=1)
    minx, maxx = xs[t.blk_first.numpy()], xs[t.blk_last.numpy()]
    row_lo, row_hi = t.row_lo.numpy(), t.row_hi.numpy()
    yv, o1 = y.numpy(), order1.numpy()
    row_ymin, row_ymax = yv[o1[row_lo]], yv[o1[row_hi]]
    reach = maxlw[:, None] * t.bmax_row.numpy().astype(xs.dtype)[None, :]
    overlap = (ymin[:, None] - reach <= row_ymax[None, :]) & (ymax[:, None] + reach >= row_ymin[None, :])
    b, r = np.nonzero(overlap)
    start = np.zeros((nb, rr), np.int64)
    stop = np.zeros((nb, rr), np.int64)
    size = row_hi - row_lo + 1
    start[b, r] = search_bounds(xs, row_lo[r], size[r], minx[b] - reach[b, r], False)[0]
    stop[b, r] = search_bounds(xs, row_lo[r], size[r], maxx[b] + reach[b, r], True)[0]
    t_blk = blk_t.numpy().astype(np.int64)
    st_ = np.minimum((stop + ST - 1) // ST - t_blk, start // ST)
    st_ = np.minimum(np.maximum(st_, 0), t.row_tiles.numpy()[None, :] - t_blk)
    cov_end = (st_ + t_blk) * ST
    overflow = np.maximum(np.minimum(stop - cov_end, stop - start), 0).sum()
    need = np.where(stop > start, stop - (start // ST) * ST, 0)
    return st_.astype(np.int32), need, np.int64(overflow)


# ------------------------------------------------------ (a) the search alone

VALUES = (-np.inf, -3.0, -1.5, -0.0, 0.0, 0.5, 0.75, 2.0, 7.0, 1e30, np.inf)
POWERS = (1, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097)


def plain_search(row, v, right: bool) -> int:
    """The plain version's search (``span_build._row_search``) of one row."""
    t = types.SimpleNamespace(row_lo=torch.zeros(1, dtype=torch.int64),
                              row_hi=torch.tensor([len(row) - 1]), max_row=len(row))
    x = torch.from_numpy(row)
    return int(span_build._row_search(x, t, torch.tensor([[v]], dtype=x.dtype), right))


def torch_search(row, v, right: bool, length: int | None = None) -> int:
    """``torch.searchsorted`` on the row, padded to ``length`` with +inf."""
    padded = np.full(length or len(row), np.inf, row.dtype)
    padded[:len(row)] = row
    x = torch.from_numpy(padded)[None]
    return int(torch.searchsorted(x, torch.tensor([[v]], dtype=x.dtype), side="right" if right else "left"))


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(size=st.one_of(st.integers(1, 5000), st.sampled_from(POWERS)),
       row_kind=st.sampled_from(("ties", "spread", "skewed")), nan_tail=st.integers(0, 3),
       seed=st.integers(0, 2 ** 31 - 1), f64=st.booleans(),
       value_kind=st.sampled_from(("drawn", "member", "inside")),
       value=st.one_of(st.sampled_from((*VALUES, np.nan)), st.floats(width=32)))
@example(size=16, row_kind="ties", nan_tail=1, seed=1, f64=False, value_kind="drawn", value=np.inf)
@example(size=4095, row_kind="ties", nan_tail=0, seed=2, f64=False, value_kind="drawn", value=0.0)
@example(size=4097, row_kind="ties", nan_tail=2, seed=3, f64=True, value_kind="drawn", value=-0.0)
@example(size=256, row_kind="ties", nan_tail=1, seed=4, f64=False, value_kind="drawn", value=np.nan)
@example(size=3584, row_kind="spread", nan_tail=0, seed=5, f64=False, value_kind="inside", value=0.0)
def test_search_is_searchsorted(size, row_kind, nan_tail, seed, f64, value_kind, value):
    """Both sides of the transcribed search give the JAX package's answer
    (``jax_bsearch``) and the plain version's, and ``torch.searchsorted``'s
    where neither the row nor the value holds NaN; a search that takes
    FAN-ary rounds takes at most ceil(log_FAN(size + 1)) of them.  Rows:
    values from VALUES (ties, -0.0 beside +0.0, +-inf), uniform values with
    1 in 8 repeated (``spread``), or their cubes (``skewed``); the last
    ``nan_tail`` values NaN.  Values: drawn (VALUES, NaN or any f32), a
    member of the row, or a uniform value between the row's ends."""
    dtype = np.float64 if f64 else np.float32
    rng = np.random.default_rng(seed)
    if row_kind == "ties":
        row = np.asarray(VALUES, dtype)[rng.integers(0, len(VALUES), size=size)]
    else:
        row = rng.uniform(-10.0, 10.0, size=size)
        row[rng.random(size) < 0.125] = row[0]
        row = (row ** 3 if row_kind == "skewed" else row).astype(dtype)
    row = np.sort(row)
    if value_kind == "member":
        value = row[rng.integers(0, size)]
    elif value_kind == "inside":
        value = rng.uniform(row[0], row[-1]) if np.isfinite(row[[0, -1]]).all() else value
    row[size - min(nan_tail, size):] = np.nan
    v = np.asarray([value], dtype)
    for right in (False, True):
        got, rounds = search_bounds(row, [0], [size], v, right)
        want = int(jax_bsearch(row, [0], [size], v, right)[0])
        assert int(got[0]) == want, (right, row[:8], row[-8:])
        assert plain_search(row, v[0], right) == want
        if not (np.isnan(row).any() or np.isnan(v[0])):
            assert torch_search(row, v[0], right) == want
        assert rounds <= math.ceil(math.log(size + 1, FAN) - 1e-12)


def test_torch_tests_are_not_monotone_on_a_row_ending_in_nan():
    """Why the plain version does not search with ``torch.searchsorted``:
    torch tests !(x >= v) (left) and !(x > v) (right), so along [1, 2, 3,
    NaN] padded with +inf the left test for 0.0 is false, false, false,
    true, false, false, torch's probes end at 4, and a NaN value goes after
    every value of the padded row; the JAX package's x < v gives 0 in
    both, as do the plain version and the kernel."""
    row = np.array([1.0, 2.0, 3.0, np.nan], np.float32)
    for v in (0.0, np.nan):
        assert torch_search(row, v, False, length=6) == (4 if v == 0.0 else 6)
        assert plain_search(row, v, False) == 0
        assert int(search_bounds(row, [0], [4], np.array([v], np.float32), False)[0][0]) == 0
        assert int(jax_bsearch(row, [0], [4], np.array([v], np.float32), False)[0]) == 0
    # +inf on the right: the padding goes before it in torch's row, not in the row's own values
    full = np.array([1.0, 2.0, 3.0], np.float32)
    assert torch_search(full, np.inf, True, length=6) == 6
    assert plain_search(full, np.inf, True) == 3


# ---------------------------------------------- (b) order of the reductions


def _index_case(n: int, d: int, seed: int, dtype=torch.float64):
    """``span_windows`` arguments at random positions of a random graph
    with heavy-tailed weights, as the build makes them (the plain
    versions on the CPU)."""
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.uniform(0.0, n ** (1.0 / d), size=(n, d)), dtype=dtype)
    w = rng.pareto(2.0, n) + 1.0
    g = from_edges(rng.integers(0, n, size=(4 * n, 2)), num_vertices=n)
    opts = EmbedderOptions(embedding_dimension=d)
    idx = span_sparse.SpanIndex.build(w, opts, g.edge_src, g.col_idx)
    weights, inv_w = torch.tensor(w, dtype=dtype), torch.tensor(inv_exp_weights(w, d), dtype=dtype)
    colors = torch.arange(n, dtype=torch.int32)
    return span_sparse.build_steps(pos, inv_w, weights, colors, idx, opts).windows_args


def _same(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_windows_ignore_the_order_of_the_block_reductions(dtype):
    """The slots of every query block permuted (the order in which a
    block's radius factors and first-axis values meet in its max and min),
    and, on values rounded to put zeros among them, every zero radius
    factor and position flipped in sign: start tiles, needs and overflow
    unchanged, with narrowed windows that overflow and the index's own."""
    sorted_xyl, y, order1, t, blk = _index_case(3000, 2, seed=11, dtype=dtype)
    sorted_xyl = torch.round(sorted_xyl * 2.0) / 2.0  # monotone: rows stay sorted; zeros among the values
    sorted_xyl[2, ::3] = 0.0
    y = torch.round(y * 2.0) / 2.0
    nb = t.blk_first.shape[0]
    perm = torch.argsort(torch.rand((nb, Q), generator=torch.Generator().manual_seed(3)), dim=1)
    permuted = t._replace(src_of_q=torch.gather(t.src_of_q.view(nb, Q), 1, perm).reshape(-1).contiguous())
    flipped = torch.where(sorted_xyl == 0, -sorted_xyl, sorted_xyl)
    y_flipped = torch.where(y == 0, -y, y)
    assert bool((torch.signbit(flipped) != torch.signbit(sorted_xyl)).any())
    for widths in (blk, torch.clamp_max(blk, 1)):
        want = span_build.span_windows_reference(sorted_xyl, y, order1, t, widths)
        assert _same(want, span_build.span_windows_reference(sorted_xyl, y, order1, permuted, widths))
        assert _same(want, span_build.span_windows_reference(flipped, y_flipped, order1, t, widths))
        assert _same(want, span_build.span_windows_reference(flipped, y_flipped, order1, permuted, widths))
    assert int(span_build.span_windows_reference(sorted_xyl, y, order1, t, torch.clamp_max(blk, 1))[2]) > 0


# --------------------------------------- (c) the whole kernel, transcribed


def _assert_transcribed(wargs) -> None:
    want = span_build.span_windows_reference(*wargs)
    got = windows_transcription(*wargs)
    np.testing.assert_array_equal(got[0], want[0].numpy(), err_msg="start_tile")
    np.testing.assert_array_equal(got[1], want[1].numpy(), err_msg="need")
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("inputs", ["index", "narrow", "ties8", "lw_inf", "lw_zero", "nan"])
def test_transcription_is_the_plain_version(inputs, dtype):
    """The transcribed kernel against the plain version on an index's
    tables (n = 3,000, d = 2): at random positions with its own windows and
    with windows of at most one tile (overflow), and on each of
    ``chip_smoke.py``'s adversarial inputs made from those records."""
    wargs = _index_case(3000, 2, seed=12, dtype=dtype)
    sorted_xyl, y, order1, t, blk = wargs
    if inputs == "narrow":
        wargs = (sorted_xyl, y, order1, t, torch.clamp_max(blk, 1))
    elif inputs != "index":
        wargs = (adversarial_windows_inputs(wargs)[inputs].to(dtype), y, order1, t, blk)
    _assert_transcribed(wargs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,max_row", [(300, 4097), (40, 4096), (40, 256), (40, 257)])
def test_transcription_on_synthetic_indexes(rows, max_row, dtype):
    """``chip_smoke.py``'s synthetic indexes: more rows than a CTA has
    threads, a longest row of 16^k and 16^k + 1, ties, +-inf and rows
    ending in NaN."""
    wargs = synthetic_windows_case(rows, max_row, seed=rows + max_row, dtype=dtype, device="cpu")
    assert bool(torch.isnan(wargs[0][0]).any())
    _assert_transcribed(wargs)
