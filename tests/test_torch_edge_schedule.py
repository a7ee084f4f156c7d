"""The edge pass kernel's schedule (``core/edge_schedule.py``) and the edge
kicks' normalisation (``core/edge_geometry.py:unit_rows``), on the CPU.

The schedule is the grid of ``csrc/edge_pass.cu:segment_pass_kernel``:
every vertex in exactly one heavy or medium segment or one light group (so
every edge is computed once and every output row written once), heavy
segments first and longest first, then medium ones longest first, light
groups of consecutive vertices within a warp's 32 lanes, each entry with
its first edge and edge count.  ``unit_rows`` is what the kernel computes
for a kicked edge, so it is held against the same operations in numpy,
rounded alone in the working type, and against the exact direction where
no square under- or overflows."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from wembed_tpu_torch.core.edge_schedule import (
    HEAVY, LIGHT, WARPS, EdgeSchedules, edge_schedule, schedule_table,
)
from wembed_tpu_torch.core.forces import edge_share, normal_rows, unit_rows
from wembed_tpu_torch.core.step import Share
from wembed_tpu_torch.graphs import from_edges
from wembed_tpu_torch.kernels import edge_pass as ep

torch.set_num_threads(1)

SOURCE = Path(ep.__file__).resolve().parent.parent / "csrc" / "edge_pass.cu"


def power_law_offsets(n, seed, hub=0):
    """CSR offsets of a graph with Pareto-distributed degrees (some past
    32 and past 256) and, when ``hub``, one vertex of that many edges."""
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(1.3, n) * 3).astype(np.int64), 400)
    if hub:
        deg[rng.integers(n)] = hub
    return np.r_[0, np.cumsum(deg)]


def check_schedule(row_ptr):
    """Every property the kernel relies on, for the offsets ``row_ptr``."""
    table, heavy, medium, groups = schedule_table(row_ptr)
    deg = np.diff(row_ptr)
    n = deg.shape[0]
    assert table.dtype == np.int64 and table.shape == (heavy + medium + groups, 4)
    v, verts, first, edges = table.T
    # each entry's first edge and edge count are its vertices' CSR range
    assert np.array_equal(first, row_ptr[v]) and np.array_equal(edges, row_ptr[v + verts] - row_ptr[v])
    # heavy segments: exactly those longer than HEAVY, longest first; then
    # medium ones: longer than LIGHT, at most HEAVY, longest first
    hv, md = v[:heavy], v[heavy : heavy + medium]
    assert np.all(verts[: heavy + medium] == 1)
    assert np.array_equal(np.sort(hv), np.flatnonzero(deg > HEAVY))
    assert np.array_equal(np.sort(md), np.flatnonzero((deg > LIGHT) & (deg <= HEAVY)))
    assert np.all(np.diff(deg[hv]) <= 0) and np.all(np.diff(deg[md]) <= 0)
    # light groups: consecutive light vertices, at most LIGHT of them and
    # LIGHT edges, in vertex order; no segment split between groups
    seen = np.zeros(n, np.int64)
    seen[v[: heavy + medium]] += 1
    last = -1
    for v0, nv, _, ne in table[heavy + medium :]:
        assert 1 <= nv <= LIGHT and v0 > last and ne <= LIGHT
        assert np.all(deg[v0 : v0 + nv] <= LIGHT)
        seen[v0 : v0 + nv] += 1
        last = v0 + nv - 1
    # every vertex once, so every edge once (a segment is a vertex's edges)
    assert np.all(seen == 1)
    covered = np.zeros(int(row_ptr[-1]), np.int64)
    for f, e in zip(first, edges):
        covered[f : f + e] += 1
    assert np.all(covered == 1)
    return table, heavy, medium, groups


@pytest.mark.parametrize("n,seed,hub", [(1, 0, 0), (40, 1, 0), (1000, 2, 0), (3000, 3, 10_000)])
def test_schedule_covers_every_vertex_and_edge_once(n, seed, hub):
    """Power-law degrees (a hub of 10,000 edges in the last case): every
    vertex in one heavy or medium segment or one light group, heavy and
    medium segments longest first, light groups within a warp."""
    row_ptr = power_law_offsets(n, seed, hub)
    table, heavy, medium, groups = check_schedule(row_ptr)
    assert heavy + medium + groups >= 1
    if hub:
        assert table[0, 3] == hub and heavy >= 1 and medium >= 1


def test_schedule_packs_light_groups_greedily():
    """Consecutive light segments share a group until the next would pass
    32 edges or 32 vertices; a longer segment ends a group."""
    deg = np.array([10, 10, 12, 1, 40, 0, 0, 31, 2] + [0] * 40 + [300])
    row_ptr = np.r_[0, np.cumsum(deg)]
    table, heavy, medium, groups = check_schedule(row_ptr)
    assert (heavy, medium, groups) == (1, 1, 5)
    assert table[:2, 0].tolist() == [49, 4]
    assert table[2:, :2].tolist() == [[0, 3], [3, 1], [5, 3], [8, 32], [40, 9]]
    assert table[2:, 3].tolist() == [32, 1, 31, 2, 0]


def test_schedule_orders_ties_by_vertex():
    deg = np.array([33, 50, 33, 50, 5, 300, 300])
    table, heavy, medium, _ = schedule_table(np.r_[0, np.cumsum(deg)])
    assert table[:heavy, 0].tolist() == [5, 6]
    assert table[heavy : heavy + medium, 0].tolist() == [1, 3, 0, 2]


def test_schedule_of_a_graph_with_no_edges():
    """No edges: no heavy or medium segment; groups of 32 empty segments
    cover the vertices (the kernel still writes every row)."""
    row_ptr = np.zeros(70, np.int64)
    table, heavy, medium, groups = check_schedule(row_ptr)
    assert heavy == medium == 0 and groups == 3
    s = edge_schedule(row_ptr, torch.zeros((0,), dtype=torch.int64))
    assert s.num_edges == 0 and s.n == 69 and s.ctas == 1 and s.dst.dtype == torch.int32


@pytest.mark.parametrize("parts", [2, 3, 7])
def test_share_schedules_have_empty_segments(parts):
    """Each rank's share of the edges (``core/step.py:Share``), its
    offsets clipped as ``core/forces.py:edge_share`` clips them: the
    schedule covers all n vertices, most segments empty, its edges
    counted from the share's first, and holds the share's dst; the ranks'
    edges add up to the whole set."""
    row_ptr = power_law_offsets(2000, 5, hub=700)
    e = int(row_ptr[-1])
    dst = torch.arange(e, dtype=torch.int64) % 2000
    schedules = EdgeSchedules(row_ptr, dst)
    total = 0
    for rank in range(parts):
        share = Share(rank, parts, None)
        lo, hi, clipped = edge_share(torch.as_tensor(row_ptr), e, share)
        s = schedules.get(lo, hi)
        assert s is schedules.get(lo, hi)  # built once
        assert (s.n, s.num_edges) == (2000, hi - lo)
        assert torch.equal(s.dst, dst[lo:hi].to(torch.int32))
        table, heavy, medium, groups = check_schedule(clipped.numpy())
        assert (heavy, medium, groups) == (s.heavy, s.medium, s.groups)
        assert np.array_equal(table, s.table.numpy())
        assert int((np.diff(clipped.numpy()) == 0).sum()) > 500
        total += s.num_edges
    assert total == e
    whole = schedules.get()
    assert whole.ctas == whole.heavy + -(-whole.medium // WARPS) + -(-whole.groups // WARPS)


@pytest.mark.parametrize("row_ptr", [np.array([1, 2]), np.array([0, 3, 2]), np.array([0])])
def test_schedule_rejects_bad_offsets(row_ptr):
    with pytest.raises(ValueError):
        edge_schedule(row_ptr, torch.zeros((int(row_ptr[-1]),), dtype=torch.int64))


def test_kernel_constants_match_the_source():
    """The schedule's constants and the wrapper's are the CUDA source's
    (the library checks them again when it loads on the card)."""
    src = SOURCE.read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([\w /]+);", src).group(1)
        return int(eval(expr.replace("kThreads", "256")))

    assert const("kLight") == LIGHT
    assert const("kWarps") == WARPS
    assert const("kMaxFastDim") == ep.MAX_FAST_DIM
    assert const("kThreads") == 256 == WARPS * 32
    # no (E, d) scratch in the kernel of d <= 8, and one launch a pass
    body = src[src.index("segment_pass_kernel(const Args a)"):
               src.index("// --------------------------------------------------- general variant")]
    assert "a.net" not in body and "a.zflag" not in body and "atomicAdd(&g_ctas_done" in body


# ------------------------------------------------------------- unit_rows


def numpy_unit_rows(g):
    """unit_rows's operations in numpy, each rounded alone in g's dtype."""
    with np.errstate(over="ignore", under="ignore"):
        norm2 = np.zeros(g.shape[0], g.dtype)
        for k in range(g.shape[1]):
            norm2 = norm2 + g[:, k] * g[:, k]
        norm = np.sqrt(norm2)
        return g / np.where(norm > 0, norm, g.dtype.type(1))[:, None]


ROWS = {
    "normal": lambda rng, d, dt: rng.normal(size=(64, d)).astype(dt),
    "zero": lambda rng, d, dt: np.zeros((4, d), dt),
    "tiny": lambda rng, d, dt: (rng.normal(size=(8, d)) * (1e-30 if dt == np.float32 else 1e-200)).astype(dt),
    "huge": lambda rng, d, dt: (rng.normal(size=(8, d)) * (1e30 if dt == np.float32 else 1e200)).astype(dt),
}


@pytest.mark.parametrize("kind", list(ROWS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 4, 9])
def test_unit_rows_against_the_f64_formula(kind, dtype, d):
    """``unit_rows`` against its operations done in numpy (each rounded
    alone; torch's CPU sqrt is within an ulp, not correctly rounded, so
    within 2 ulps) and against the exact direction g / |g| (in f64, each
    row scaled by its largest entry first): within 2 ulps of the working
    type where no square under- or overflows; a zero row stays zero; a row
    whose squares underflow stays as it is (its computed norm is 0); a row
    whose squares overflow becomes zeros (its computed norm is inf).  The
    kernel repeats these operations for every kicked edge, and
    chip_smoke.py holds the two bitwise on the card, where torch's sqrt is
    IEEE."""
    rng = np.random.default_rng(d * 10 + len(kind))
    g = ROWS[kind](rng, d, dtype)
    got = unit_rows(torch.as_tensor(g)).numpy()
    assert got.dtype == dtype
    ulp = np.finfo(dtype).eps
    np.testing.assert_allclose(got, numpy_unit_rows(g), rtol=2 * ulp, atol=0)
    g64 = g.astype(np.float64)
    scale = np.abs(g64).max(axis=1, keepdims=True)
    g64 = g64 / np.where(scale > 0, scale, 1.0)
    norm = np.sqrt((g64 * g64).sum(axis=1, keepdims=True))
    exact = g64 / np.where(norm > 0, norm, 1.0)
    if kind == "normal":
        np.testing.assert_allclose(got, exact, rtol=0, atol=2 * ulp)
        np.testing.assert_allclose(np.linalg.norm(got.astype(np.float64), axis=1), 1.0, rtol=4 * ulp)
    elif kind == "zero":
        assert np.all(got == 0)
    elif kind == "tiny":
        np.testing.assert_allclose(np.linalg.norm(exact, axis=1), 1.0)  # the direction exists...
        np.testing.assert_array_equal(got, g)  # ...but the working type's norm is 0
    else:
        np.testing.assert_allclose(np.linalg.norm(exact, axis=1), 1.0)
        assert np.all(got == 0)


def test_unit_rows_keeps_nan_rows_and_takes_no_draw():
    """A NaN row stays NaN (its norm is NaN, not > 0: divided by 1); the
    draw behind the kicks is one ``torch.randn`` of (E, d), so later draws
    from the generator do not move."""
    g = torch.tensor([[float("nan"), 1.0], [3.0, 4.0]])
    got = unit_rows(g)
    assert torch.isnan(got[0, 0]) and got[0, 1] == 1.0
    assert torch.equal(got[1], torch.tensor([0.6, 0.8]))
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    normal_rows(a, 50, 3, torch.float32)
    torch.randn((50, 3), generator=b)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


# ------------------------------------------------------------- the wrapper


def small_pass():
    """An attraction pass's inputs over a random graph with a hub and every
    fifth edge's endpoints made to coincide, one zero draw among them."""
    rng = np.random.default_rng(11)
    n = 300
    hub = np.stack([np.zeros(50, np.int64), rng.choice(np.arange(1, n), 50, replace=False)], 1)
    g = from_edges(np.r_[rng.integers(0, n, size=(3 * n, 2)), hub], num_vertices=n)
    pos = rng.normal(size=(n, 3))
    src, dst = g.edge_src, g.col_idx
    pos[dst[::5]] = pos[src[::5]]
    kicks = rng.normal(size=(src.shape[0], 3))
    coincident = np.flatnonzero(np.all(pos[src] == pos[dst], axis=1))
    kicks[coincident[0]] = 0.0
    args = [torch.tensor(pos), torch.tensor(rng.uniform(0.5, 1.5, n)), torch.tensor(src, dtype=torch.int64),
            torch.tensor(dst, dtype=torch.int64), torch.tensor(np.asarray(g.row_ptr, np.int64))]
    return args, torch.tensor(kicks), coincident


def test_kicked_rows_are_unit_rows_of_the_draw():
    """The plain pass, given the raw draw, kicks a coincident edge by its
    draw's unit row (a zero draw adds nothing) and reads no other draw;
    with a schedule it gives the same results (the schedule only steers
    the kernel); a draw scaled by 2 kicks by the same bits."""
    from wembed_tpu_torch.core import EmbedderOptions
    from wembed_tpu_torch.core.edge_geometry import edge_attraction, edge_geometry, segment_sum

    args, kicks, coincident = small_pass()
    pos, inv_w, src, dst, row_ptr = args
    opts = EmbedderOptions(embedding_dimension=3)
    schedule = EdgeSchedules(row_ptr.numpy(), dst).get()
    out = ep.edge_pass("attraction", *args, opts, kicks=kicks, schedule=schedule)
    bare = ep.edge_pass("attraction", *args, opts, kicks=kicks)
    assert torch.equal(out.force, bare.force) and torch.equal(out.att_loss, bare.att_loss)
    diff, dist2 = edge_geometry(pos, src, dst)
    force_e, _ = edge_attraction(diff, dist2, inv_w[src], inv_w[dst], opts, kicks)
    assert torch.equal(force_e[coincident], unit_rows(kicks)[coincident])
    assert torch.equal(force_e[coincident[0]], torch.zeros(3, dtype=force_e.dtype))
    assert torch.equal(segment_sum(force_e, row_ptr), out.force)
    assert torch.equal(ep.edge_pass("attraction", *args, opts, kicks=2 * kicks).force, out.force)
    other = kicks.clone()
    keep = torch.ones(kicks.shape[0], dtype=torch.bool)
    keep[coincident] = False
    other[keep] = 7.0
    assert torch.equal(ep.edge_pass("attraction", *args, opts, kicks=other).force, out.force)


@pytest.mark.parametrize("change", ["vertices", "edges", "dtype"])
def test_wrapper_rejects_a_schedule_of_other_edges(change):
    from wembed_tpu_torch.core import EmbedderOptions

    args, kicks, _ = small_pass()
    row_ptr = args[4].numpy()
    if change == "vertices":
        schedule = edge_schedule(np.r_[row_ptr, row_ptr[-1]], args[3])
    elif change == "edges":
        schedule = EdgeSchedules(row_ptr, args[3]).get(0, 10)
    else:
        schedule = edge_schedule(row_ptr, args[3])._replace(dst=args[3])
    with pytest.raises((ValueError, TypeError)):
        ep.edge_pass("attraction", *args, EmbedderOptions(embedding_dimension=3), kicks=kicks, schedule=schedule)
