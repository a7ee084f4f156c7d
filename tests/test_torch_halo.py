"""The vertex-sharded halo backend on gloo ranks on the CPU: its plan against
the JAX package's, 2 and 4 ranks (spawned once each,
``distributed/launch.py``) against the single-device port on the dense,
span, resident, sampled and partial-index paths, the JAX package's
``HaloEmbedder`` against 2 ranks, what each rank holds, a halo checkpoint
continued on one device and on 4 ranks, starved windows that grow back,
the resident sweep against the whole sweep, and the API and CLI on one
rank and the CLI on 2."""

import os

import numpy as np
import pytest
import torch

from test_torch_embedder import _no_coincident_pairs

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import RepulsionMode as JaxRepulsionMode
from wembed_tpu.distributed import halo as jax_halo
from wembed_tpu.distributed import make_mesh as jax_make_mesh
from wembed_tpu.graphs import from_edges as jax_from_edges
from wembed_tpu.graphs import generators as jax_generators

from wembed_tpu_torch import api
from wembed_tpu_torch.cli import embed
from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder
from wembed_tpu_torch.core.checkpoint import load_checkpoint
from wembed_tpu_torch.core.step import Share
from wembed_tpu_torch.core.weights import initial_weights
from wembed_tpu_torch.distributed import HaloEmbedder, HaloPlan, run_ranks
from wembed_tpu_torch.distributed import halo
from wembed_tpu_torch.distributed.launch import run_halo
from wembed_tpu_torch.graphs.csr import CSRGraph
from wembed_tpu_torch.kernels.span_sparse import SpanIndex, _sweep, block_items, build_span_structures
from wembed_tpu_torch.kernels.span_sweep import Q, span_sweep
from wembed_tpu_torch.utils import set_seed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
SEED = 33
PATHS = {
    "dense": dict(repulsion_mode=RepulsionMode.DENSE),
    "span": dict(repulsion_mode=RepulsionMode.BUCKET),
    "resident": dict(repulsion_mode=RepulsionMode.BUCKET, halo_resident_structures=True),
    "sampled": dict(num_negative_samples=5),
    "partial": dict(repulsion_mode=RepulsionMode.BUCKET, index_size=0.5),
}
EXPECTED_PATH = {"dense": "dense", "sampled": "sampled"}  # the others: "span"
CHECKPOINT_AT = 3


def _graph(n=300):
    """(JAX graph, the same graph as the port's CSRGraph, coordinates)."""
    rng = np.random.default_rng(5)
    g_j, _ = jax_generators.geometric_graph(n, rng=rng)
    g = CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)
    coords = rng.uniform(0, g.num_vertices ** 0.5, size=(g.num_vertices, 2))
    return g_j, g, coords


def _skewed_graph():
    """A GIRG with a hub grafted onto half its vertices
    (``tests/test_distributed.py:test_halo_plan_skewed_degrees``)."""
    rng = np.random.default_rng(13)
    g, _, _ = jax_generators.girg(400, dim=2, avg_degree=12, ple=2.1, rng=rng)
    n = g.num_vertices
    pairs = np.stack([g.edge_src, g.col_idx], axis=1)[g.edge_src < g.col_idx]
    existing = set(map(tuple, pairs.tolist()))
    extra = [(0, v) for v in range(1, n, 2) if (0, v) not in existing]
    return jax_from_edges(np.concatenate([pairs, np.asarray(extra, np.int64).reshape(-1, 2)]), num_vertices=n)


def _options(path, **kw):
    return EmbedderOptions(
        embedding_dimension=2, dtype="float64", max_iterations=30, position_min_change=0.0,
        **PATHS[path], **kw,
    )


def _single(g, coords, opts, steps, check_kicks=False):
    set_seed(SEED)
    emb = WEmbedEmbedder(
        g, opts, initial_coordinates=coords, initial_weights=initial_weights(g, opts),
        verbose=False, device="cpu",
    )
    for _ in range(steps):
        if check_kicks:
            assert _no_coincident_pairs(emb)
        emb.calculate_step()
    return emb


def _starved():
    """A 500-vertex graph (``tests/test_distributed.py:
    test_halo_overflow_growth_recovers``), run from empty windows."""
    rng = np.random.default_rng(7)
    g_j, _ = jax_generators.geometric_graph(500, rng=rng)
    g = CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)
    coords = rng.uniform(0, g.num_vertices ** 0.5, size=(g.num_vertices, 2))
    opts = EmbedderOptions(
        embedding_dimension=2, dtype="float64", repulsion_mode=RepulsionMode.BUCKET,
        max_iterations=60, position_min_change=1e-4, window_capacity=1,
    )
    return g, coords, opts


def _cli_argv(graph_path, out, *extra):
    return ["-i", graph_path, "-o", out, "--seed", "1", "--dim", "2", "--iterations", "2", *extra]


def _jobs_then_cli(mesh, jobs, argv):
    """``run_halo``'s jobs, then the embed CLI with ``argv`` on every rank
    of the same group."""
    out = run_halo(mesh, jobs)
    assert embed.main(argv, device="cpu") == 0
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every halo job on 2 ranks and on 4, one spawn each: STEPS steps of
    each path; on 2 ranks also the span run checkpointed after
    CHECKPOINT_AT steps, a run from empty windows to convergence and the
    CLI with ``--distributed halo`` on the geometric graph's edge list; on
    4 ranks the span run resumed from that checkpoint."""
    _, g, coords = _graph()
    tmp = tmp_path_factory.mktemp("halo")
    edges = str(tmp / "graph.edg")
    np.savetxt(edges, np.stack([g.edge_src, g.col_idx], axis=1)[g.edge_src < g.col_idx], fmt="%d")
    cli_out = str(tmp / "cli.csv")
    jobs = [
        dict(graph=g, options=_options(p), coords=coords, weights=initial_weights(g, _options(p)),
             seed=SEED, steps=STEPS)
        for p in PATHS
    ]
    ckpt = str(tmp / "span.npz")
    span = jobs[list(PATHS).index("span")]
    sg, scoords, sopts = _starved()
    set_seed(SEED)
    skeleton = SpanIndex.build(initial_weights(sg, sopts), sopts, sg.edge_src, sg.col_idx)
    starved = dict(graph=sg, options=sopts, coords=scoords, weights=initial_weights(sg, sopts),
                   seed=SEED, steps=None, windows=np.zeros_like(skeleton.blk_t))
    two = run_ranks(_jobs_then_cli, 2, "gloo", "cpu", threads=1, args=(
        [*jobs, dict(span, steps=CHECKPOINT_AT, checkpoint=ckpt), starved],
        _cli_argv(edges, cli_out, "--distributed", "halo"),
    ))
    resumed = dict(span, seed=99, coords=None, resume=ckpt, steps=STEPS - CHECKPOINT_AT)
    four = run_ranks(run_halo, 4, "gloo", "cpu", threads=1, args=([*jobs, resumed],))
    return {2: two, 4: four, "checkpoint": ckpt, "edges": edges, "cli": cli_out}


# ------------------------------------------------------------------ the plan


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("graph", ["geometric", "skewed"])
def test_plan_equals_the_jax_plan(graph, ranks):
    """``HaloPlan.build`` gives the JAX package's plan, array for array."""
    g_j = _graph()[0] if graph == "geometric" else _skewed_graph()
    g = CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)
    want, got = jax_halo.HaloPlan.build(g_j, ranks), HaloPlan.build(g, ranks)
    for field in ("n", "n_pad", "R", "P", "H", "E_s"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("edge_src_local", "edge_dst_ext", "edge_dst_global", "edge_mask", "send_idx",
                  "local_row_ptr", "edge_goff"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert int(got.edge_mask.sum()) == g.num_directed_edges


def test_plan_raises_on_a_miscomputed_halo_capacity(monkeypatch):
    """Both plans raise ``AssertionError`` when the halo capacity H is too
    small for a rank's halo list (here: H forced to its floor of 8)."""
    g_j = _skewed_graph()
    g = CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)
    for module in (halo, jax_halo):
        real = module._round_up
        monkeypatch.setattr(module, "_round_up", lambda x, m, real=real: 0 if m == 8 else real(x, m))
    for build, graph in ((HaloPlan.build, g), (jax_halo.HaloPlan.build, g_j)):
        with pytest.raises(AssertionError, match="halo capacity"):
            build(graph, 2)


# ------------------------------------------------------------------ the steps


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("ranks", [2, 4])
def test_halo_steps_match_single_device(runs, ranks, path):
    """P halo ranks each step their rows and gather the same positions, the
    single-device port's within rtol 1e-9 (f64: the partials add up in
    another order), while no kick fires; counts and overflow exact."""
    _, g, coords = _graph()
    j = list(PATHS).index(path)
    opts = _options(path)
    single = _single(g, coords, opts, STEPS, check_kicks=path == "dense")
    results = [rank_results[j] for rank_results in runs[ranks]]
    loss = single.get_loss()
    for r, got in enumerate(results):
        assert got["rank"] == r and got["size"] == ranks
        assert got["path"] == EXPECTED_PATH.get(path, "span") == single.path
        assert got["iterations"] == STEPS
        np.testing.assert_array_equal(got["positions"], results[0]["positions"])
        np.testing.assert_allclose(got["positions"], single.get_coordinates(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got["attract_loss"], loss.attractive, rtol=1e-9)
        np.testing.assert_allclose(got["repel_loss"], loss.repulsive, rtol=1e-9, atol=1e-12)
        assert got["num_rep_forces"] == int(single.state.num_rep_forces) > 0
        assert got["overflow"] == int(single.state.overflow) == 0


@pytest.mark.parametrize("ranks", [2, 4])
def test_each_rank_holds_its_rows_and_its_correction_edges(runs, ranks):
    """A rank holds R = ceil(n / P) rows of positions and of each moment,
    and on the span path only its ceil(E / P) correction edges."""
    _, g, _ = _graph()
    R = -(-g.num_vertices // ranks)
    per = -(-g.num_directed_edges // ranks)
    for rank_results in runs[ranks]:
        for j, path in enumerate(PATHS):
            held = rank_results[j]["held"]
            assert held["rows"] == held["moments"] == (R, 2), path
            if EXPECTED_PATH.get(path, "span") == "span":
                cut = Share(rank_results[j]["rank"], ranks, None).cut(g.num_directed_edges)
                assert held["correction_edges"] == cut[1] - cut[0] <= per, path


def test_jax_halo_embedder_matches_two_ranks(runs):
    """The JAX package's ``HaloEmbedder`` (dense, f64) on a 2-device
    virtual mesh against the port's 2 halo ranks, from the same coordinates
    and weights, within rtol 1e-9 while no kick fires."""
    g_j, g, coords = _graph()
    opts = _options("dense")
    w = initial_weights(g, opts)
    jopts = JaxOptions(
        embedding_dimension=2, dtype="float64", repulsion_mode=JaxRepulsionMode.DENSE,
        max_iterations=30, position_min_change=0.0,
    )
    ref = jax_halo.HaloEmbedder(g_j, jopts, mesh=jax_make_mesh(2), initial_coordinates=coords,
                                initial_weights=w, verbose=False)
    single = _single(g, coords, opts, 0)
    for _ in range(STEPS):
        assert _no_coincident_pairs(single)
        single.calculate_step()
        ref.calculate_step()
    got = runs[2][0][list(PATHS).index("dense")]
    np.testing.assert_allclose(got["positions"], ref.get_coordinates(), rtol=1e-9, atol=1e-9)
    assert got["num_rep_forces"] == int(ref.state.num_rep_forces)
    # the JAX package sums its losses in f32
    np.testing.assert_allclose(got["attract_loss"], float(ref.state.attract_loss), rtol=1e-5)


def test_halo_checkpoint_continues_on_one_device_and_four_ranks(runs):
    """Two span ranks wrote a checkpoint after CHECKPOINT_AT steps; a
    single-device embedder (another seed) and 4 halo ranks each load it and
    continue to STEPS, within rtol 1e-9 of the uninterrupted 2-rank run,
    counts exact."""
    _, g, _ = _graph()
    opts = _options("span")
    j = list(PATHS).index("span")
    checkpointed, got = runs[2][0][len(PATHS)], runs[2][0][j]
    assert checkpointed["iterations"] == CHECKPOINT_AT < STEPS == got["iterations"]
    set_seed(99)
    resumed = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    load_checkpoint(runs["checkpoint"], resumed)
    assert resumed.iteration == CHECKPOINT_AT
    np.testing.assert_array_equal(resumed.get_coordinates(), checkpointed["positions"])
    for _ in range(STEPS - CHECKPOINT_AT):
        resumed.calculate_step()
    four = [rank_results[len(PATHS)] for rank_results in runs[4]]
    for other in (dict(positions=resumed.get_coordinates(),
                       num_rep_forces=int(resumed.state.num_rep_forces)), *four):
        np.testing.assert_allclose(other["positions"], got["positions"], rtol=1e-9, atol=1e-9)
        assert other["num_rep_forces"] == got["num_rep_forces"]
    assert all(r["iterations"] == STEPS for r in four)


def test_starved_windows_grow_back_on_two_ranks(runs):
    """Empty windows overflow on 2 halo ranks; the growth protocol widens
    them alike on both, and the run ends with overflow 0."""
    last = [rank_results[-1] for rank_results in runs[2]]
    for got in last:
        assert got["path"] == "span" and got["growth_events"] > 0
        assert got["overflow"] == 0 and np.isfinite(got["positions"]).all()
        np.testing.assert_array_equal(got["positions"], last[0]["positions"])
    assert last[0]["growth_events"] == last[1]["growth_events"]


# ------------------------------------------------------- the resident sweep


def _sweep_case(n=3000, seed=3):
    rng = np.random.default_rng(seed)
    g_j, _ = jax_generators.geometric_graph(n, rng=rng)
    g = CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)
    opts = EmbedderOptions(embedding_dimension=2, dtype="float64", repulsion_mode=RepulsionMode.BUCKET)
    w = initial_weights(g, opts)
    idx = SpanIndex.build(w, opts, g.edge_src, g.col_idx)
    pos = torch.as_tensor(rng.uniform(0, 0.4 * n ** 0.5, size=(n, 2)))
    weights = torch.as_tensor(w)
    inv_w = torch.as_tensor(1.0 / np.sqrt(w))
    colors = torch.as_tensor(g.colors, dtype=torch.int32)
    s = build_span_structures(pos, inv_w, weights, colors, idx, opts)
    return idx, opts, s


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_resident_sweep_equals_the_whole_sweep_on_its_blocks(ranks):
    """Each rank's items of its query blocks ``Share.cut(nb)``
    (``block_items``) are the whole table's items of those blocks, and the
    ranks' slices tile the table.  Swept alone, a rank's items give the
    whole sweep's slots of its blocks bit for bit and zeros elsewhere, so
    the ranks' per-vertex partials add up to the whole sweep's bit for
    bit, since each vertex's slot is one rank's; the candidate counts add
    up exactly."""
    idx, opts, s = _sweep_case()
    assert idx.nb >= 2 * ranks
    t = idx.tensors(s.qrec.device)
    table = idx.work_items(s.qrec.device)
    kw = dict(dim=idx.d, L=opts.edge_length, rep_scale=opts.repulsion_scale, additive=False)
    whole = span_sweep(s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off,
                       items=table, **kw)
    parts, end = [], 0
    for rank in range(ranks):
        b0, b1 = Share(rank, ranks, None).cut(idx.nb)
        lo, hi = block_items(idx, b0, b1)
        assert lo == end < hi
        end = hi
        mine = table[lo:hi]
        assert int(mine[:, 0].min()) >= b0 and int(mine[:, 0].max()) < b1
        part = span_sweep(s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off,
                          items=mine, **kw)
        for got, want in zip(part, whole):
            assert torch.equal(got[b0 * Q : b1 * Q], want[b0 * Q : b1 * Q])
            assert not got[: b0 * Q].any() and not got[b1 * Q :].any()
        parts.append(_sweep(s, idx, opts, mine))
    assert end == table.shape[0]
    force, loss, count, zero = (sum(part[i] for part in parts) for i in range(4))
    want = _sweep(s, idx, opts)
    assert torch.equal(force, want[0]) and torch.equal(zero, want[3])
    assert int(count) == int(want[2]) > 0
    np.testing.assert_allclose(float(loss), float(want[1]), rtol=1e-12)  # summed in another order


# --------------------------------------------------------- the API and CLI


def _api_run(g, mode, layered, min_layer=4096):
    api.setSeed(5)
    options = api.Options(
        embeddingDimension=2, layeredEmbedding=layered, maxIterations=1 if layered else 2,
        distributedMode=mode, distributedMinLayerSize=min_layer,
    )
    emb = api.createEmbedder(api.Graph(g), options, device="cpu")
    emb.calculateEmbedding()
    return emb


@pytest.mark.parametrize("layered", [False, True])
def test_api_halo_on_one_rank(layered):
    """``createEmbedder(distributedMode="halo")`` on one rank (a real
    one-rank gloo group) follows the single-device run: the same
    iterations and candidate counts, positions within f32 rounding after
    two flat steps or one step a layer (f32 steps amplify rounding ~5x
    each, and the halo step sums attraction apart from repulsion).  With a small
    ``distributedMinLayerSize`` the finest layers run on the halo backend
    and the coarse ones on one device."""
    from wembed_tpu_torch.graphs import generators

    g = generators.girg(400, dim=2, avg_degree=8, ple=2.5, rng=np.random.default_rng(2))[0]
    single = _api_run(g, "none", layered)
    sharded = _api_run(g, "halo", layered, min_layer=50)
    want = np.asarray(single.getCoordinates())
    np.testing.assert_allclose(np.asarray(sharded.getCoordinates()), want, rtol=0, atol=1e-4 * np.abs(want).max())
    impl = sharded.impl
    assert impl.iteration == single.impl.iteration
    if layered:
        assert isinstance(impl._current, HaloEmbedder) and impl.mesh is impl._current.mesh
        sizes = [r.n for r in impl.layer_records]
        assert sum(n >= 50 for n in sizes) >= 2 and min(sizes) < 50
    else:
        assert isinstance(impl, HaloEmbedder) and impl.mesh.size == 1 and impl.plan.P == 1
        assert int(impl.state.num_rep_forces) == int(single.impl.state.num_rep_forces)


def test_cli_halo_on_one_rank(tmp_path):
    """``embed --distributed halo`` on one rank writes the single-device
    CLI's rows, within f32 rounding after two steps."""
    graph = os.path.join(REPO, "assets", "small_graph.edg")
    outs = []
    for extra in ([], ["--distributed", "halo", "--num-devices", "1"]):
        out = str(tmp_path / f"emb{len(extra)}.csv")
        assert embed.main(_cli_argv(graph, out, *extra), device="cpu") == 0
        outs.append(np.loadtxt(out, delimiter=","))
    assert outs[0].shape == outs[1].shape == (5, 4)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


def test_cli_halo_on_two_ranks(runs, tmp_path):
    """``embed --distributed halo`` on 2 ranks (every rank gathers the
    coordinates, rank 0 writes them) writes the single-device CLI's rows of
    the 300-vertex graph, within f32 rounding after two steps."""
    out = str(tmp_path / "emb.csv")
    assert embed.main(_cli_argv(runs["edges"], out), device="cpu") == 0
    want, got = np.loadtxt(out, delimiter=","), np.loadtxt(runs["cli"], delimiter=",")
    assert got.shape == want.shape == (300, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
