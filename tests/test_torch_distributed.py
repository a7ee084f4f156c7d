"""The replicated multi-device backend on gloo ranks on the CPU: 2 and 4
ranks (spawned once each, ``distributed/launch.py``) against the
single-device port on the dense, span and sampled paths, the JAX package's
sharded step against 2 ranks, a replicated checkpoint continued on one
device, and the API and CLI on one rank."""

import os

import numpy as np
import pytest
import torch

from test_torch_embedder import _no_coincident_pairs

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import RepulsionMode as JaxRepulsionMode
from wembed_tpu.core import WEmbedEmbedder as JaxEmbedder
from wembed_tpu.distributed import build_multichip_step
from wembed_tpu.distributed import make_mesh as jax_make_mesh
from wembed_tpu.graphs import generators as jax_generators

from wembed_tpu_torch import api
from wembed_tpu_torch.cli import embed
from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder
from wembed_tpu_torch.core.checkpoint import load_checkpoint
from wembed_tpu_torch.core.step import Share
from wembed_tpu_torch.core.weights import initial_weights
from wembed_tpu_torch.distributed import Mesh, MultiChipEmbedder, run_ranks
from wembed_tpu_torch.distributed.launch import run_replicated
from wembed_tpu_torch.graphs import generators
from wembed_tpu_torch.graphs.csr import CSRGraph
from wembed_tpu_torch.utils import set_seed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
SEED = 33
PATHS = {
    "dense": dict(repulsion_mode=RepulsionMode.DENSE),
    "span": dict(repulsion_mode=RepulsionMode.BUCKET),
    "sampled": dict(num_negative_samples=5),
}
CHECKPOINT_AT = 3


def _graph():
    """(JAX graph, the same graph as the port's CSRGraph, coordinates)."""
    rng = np.random.default_rng(5)
    g_j, _ = jax_generators.geometric_graph(300, rng=rng)
    g = CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)
    coords = rng.uniform(0, g.num_vertices ** 0.5, size=(g.num_vertices, 2))
    return g_j, g, coords


def _options(path):
    return EmbedderOptions(
        embedding_dimension=2, dtype="float64", max_iterations=30, position_min_change=0.0,
        **PATHS[path],
    )


def _single(g, coords, opts, steps):
    set_seed(SEED)
    emb = WEmbedEmbedder(
        g, opts, initial_coordinates=coords, initial_weights=initial_weights(g, opts),
        verbose=False, device="cpu",
    )
    for _ in range(steps):
        emb.calculate_step()
    return emb


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every replicated job on 2 ranks and on 4, one spawn each: STEPS steps
    of each path, and on 2 ranks the dense run again, checkpointed after
    CHECKPOINT_AT steps."""
    _, g, coords = _graph()
    jobs = [
        dict(graph=g, options=_options(p), coords=coords, weights=initial_weights(g, _options(p)),
             seed=SEED, steps=STEPS)
        for p in PATHS
    ]
    ckpt = str(tmp_path_factory.mktemp("replicated") / "dense.npz")
    with_ckpt = [*jobs, dict(jobs[0], steps=CHECKPOINT_AT, checkpoint=ckpt)]
    return {
        2: run_ranks(run_replicated, 2, "gloo", "cpu", args=(with_ckpt,), threads=1),
        4: run_ranks(run_replicated, 4, "gloo", "cpu", args=(jobs,), threads=1),
        "checkpoint": ckpt,
    }


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("ranks", [2, 4])
def test_replicated_steps_match_single_device(runs, ranks, path):
    """P ranks each compute a share of the force pass and reduce it; every
    rank ends with the same state, and that state is the single-device
    port's within rtol 1e-9 (f64: the shares add up in another order),
    counts exactly.  On the dense path each row is one rank's, so the
    positions are the single-device ones bit for bit."""
    _, g, coords = _graph()
    j = list(PATHS).index(path)
    single = _single(g, coords, _options(path), STEPS)
    results = [rank_results[j] for rank_results in runs[ranks]]
    for r, got in enumerate(results):
        assert got["rank"] == r and got["size"] == ranks and got["path"] == path
        assert got["iterations"] == STEPS
        np.testing.assert_array_equal(got["positions"], results[0]["positions"])
        np.testing.assert_allclose(got["positions"], single.get_coordinates(), rtol=1e-9, atol=1e-9)
        loss = single.get_loss()
        np.testing.assert_allclose(got["attract_loss"], loss.attractive, rtol=1e-9)
        np.testing.assert_allclose(got["repel_loss"], loss.repulsive, rtol=1e-9, atol=1e-12)
        assert got["num_rep_forces"] == int(single.state.num_rep_forces) > 0
        assert got["overflow"] == 0
    if path == "dense":
        np.testing.assert_array_equal(results[0]["positions"], single.get_coordinates())
    # the shares of the ranks cut every pass into contiguous, covering ranges
    for key in ("dense_rows", "edges", "work_items"):
        if key in results[0]["shares"]:
            cuts = [res["shares"][key] for res in results]
            assert cuts[0][0] == 0 and all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    if path == "span":
        assert results[-1]["shares"]["work_items"][1] == results[0]["shares"]["total_items"]


@pytest.mark.parametrize("total,size", [(0, 2), (3, 4), (10, 3), (10000, 4)])
def test_share_cuts_cover_every_item_once(total, size):
    cuts = [Share(r, size, None).cut(total) for r in range(size)]
    assert cuts[0][0] == 0 and cuts[-1][1] == total
    assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(cuts, cuts[1:]))
    assert max(b - a for a, b in cuts) == -(-total // size)


def test_jax_sharded_dense_step_matches_two_ranks(runs):
    """The JAX package's ``build_multichip_step`` on a 2-device virtual mesh
    against the port's 2 ranks on the dense path, from the same
    coordinates and weights, within rtol 1e-9 while no kick fires."""
    g_j, g, coords = _graph()
    opts = _options("dense")
    w = initial_weights(g, opts)
    jopts = JaxOptions(
        embedding_dimension=2, dtype="float64", repulsion_mode=JaxRepulsionMode.DENSE,
        max_iterations=30, position_min_change=0.0,
    )
    holder = JaxEmbedder(g_j, jopts, initial_coordinates=coords, initial_weights=w, verbose=False)
    run, _, _ = build_multichip_step(g_j, jopts, w, jax_make_mesh(2))
    state = holder.state
    single = _single(g, coords, opts, 0)
    for _ in range(STEPS):
        assert _no_coincident_pairs(single)
        single.calculate_step()
        state = run(state, holder._weights, holder._inv_w)
    got = runs[2][0][0]
    np.testing.assert_allclose(got["positions"], np.asarray(state.positions), rtol=1e-9, atol=1e-9)
    assert got["num_rep_forces"] == int(state.num_rep_forces)
    # the JAX package sums its losses in f32
    np.testing.assert_allclose(got["attract_loss"], float(state.attract_loss), rtol=1e-5)


def test_replicated_checkpoint_continues_on_one_device(runs):
    """Rank 0 of a 2-rank dense run wrote a checkpoint after CHECKPOINT_AT
    steps; a single-device embedder built from another seed loads it and
    continues to the end of the uninterrupted replicated run (STEPS), bit
    for bit (each dense row is one rank's, so the replicated steps are the
    single-device ones)."""
    _, g, coords = _graph()
    opts = _options("dense")
    checkpointed, got = runs[2][0][-1], runs[2][0][0]
    assert checkpointed["iterations"] == CHECKPOINT_AT < STEPS == got["iterations"]
    set_seed(99)
    resumed = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    load_checkpoint(runs["checkpoint"], resumed)
    assert resumed.iteration == CHECKPOINT_AT
    np.testing.assert_array_equal(resumed.get_coordinates(), checkpointed["positions"])
    for _ in range(STEPS - CHECKPOINT_AT):
        resumed.calculate_step()
    np.testing.assert_array_equal(resumed.get_coordinates(), got["positions"])
    assert int(resumed.state.num_rep_forces) == got["num_rep_forces"]


def _api_run(g, mode, layered, min_layer=4096):
    api.setSeed(5)
    options = api.Options(
        embeddingDimension=2, layeredEmbedding=layered, maxIterations=12,
        distributedMode=mode, distributedMinLayerSize=min_layer,
    )
    emb = api.createEmbedder(api.Graph(g), options, device="cpu")
    emb.calculateEmbedding()
    return emb


@pytest.mark.parametrize("layered", [False, True])
def test_api_replicated_on_one_rank(layered, monkeypatch):
    """``createEmbedder(distributedMode="replicated")`` on one rank (a real
    one-rank gloo group) gives the single-device run bit for bit, flat and
    layered; with a small ``distributedMinLayerSize`` the finest layer runs
    on the replicated backend and the coarse ones on one device.  The ranks
    take rank 0's host stream once a run, however many layers replicate."""
    g = generators.girg(400, dim=2, avg_degree=8, ple=2.5, rng=np.random.default_rng(2))[0]
    single = _api_run(g, "none", layered)
    shared = []
    share = Mesh.share_host_stream
    monkeypatch.setattr(Mesh, "share_host_stream", lambda mesh: shared.append(share(mesh)))
    replicated = _api_run(g, "replicated", layered, min_layer=50)
    assert len(shared) == 1
    np.testing.assert_array_equal(
        np.asarray(replicated.getCoordinates()), np.asarray(single.getCoordinates())
    )
    assert replicated.getLoss().total == single.getLoss().total
    impl = replicated.impl
    if layered:
        assert isinstance(impl._current, MultiChipEmbedder) and impl.mesh is impl._current.mesh
        sizes = [r.n for r in impl.layer_records]
        assert sum(n >= 50 for n in sizes) >= 2  # replicated layers, each built without a broadcast
        assert sizes[-1] == g.num_vertices and min(sizes) < 50
        assert impl.iteration == single.impl.iteration
    else:
        assert isinstance(impl, MultiChipEmbedder) and impl.mesh.size == 1
        assert impl.iteration == single.impl.iteration == 12


def test_cli_replicated_on_one_rank(tmp_path):
    """``embed --distributed replicated`` on one rank writes the CSV of the
    single-device CLI."""
    graph = os.path.join(REPO, "assets", "small_graph.edg")
    outs = []
    for extra in ([], ["--distributed", "replicated", "--num-devices", "1"]):
        out = str(tmp_path / f"emb{len(extra)}.csv")
        assert embed.main(["-i", graph, "-o", out, "--seed", "1", "--dim", "2", *extra], device="cpu") == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 5


def test_run_ranks_runs_on_the_card_unless_asked(monkeypatch):
    """``run_ranks`` puts its ranks on the card by default and raises, before
    it spawns anything, where there is none; the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks(run_replicated, 2, args=([],))


@pytest.mark.parametrize(
    "options,error,match",
    [
        (api.Options(distributedMode="replicated", numDevices=2), ValueError, "numDevices=2"),
        (api.Options(distributedMode="halo", numDevices=2), ValueError, "numDevices=2"),
        (api.Options(distributedMode="ring"), ValueError, "unknown distributedMode"),
    ],
)
def test_replicated_api_refuses(options, error, match):
    g = generators.girg(100, dim=2, avg_degree=8, ple=2.5, rng=np.random.default_rng(3))[0]
    with pytest.raises(error, match=match):
        api.createEmbedder(api.Graph(g), options, device="cpu")
