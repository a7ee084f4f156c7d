"""The profiled (phase-split) step of the port: the same trajectory as the
normal step on the dense, span and sampled paths, the JAX package's timer
tree for the same calls, and ``embed --profile-timings``
(the counterpart of tests/test_core.py:test_profiled_step_matches_normal_step)."""

import os

import numpy as np
import pytest
import torch

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import RepulsionMode as JaxRepulsionMode
from wembed_tpu.core import WEmbedEmbedder as JaxEmbedder
from wembed_tpu.graphs import generators as jax_generators

from wembed_tpu_torch.cli import embed as embed_cli
from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder
from wembed_tpu_torch.core import step as step_mod
from wembed_tpu_torch.graphs.csr import CSRGraph
from wembed_tpu_torch.multilevel import LayeredEmbedder
from wembed_tpu_torch.utils import Timer, set_seed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_GRAPH = os.path.join(REPO, "assets", "small_graph.edg")
PHASES = ["attracting_forces", "repelling_forces", "apply_forces", "gravity", "position_change"]
PATHS = {
    "dense": dict(repulsion_mode=RepulsionMode.DENSE),
    "span": dict(repulsion_mode=RepulsionMode.BUCKET),
    "sampled": dict(num_negative_samples=6),
}


def _graphs(n=200, seed=42):
    """(JAX graph, the same graph as the port's CSRGraph, coordinates)."""
    rng = np.random.default_rng(seed)
    g_j, _ = jax_generators.geometric_graph(n, rng=rng)
    n = g_j.num_vertices
    return g_j, CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors), rng.uniform(0, n ** 0.5, size=(n, 2))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_profiled_step_matches_normal_step(path):
    """Six steps, positions within rtol 1e-9, losses within rtol 1e-5,
    counts equal.  The span and sampled steps draw the same kicks and
    candidates in both modes; the profiled dense step also draws the edge
    kicks (its normal step's kernel does attraction and draws none), which
    changes nothing while no pair coincides."""
    _, g, coords = _graphs()
    opts = EmbedderOptions(embedding_dimension=2, dtype="float64", **PATHS[path])
    runs = []
    for profile in (False, True):
        set_seed(9)
        emb = WEmbedEmbedder(g, opts, initial_coordinates=coords, verbose=False, profile=profile, device="cpu")
        assert emb.path == path
        for _ in range(6):
            emb.calculate_step()
        runs.append(emb)
    normal, profiled = runs
    np.testing.assert_allclose(profiled.get_coordinates(), normal.get_coordinates(), rtol=1e-9, atol=1e-9)
    for name in ("attract_loss", "repel_loss"):
        np.testing.assert_allclose(
            float(getattr(profiled.state, name)), float(getattr(normal.state, name)), rtol=1e-5
        )
    assert int(profiled.state.num_rep_forces) == int(normal.state.num_rep_forces) > 0
    assert int(profiled.state.overflow) == int(normal.state.overflow) == 0
    names = [t.display_name for t in profiled.get_timings()]
    assert names == (["index"] if path == "span" else []) + PHASES
    assert all(t.value > 0 for t in profiled.get_timings())
    assert [t.display_name for t in normal.get_timings()] == ["Embedding step"]


def _tree(timings):
    return [(t.depth, t.display_name) for t in timings]


@pytest.mark.parametrize(
    "mode,profile",
    [(RepulsionMode.DENSE, True), (RepulsionMode.BUCKET, True), (RepulsionMode.DENSE, False)],
)
def test_timer_tree_matches_jax(mode, profile):
    """Two steps, then a capped embedding: the same phase names at the same
    depths in the same order as the JAX package's timer."""
    g_j, g_t, coords = _graphs(120, seed=5)
    jax_mode = JaxRepulsionMode[mode.name]
    emb_j = JaxEmbedder(
        g_j, JaxOptions(embedding_dimension=2, dtype="float64", repulsion_mode=jax_mode),
        initial_coordinates=coords, verbose=False, profile=profile,
    )
    emb_t = WEmbedEmbedder(
        g_t, EmbedderOptions(embedding_dimension=2, dtype="float64", repulsion_mode=mode),
        initial_coordinates=coords, verbose=False, profile=profile, device="cpu",
    )
    for emb in (emb_j, emb_t):
        emb.calculate_step()
        emb.calculate_step()
        emb.calculate_embedding(max_iterations=4)
    assert emb_t.iteration == int(emb_j.iteration) == 4
    assert _tree(emb_t.get_timings()) == _tree(emb_j.get_timings())


def test_phase_clock_and_timer_add():
    timer = Timer()
    clock = step_mod.PhaseClock(torch.device("cpu"))
    clock.mark("a")
    clock.mark("b")
    with timer.phase("outer"):
        for name, seconds in clock.seconds():
            timer.add(name, seconds)
        timer.add("a", 1.0)
    assert _tree(timer.results()) == [(0, "outer"), (1, "a"), (1, "b")]
    assert timer.results()[1].value >= 1.0


def test_embed_cli_prints_the_profile_tree(tmp_path, capsys):
    out = tmp_path / "emb.csv"
    rc = embed_cli.main(
        ["-i", SMALL_GRAPH, "-o", str(out), "--seed", "1", "--dim", "2", "--profile-timings"],
        device="cpu",
    )
    assert rc == 0 and out.exists()
    lines = capsys.readouterr().out.splitlines()
    tree = [line for line in lines if line.endswith("s") and ": " in line]
    assert tree[0].startswith("Embedding: ")
    assert [line.split(":")[0].strip() for line in tree[1:]] == PHASES
    assert all(line.startswith("  ") for line in tree[1:])


def test_layered_profile_reaches_every_layer():
    """Set after construction, as the CLI sets it: the current layer's
    embedder and every later one take the profiled step."""
    _, g, _ = _graphs(300, seed=3)
    set_seed(2)
    emb = LayeredEmbedder(g, EmbedderOptions(embedding_dimension=2, max_iterations=5), verbose=False, device="cpu")
    assert not emb._current.profile
    emb.profile = True
    assert emb._current.profile
    emb.calculate_embedding()
    assert emb._current.profile and emb.current_layer == 0
    names = {t.display_name for t in emb.get_timings()}
    assert set(PHASES) <= names and "Embedding step" not in names
