"""Checkpoint and resume in the port: save/load continuations bit for bit on
the dense, span, sampled and layered paths, checkpoints of the JAX package
(flat and layered) continued in the port, the JAX package reading the
port's files, and coordinate CSVs both ways."""

import numpy as np
import pytest
import torch

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import RepulsionMode as JaxRepulsionMode
from wembed_tpu.core import WEmbedEmbedder as JaxEmbedder
from wembed_tpu.core import checkpoint as jax_checkpoint
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.graphs import generators as jax_generators
from wembed_tpu.graphs import io as jax_io
from wembed_tpu.multilevel import LayeredEmbedder as JaxLayered
from wembed_tpu.utils import set_seed as jax_set_seed

from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder
from wembed_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from wembed_tpu_torch.graphs import generators, io
from wembed_tpu_torch.graphs.csr import CSRGraph
from wembed_tpu_torch.multilevel import LayeredEmbedder
from wembed_tpu_torch.utils import set_seed

torch.set_num_threads(1)


def _girg(n=500, seed=3):
    g, _, _ = generators.girg(n, dim=2, avg_degree=10, ple=2.5, rng=np.random.default_rng(seed))
    return g


def _min_pair_distance(pos):
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float(d2.min())


PATHS = {
    "dense": dict(),
    # windows resize at every multiple of 5 iterations; the checkpoint at 10 sits on a boundary
    "span": dict(dense_threshold=100, span_resize_interval=5, window_capacity=4),
    "sampled": dict(num_negative_samples=4),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_flat_resume_is_bitwise(tmp_path, path):
    g = _girg()
    opts = EmbedderOptions(embedding_dimension=2, dtype="float64", max_iterations=30, **PATHS[path])
    set_seed(1)
    saved = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    assert saved.path == path
    saved.calculate_embedding(max_iterations=10)
    ckpt = str(tmp_path / "flat.npz")
    save_checkpoint(ckpt, saved)
    windows = None if saved._index is None else saved._index.blk_t.copy()
    events = (saved.growth_events, saved._shrink_events)
    saved.calculate_embedding()

    set_seed(2)  # another start: everything must come from the file
    resumed = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    load_checkpoint(ckpt, resumed)
    assert resumed.iteration == 10
    if windows is not None:
        # the saved windows, not a presize at the restored positions
        np.testing.assert_array_equal(resumed._index.blk_t, windows)
        assert (resumed.growth_events, resumed._shrink_events) == events
    resumed.calculate_embedding()
    assert resumed.iteration == saved.iteration == 30
    np.testing.assert_array_equal(resumed.get_coordinates(), saved.get_coordinates())
    for name in ("adam_m", "adam_v", "attract_loss", "repel_loss", "pos_change", "num_rep_forces"):
        assert torch.equal(getattr(resumed.state, name), getattr(saved.state, name)), name
    assert resumed.growth_events == saved.growth_events
    assert resumed.final_overflow == saved.final_overflow


def test_span_checkpoint_holds_the_windows_it_ran_with(tmp_path):
    """The span windows decide the sweep's work items, so a resume keeps
    them; a file without them (the JAX package's) presizes instead."""
    g = _girg()
    opts = EmbedderOptions(embedding_dimension=2, dtype="float64", **PATHS["span"])
    set_seed(4)
    emb = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    for _ in range(3):
        emb.calculate_step()
    # starved windows of one tile, which no presize would choose
    emb._swap_index(emb._index._with_blk_t(np.ones_like(emb._index.blk_t)))
    ckpt = str(tmp_path / "span.npz")
    save_checkpoint(ckpt, emb)
    with np.load(ckpt) as data:
        np.testing.assert_array_equal(data["blk_t"], emb._index.blk_t)
        arrays = {k: data[k] for k in data.files if k not in ("blk_t", "growth_events")}
    resumed = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    load_checkpoint(ckpt, resumed)
    np.testing.assert_array_equal(resumed._index.blk_t, emb._index.blk_t)
    np.savez(str(tmp_path / "no_windows.npz"), **arrays)
    presized = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    load_checkpoint(str(tmp_path / "no_windows.npz"), presized)
    assert not np.array_equal(presized._index.blk_t, emb._index.blk_t)
    assert int(presized._span_structures().overflow) == 0


def test_layered_resume_is_bitwise(tmp_path):
    """Checkpoint mid-hierarchy, restore into a layered embedder built with
    another seed: its hierarchy comes from the file, and both continue to
    the end (a span finest layer included) bit for bit."""
    g = _girg(900, seed=5)
    opts = EmbedderOptions(embedding_dimension=2, dtype="float64", max_iterations=12, dense_threshold=300)
    set_seed(1)
    saved = LayeredEmbedder(g, opts, verbose=False, device="cpu")
    layers = saved.hierarchy.num_layers
    assert layers >= 4
    while saved.current_layer > 1:
        saved.calculate_step()
    ckpt = str(tmp_path / "layered.npz")
    save_checkpoint(ckpt, saved)
    saved.calculate_embedding()

    set_seed(9)
    resumed = LayeredEmbedder(g, opts, verbose=False, device="cpu")
    load_checkpoint(ckpt, resumed)
    assert resumed.current_layer == 1
    for a, b in zip(resumed.hierarchy.layers, saved.hierarchy.layers):
        np.testing.assert_array_equal(a.parent, b.parent)
        np.testing.assert_array_equal(a.graph.col_idx, b.graph.col_idx)
    assert [r.layer for r in resumed.layer_records] == [1]
    resumed.calculate_embedding()
    assert [r.layer for r in resumed.layer_records] == [1, 0]
    assert [r.path for r in resumed.layer_records] == ["dense", "span"]
    assert resumed.current_iteration == saved.current_iteration
    np.testing.assert_array_equal(resumed.get_coordinates(), saved.get_coordinates())
    assert resumed.get_loss().total == saved.get_loss().total


def _jax_graphs(n=150, seed=11):
    g_j, _ = jax_generators.geometric_graph(n, rng=np.random.default_rng(seed))
    return g_j, CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors)


@pytest.mark.parametrize("mode", [RepulsionMode.DENSE, RepulsionMode.BUCKET])
def test_jax_flat_checkpoint_continues_in_port(tmp_path, mode):
    """A JAX dense f64 run's checkpoint continues in the port on the dense
    path and on the span path (which presizes its windows from the restored
    positions, and then, untruncated, steps as the dense path does)."""
    g_j, g_t = _jax_graphs()
    n = g_j.num_vertices
    coords = np.random.default_rng(2).uniform(0, n ** 0.5, size=(n, 2))
    w = jax_weights.initial_weights(g_j, JaxOptions(embedding_dimension=2))
    emb_j = JaxEmbedder(
        g_j, JaxOptions(embedding_dimension=2, dtype="float64", repulsion_mode=JaxRepulsionMode.DENSE),
        initial_coordinates=coords, initial_weights=w, verbose=False,
    )
    for _ in range(5):
        emb_j.calculate_step()
    ckpt = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(ckpt, emb_j)

    emb_t = WEmbedEmbedder(
        g_t, EmbedderOptions(embedding_dimension=2, dtype="float64", repulsion_mode=mode),
        verbose=False, device="cpu",
    )
    load_checkpoint(ckpt, emb_t)
    assert emb_t.iteration == 5
    np.testing.assert_array_equal(emb_t.get_coordinates(), emb_j.get_coordinates())
    np.testing.assert_array_equal(emb_t.get_weights(), w)
    for _ in range(5):
        assert _min_pair_distance(emb_t.get_coordinates()) > 0  # no kick fires
        emb_j.calculate_step()
        emb_t.calculate_step()
        assert int(emb_t.state.overflow) == 0
        np.testing.assert_allclose(emb_t.get_coordinates(), emb_j.get_coordinates(), rtol=1e-9, atol=1e-9)
        if mode is RepulsionMode.DENSE:  # the span path counts its per-class radius candidates
            assert int(emb_t.state.num_rep_forces) == int(emb_j.state.num_rep_forces)


def test_jax_layered_checkpoint_continues_in_port(tmp_path):
    """A JAX layered checkpoint restores the same parents, layer and
    positions in the port, whose next steps stay within rtol 1e-9 of the
    JAX package's while no kick fires."""
    g_j, g_t = _jax_graphs(300, seed=3)
    kw = dict(embedding_dimension=2, dtype="float64", max_iterations=8)
    jax_set_seed(11)
    emb_j = JaxLayered(g_j, JaxOptions(**kw), verbose=False)
    while emb_j.current_layer > 1:
        emb_j.calculate_step()
    emb_j.calculate_step()
    ckpt = str(tmp_path / "jax_layered.npz")
    jax_checkpoint.save_checkpoint(ckpt, emb_j)

    set_seed(5)
    emb_t = LayeredEmbedder(g_t, EmbedderOptions(**kw), verbose=False, device="cpu")
    load_checkpoint(ckpt, emb_t)
    assert emb_t.current_layer == emb_j.current_layer == 1
    assert emb_t.current_iteration == emb_j.current_iteration
    assert emb_t.hierarchy.num_layers == emb_j.hierarchy.num_layers
    for a, b in zip(emb_t.hierarchy.layers, emb_j.hierarchy.layers):
        np.testing.assert_array_equal(a.parent, b.parent)
        np.testing.assert_array_equal(a.graph.row_ptr, b.graph.row_ptr)
        np.testing.assert_array_equal(a.graph.col_idx, b.graph.col_idx)
    np.testing.assert_array_equal(emb_t.get_coordinates(), emb_j.get_coordinates())
    assert emb_t._current.iteration == int(emb_j._current.iteration)
    for _ in range(3):
        assert _min_pair_distance(emb_t.get_coordinates()) > 0
        emb_j.calculate_step()
        emb_t.calculate_step()
        assert emb_t.current_layer == emb_j.current_layer == 1
        np.testing.assert_allclose(emb_t.get_coordinates(), emb_j.get_coordinates(), rtol=1e-9, atol=1e-9)


def test_jax_package_reads_port_checkpoint(tmp_path):
    g_j, g_t = _jax_graphs()
    set_seed(3)
    emb_t = WEmbedEmbedder(g_t, EmbedderOptions(embedding_dimension=2, dtype="float64"), verbose=False, device="cpu")
    for _ in range(4):
        emb_t.calculate_step()
    ckpt = str(tmp_path / "port.npz")
    save_checkpoint(ckpt, emb_t)
    emb_j = JaxEmbedder(g_j, JaxOptions(embedding_dimension=2, dtype="float64"), verbose=False)
    jax_checkpoint.load_checkpoint(ckpt, emb_j)
    assert int(emb_j.iteration) == 4
    np.testing.assert_array_equal(emb_j.get_coordinates(), emb_t.get_coordinates())
    np.testing.assert_array_equal(np.asarray(emb_j.state.adam_v), emb_t.state.adam_v.numpy())


def test_checkpoint_kinds_must_match_the_embedder(tmp_path):
    g = _girg(300)
    opts = EmbedderOptions(embedding_dimension=2, max_iterations=5)
    flat = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    layered = LayeredEmbedder(g, opts, verbose=False, device="cpu")
    save_checkpoint(str(tmp_path / "flat"), flat)  # .npz appended
    save_checkpoint(str(tmp_path / "layered"), layered)
    with pytest.raises(ValueError, match="WEmbedEmbedder"):
        load_checkpoint(str(tmp_path / "flat.npz"), layered)
    with pytest.raises(ValueError, match="LayeredEmbedder"):
        load_checkpoint(str(tmp_path / "layered"), flat)
    other = WEmbedEmbedder(_girg(200, seed=8), opts, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="vertices"):
        load_checkpoint(str(tmp_path / "flat"), other)


def test_csv_interop_both_ways(tmp_path):
    """Coordinates with weights written by either package read back bit
    for bit by the other, and continue a run through ``set_coordinates``."""
    g = _girg(200)
    set_seed(6)
    emb = WEmbedEmbedder(g, EmbedderOptions(embedding_dimension=2), verbose=False, device="cpu")
    emb.calculate_embedding(max_iterations=5)
    port_csv, jax_csv = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    io.write_coordinates(port_csv, emb.get_coordinates(), emb.get_weights())
    pos_j, w_j = jax_io.split_last_column(jax_io.read_coordinates(port_csv))
    np.testing.assert_array_equal(pos_j, emb.get_coordinates())
    np.testing.assert_array_equal(w_j, emb.get_weights())
    jax_io.write_coordinates(jax_csv, pos_j, w_j)
    with open(port_csv) as a, open(jax_csv) as b:
        assert a.read() == b.read()
    pos_t, w_t = io.split_last_column(io.read_coordinates(jax_csv))
    fresh = WEmbedEmbedder(g, EmbedderOptions(embedding_dimension=2), verbose=False, device="cpu")
    fresh.set_coordinates(pos_t)
    fresh.set_weights(w_t)
    np.testing.assert_array_equal(fresh.get_coordinates(), emb.get_coordinates())
    fresh.calculate_step()
    assert np.isfinite(fresh.get_coordinates()).all()


def test_generator_state_restores_only_on_its_device_type(tmp_path):
    """A generator's state restores on the device type that saved it; a
    file from another type draws a fresh generator from the host stream."""
    g = _girg(200)
    opts = EmbedderOptions(embedding_dimension=2, dtype="float64")
    set_seed(3)
    emb = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    emb.calculate_step()
    ckpt = str(tmp_path / "gen.npz")
    save_checkpoint(ckpt, emb)
    with np.load(ckpt) as data:
        assert str(data["generator_device"]) == "cpu"
        arrays = {k: data[k] for k in data.files}
    resumed = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    load_checkpoint(ckpt, resumed)
    assert torch.equal(resumed.state.generator.get_state(), emb.state.generator.get_state())
    arrays["generator_device"] = np.asarray("cuda")
    np.savez(str(tmp_path / "other.npz"), **arrays)
    other = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    load_checkpoint(str(tmp_path / "other.npz"), other)
    assert not torch.equal(other.state.generator.get_state(), emb.state.generator.get_state())
    np.testing.assert_array_equal(other.get_coordinates(), emb.get_coordinates())
