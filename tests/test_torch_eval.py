"""The port's evaluation stack against the JAX package's on the same numpy
inputs: the ten similarity spaces, the embedding parser, the
reconstruction ranking (host loop and torch device path against the JAX
host loop and jnp device path), edge detection, the log parsers and the
evaluate CLI."""

import numpy as np
import pytest
import torch

from wembed_tpu.cli import evaluate as jax_evaluate
from wembed_tpu.eval import edge_detection_metrics as jax_edge_detection_metrics
from wembed_tpu.eval import parse_embedding as jax_parse_embedding
from wembed_tpu.eval import parsers as jax_parsers
from wembed_tpu.eval import reconstruction as jax_reconstruction
from wembed_tpu.eval import sample_histogram as jax_sample_histogram
from wembed_tpu.eval.device import sample_node_entries_device as jax_entries_device
from wembed_tpu.graphs import generators

from wembed_tpu_torch.cli import evaluate
from wembed_tpu_torch.eval import (
    EmbeddingType,
    edge_detection_metrics,
    parse_embedding,
    parsers,
    reconstruction_metrics,
    sample_histogram,
    sample_node_entries,
)
from wembed_tpu_torch.eval import spaces
from wembed_tpu_torch.eval.device import sample_node_entries_device
from wembed_tpu_torch.graphs import io
from wembed_tpu_torch.graphs.csr import CSRGraph

torch.set_num_threads(1)

TYPES = list(EmbeddingType)


def _graph(n=150, seed=5):
    """(JAX graph, the same graph as the port's CSRGraph, rng)."""
    rng = np.random.default_rng(seed)
    g_j, _ = generators.geometric_graph(n, rng=rng)
    return g_j, CSRGraph(g_j.row_ptr, g_j.col_idx, g_j.colors), rng


def _columns(etype, n, rng, d=2):
    """An embedding file's columns for ``etype``, as
    tests/test_eval.py:test_device_reconstruction_matches_host makes them."""
    coords = rng.uniform(-1, 1, size=(n, d)) * 0.5  # inside the Poincare ball
    weights = np.exp(rng.normal(size=n))
    if etype == EmbeddingType.MERCATOR:  # kappa, radius, positions
        return np.concatenate([np.ones((n, 1)), np.abs(coords[:, :1]) * 3, coords], axis=1)
    if etype in (EmbeddingType.WEIGHTED, EmbeddingType.WEIGHTED_NO_DIM,
                 EmbeddingType.WEIGHTED_INF, EmbeddingType.ADDITIVE):
        return np.concatenate([coords, weights[:, None]], axis=1)
    return coords


@pytest.mark.parametrize("etype", TYPES)
def test_space_rows_and_pairs_match_jax(etype):
    rng = np.random.default_rng(int(etype))
    n = 60
    cols = _columns(etype, n, rng, d=3)
    port, ref = parse_embedding(etype, cols), jax_parse_embedding(int(etype), cols)
    assert type(port).__name__ == type(ref).__name__
    assert (port.n, port.dimension) == (ref.n, ref.dimension)
    ids = rng.permutation(n)[:17]
    np.testing.assert_array_equal(port.rows(ids), ref.rows(ids))
    a, b = rng.integers(0, n, 40), rng.integers(0, n, 40)
    np.testing.assert_array_equal(port.pairs(a, b), ref.pairs(a, b))
    assert port.similarity(3, 5) == ref.similarity(3, 5)


@pytest.mark.parametrize("etype", TYPES)
def test_parse_embedding_every_type(etype):
    cols = _columns(etype, 6, np.random.default_rng(0))
    space = parse_embedding(etype, cols)
    assert isinstance(space, spaces.Space) and space.n == 6
    v = space.similarity(0, 1)
    assert np.isfinite(v) and space.similarity(1, 0) == pytest.approx(v)
    if etype == EmbeddingType.WEIGHTED:
        np.testing.assert_array_equal(space.weights, cols[:, -1])
        np.testing.assert_array_equal(space.positions, cols[:, :-1])


def test_parse_embedding_rejects_unknown_type():
    with pytest.raises(ValueError):
        parse_embedding(10, np.ones((3, 2)))


def _assert_same_entries(got, want, tol=1e-12):
    assert [e.v for e in got] == [e.v for e in want]
    assert [e.deg for e in got] == [e.deg for e in want]
    for g, w in zip(got, want):
        assert abs(g.deg_precision - w.deg_precision) <= tol
        assert abs(g.average_precision - w.average_precision) <= tol


@pytest.mark.parametrize("etype", TYPES)
def test_node_entries_match_jax_on_pinned_ids(etype):
    """The port's device path (torch on the CPU, f64) and host loop against
    the JAX package's host loop and jnp device path, on pinned ids; the
    same again from a seeded sample."""
    g_j, g_t, rng = _graph()
    cols = _columns(etype, g_t.num_vertices, rng)
    port, ref = parse_embedding(etype, cols), jax_parse_embedding(int(etype), cols)
    ids = np.random.default_rng(1).permutation(g_t.num_vertices)[:37]
    want = jax_reconstruction.sample_node_entries(g_j, ref, 0, node_ids=ids)
    _assert_same_entries(jax_entries_device(g_j, ref, 0, node_ids=ids), want)
    _assert_same_entries(sample_node_entries_device(g_t, port, 0, node_ids=ids, block=16, device="cpu"), want)
    _assert_same_entries(sample_node_entries(g_t, port, 0, node_ids=ids), want)
    sampled = sample_node_entries_device(g_t, port, 40, rng=np.random.default_rng(3), device="cpu")
    _assert_same_entries(
        sampled, jax_reconstruction.sample_node_entries(g_j, ref, 40, rng=np.random.default_rng(3))
    )


def test_device_ranking_keeps_ties_in_id_order():
    """Coincident vertices tie; the stable argsort ranks them by id, as the
    host lexsort does, so the ranks and the metrics agree."""
    g_j, g_t, rng = _graph(120, seed=9)
    pos = np.round(rng.uniform(0, 3, size=(g_t.num_vertices, 2)))  # many exact ties
    ids = np.arange(0, g_t.num_vertices, 5)
    want = jax_reconstruction.sample_node_entries(g_j, jax_parse_embedding(1, pos), 0, node_ids=ids)
    got = sample_node_entries_device(g_t, spaces.Euclidean(pos), 0, node_ids=ids, device="cpu")
    _assert_same_entries(got, want)


@pytest.mark.parametrize("method", ["auto", "host", "device"])
def test_reconstruction_metrics_match_jax(method):
    g_j, g_t, rng = _graph(200, seed=6)
    cols = _columns(EmbeddingType.WEIGHTED, g_t.num_vertices, rng)
    port = reconstruction_metrics(
        g_t, parse_embedding(0, cols), 80, np.random.default_rng(4), method=method, device="cpu"
    )
    ref = jax_reconstruction.reconstruction_metrics(
        g_j, jax_parse_embedding(0, cols), 80, np.random.default_rng(4), method="host"
    )
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12)


def _manhattan(base):
    """A subclass of ``base`` (either package's ``Euclidean``, or its base
    ``Space``) ranking by L1 distance: a space with no device rows."""

    class Manhattan(base):
        def __init__(self, positions):
            self.positions = positions
            self.n, self.dimension = positions.shape

        def rows(self, ids):
            return np.abs(self.positions[ids][:, None, :] - self.positions[None, :, :]).sum(axis=-1)

        def pairs(self, a, b):
            return np.abs(self.positions[a] - self.positions[b]).sum(axis=-1)

    return Manhattan


@pytest.mark.parametrize("base", ["Space", "Euclidean"])
def test_auto_scores_a_space_without_device_rows_on_the_host(base):
    """Queue 3 fault 1: under "auto" a ``Space`` subclass that the device
    rows do not know is ranked on the host, by both packages from one
    seeded numpy generator, with equal results.  The device path draws its
    sample before it raises, so the host ranks the generator's second
    draw, as a host run after one permutation does; "device" raises."""
    from wembed_tpu.eval import spaces as jax_spaces

    g_j, g_t, rng = _graph(200, seed=8)
    pos = rng.normal(size=(g_t.num_vertices, 3))
    port_space = _manhattan(getattr(spaces, base))(pos)
    port = reconstruction_metrics(g_t, port_space, 60, np.random.default_rng(3), method="auto", device="cpu")
    ref = jax_reconstruction.reconstruction_metrics(
        g_j, _manhattan(getattr(jax_spaces, base))(pos), 60, np.random.default_rng(3), method="auto"
    )
    assert port == ref and port["MAP"] > 0
    after = np.random.default_rng(3)
    after.permutation(g_t.num_vertices)
    assert reconstruction_metrics(g_t, port_space, 60, after, method="host") == port
    with pytest.raises(NotImplementedError):
        reconstruction_metrics(g_t, port_space, 60, np.random.default_rng(3), method="device", device="cpu")


def test_reconstruction_metrics_rejects_unknown_method():
    _, g_t, rng = _graph(60)
    with pytest.raises(ValueError, match="unknown reconstruction method"):
        reconstruction_metrics(g_t, spaces.Euclidean(rng.normal(size=(g_t.num_vertices, 2))), method="gpu")


@pytest.mark.parametrize("etype", [EmbeddingType.WEIGHTED, EmbeddingType.EUCLIDEAN])
def test_edge_detection_matches_jax(etype):
    g_j, g_t, rng = _graph(300, seed=7)
    cols = _columns(etype, g_t.num_vertices, rng)
    port, ref = parse_embedding(etype, cols), jax_parse_embedding(int(etype), cols)
    assert edge_detection_metrics(g_t, port, 10.0, np.random.default_rng(8)) == (
        jax_edge_detection_metrics(g_j, ref, 10.0, np.random.default_rng(8))
    )
    for a, b in zip(
        sample_histogram(g_t, port, 3.0, np.random.default_rng(2)),
        jax_sample_histogram(g_j, ref, 3.0, np.random.default_rng(2)),
    ):
        np.testing.assert_array_equal(a, b)


def test_parsers_match_jax(tmp_path):
    log = tmp_path / "run.log"
    log.write_text("> dim=4\n> seed(default)=-1\nnoise\n> name=a=b\n")
    csv = tmp_path / "config.csv"
    csv.write_text("a,b,c\n1,2,3\n")
    wall = tmp_path / "time.txt"
    wall.write_text("\n12.5\n")
    assert parsers.parse_wembed_log(str(log)) == jax_parsers.parse_wembed_log(str(log))
    assert parsers.parse_csv_config(str(csv)) == jax_parsers.parse_csv_config(str(csv)) == {
        "a": "1", "b": "2", "c": "3",
    }
    assert parsers.parse_time_file(str(wall)) == jax_parsers.parse_time_file(str(wall)) == "12.5"


def _files(tmp_path, etype=EmbeddingType.WEIGHTED):
    _, g_t, rng = _graph(250, seed=3)
    graph = tmp_path / "g.edg"
    io.write_edge_list(str(graph), g_t)
    cols = _columns(etype, g_t.num_vertices, rng)
    emb = tmp_path / "emb.csv"
    if etype == EmbeddingType.WEIGHTED:
        io.write_coordinates(str(emb), cols[:, :-1], cols[:, -1])
    else:
        io.write_coordinates(str(emb), cols)
    samples = tmp_path / "ids.txt"
    samples.write_text("\n".join(str(v) for v in (5, 0, 17, 42, 3)) + "\n")
    wall = tmp_path / "time.txt"
    wall.write_text("1.25\n")
    return str(graph), str(emb), str(samples), str(wall)


@pytest.mark.parametrize(
    "extra",
    [
        ["--seed", "3"],
        ["--seed", "4", "--emb-type", "1", "--node-samples", "50", "--edge-samples", "4"],
        ["--seed", "5", "--node-samples-file", "SAMPLES", "-t", "TIME"],
        ["--header-only"],
    ],
)
def test_evaluate_cli_prints_the_jax_lines(tmp_path, capsys, extra):
    graph, emb, samples, wall = _files(tmp_path)
    argv = ["-g", graph, "-e", emb] + [
        {"SAMPLES": samples, "TIME": wall}.get(a, a) for a in extra
    ]
    assert jax_evaluate.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert evaluate.main(argv, device="cpu") == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert len(got) == (1 if "--header-only" in extra else 2)
    if len(got) == 2:
        assert got[0].split(",")[-5:] == ["constructDeg", "MAP", "precision", "recall", "edgeF1"]
        assert all(np.isfinite(float(v)) for v in got[1].split(",")[-5:])
