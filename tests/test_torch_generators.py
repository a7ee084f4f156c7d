"""The port's GIRG generator and its CLI against the JAX package's: the same
seed must give byte-identical edge lists."""

import numpy as np
import pytest

from wembed_tpu.cli import generate as jax_generate
from wembed_tpu.graphs import algorithms as jax_algorithms
from wembed_tpu.graphs import generators as jax_generators
from wembed_tpu.graphs import from_edges as jax_from_edges
from wembed_tpu.graphs import io as jax_io

from wembed_tpu_torch.cli import generate
from wembed_tpu_torch.graphs import algorithms, generators, io
from wembed_tpu_torch.graphs.csr import CSRGraph


@pytest.mark.parametrize(
    "dim,kw",
    [
        (2, dict(temperature=0.1, torus=False)),  # the girg100k flags
        (3, dict(temperature=0.1, torus=False)),
        (2, dict(temperature=0.0, torus=True)),  # threshold model on the torus
    ],
)
def test_girg_writes_identical_edge_lists(tmp_path, dim, kw):
    args = dict(ple=2.5, avg_degree=15.0, dim=dim, **kw)
    g_j, pos_j, w_j = jax_generators.girg(2000, rng=np.random.default_rng(1), **args)
    g_t, pos_t, w_t = generators.girg(2000, rng=np.random.default_rng(1), **args)
    np.testing.assert_array_equal(pos_t, pos_j)
    np.testing.assert_array_equal(w_t, w_j)
    jax_io.write_edge_list(str(tmp_path / "jax.edg"), g_j)
    io.write_edge_list(str(tmp_path / "port.edg"), g_t)
    want = (tmp_path / "jax.edg").read_bytes()
    assert len(want) > 10_000
    assert (tmp_path / "port.edg").read_bytes() == want


def test_largest_component_matches():
    rng = np.random.default_rng(4)
    edges = rng.integers(0, 300, size=(200, 2))
    g_j = jax_from_edges(edges, num_vertices=300)
    g_t = CSRGraph(g_j.row_ptr, g_j.col_idx)
    sub_j, map_j = jax_algorithms.largest_component_with_mapping(g_j)
    sub_t, map_t = algorithms.largest_component_with_mapping(g_t)
    np.testing.assert_array_equal(map_t, map_j)
    np.testing.assert_array_equal(sub_t.row_ptr, sub_j.row_ptr)
    np.testing.assert_array_equal(sub_t.col_idx, sub_j.col_idx)


@pytest.mark.parametrize(
    "flags",
    [
        ["-n", "2000", "-d", "2", "-s", "1", "--avg-deg", "15", "--ple", "2.5"],
        ["-n", "1500", "-d", "3", "-s", "7", "--avg-deg", "10", "--ple", "2.2", "--torus"],
    ],
)
def test_cli_writes_identical_files(tmp_path, flags, capsys):
    for name, module in (("jax", jax_generate), ("port", generate)):
        out = tmp_path / f"{name}.edg"
        coords = tmp_path / f"{name}.csv"
        assert module.main(["-o", str(out), "-w", str(coords), *flags]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1] and lines[0].startswith("generated n=")
    for suffix in ("edg", "csv"):
        assert (tmp_path / f"port.{suffix}").read_bytes() == (tmp_path / f"jax.{suffix}").read_bytes()
