"""The port's edge-list reader against the JAX package's: the native parser
(``csrc/labelprop.cpp``, built with g++) on whitespace files with a
one-character comment, the Python loop otherwise, and the failures that
raise instead of falling back."""

import os

import numpy as np
import pytest

from wembed_tpu.graphs import io as jax_io
from wembed_tpu.graphs.io import _read_pairs_native as jax_native_pairs

from wembed_tpu_torch.graphs import io
from wembed_tpu_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FILES = {
    "comments": b"# a header\n0 1\n# between\n1 2\n  # indented comment\n2 0\n",
    "tabs": b"0\t1\n1 \t 2\n\t2\t3\n",
    "crlf": b"0 1\r\n1 2\r\n\r\n2 3\r\n",
    "blank_lines": b"\n\n0 1\n   \n\n1 2\n\n",
    "trailing_tokens": b"0 1 0.5\n1 2 7 8 9\n2 3 x\n",
    "non_numeric": b"a b\n0 1\nfoo\n1 bar\n2 3\n7\n-\n",
    "no_final_newline": b"0 1\n1 2",
    "lone_integer": b"7\n0 1\n2 3\n",
    "empty": b"",
}


def _write(tmp_path, name, data):
    path = tmp_path / f"{name}.edg"
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("name", list(FILES))
def test_native_parser_reads_the_jax_packages_pairs(tmp_path, name):
    """The port's ``read_edge_list`` takes the native parser here and reads
    exactly the pairs of the JAX package's native parser, in file order;
    the graph is the JAX package's ``read_edge_list``'s."""
    path = _write(tmp_path, name, FILES[name])
    want = jax_native_pairs(path, "#")
    assert want is not None  # the JAX package's parser ran natively
    got = io._read_pairs_native(path, "#")
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    g, g_j = io.read_edge_list(path), jax_io.read_edge_list(path)
    np.testing.assert_array_equal(g.row_ptr, g_j.row_ptr)
    np.testing.assert_array_equal(g.col_idx, g_j.col_idx)


def test_a_lone_integer_pairs_with_the_next_line(tmp_path):
    """In the native parser, as in the JAX package's, the second integer's
    ``strtoll`` skips the newline: a line with one integer pairs with the
    next line's first integer, and the rest of that line is dropped.  The
    Python loop skips such a line.  A deviation the port reproduces
    (ROADMAP Queue 3)."""
    path = _write(tmp_path, "lone", FILES["lone_integer"])
    np.testing.assert_array_equal(io._read_pairs_native(path, "#"), [[7, 0], [2, 3]])
    np.testing.assert_array_equal(io._read_pairs_python(path, "#", None), [[0, 1], [2, 3]])


def test_native_parser_reads_girg10k():
    """girg10k, through the native parser, equals the Python loop's pairs
    and the JAX package's."""
    path = os.path.join(REPO, "assets", "girg10k.edg")
    got = io._read_pairs_native(path, "#")
    assert got.shape == (79881, 2)
    np.testing.assert_array_equal(got, jax_native_pairs(path, "#"))
    np.testing.assert_array_equal(got, io._read_pairs_python(path, "#", None))
    g = io.read_edge_list(path)
    assert (g.num_vertices, g.num_edges) == (10000, 79881)


@pytest.mark.parametrize(
    "comment,delimiter,data",
    [("//", None, b"// note\n0 1\n1 2\n"), ("#", ",", b"#x\n0,1\n1,2\n2,3\n")],
)
def test_other_formats_take_the_python_loop(tmp_path, monkeypatch, comment, delimiter, data):
    """A delimiter or a longer comment takes the Python loop, as in the JAX
    package (``wembed_tpu/graphs/io.py:32,53``), with its pairs."""
    path = _write(tmp_path, "other", data)

    def refuse(*args):
        raise AssertionError("the native parser ran")

    monkeypatch.setattr(io, "_read_pairs_native", refuse)
    g, g_j = io.read_edge_list(path, comment, delimiter), jax_io.read_edge_list(path, comment, delimiter)
    assert g.num_edges == g_j.num_edges > 0
    np.testing.assert_array_equal(g.col_idx, g_j.col_idx)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        io.read_edge_list(str(tmp_path / "absent.edg"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """With no g++ the library cannot build: reading raises, and nothing
    parses the file in Python instead."""
    path = _write(tmp_path, "graph", b"0 1\n")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    def no_compiler():
        raise RuntimeError("g++ not found on PATH")

    monkeypatch.setattr(_build, "_gxx", no_compiler)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        io.read_edge_list(path)
