"""The port stands alone: it imports no jax, never falls back from CUDA to
the CPU, and raises on the paths it does not run yet."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wembed_tpu_torch import api
from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder
from wembed_tpu_torch.eval import reconstruction_metrics
from wembed_tpu_torch.eval.spaces import Euclidean
from wembed_tpu_torch.graphs import io
from wembed_tpu_torch.multilevel import LayeredEmbedder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_module_imports_jax():
    code = (
        "import pkgutil, importlib, sys, wembed_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(wembed_tpu_torch.__path__, 'wembed_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "assert len(names) > 10, names\n"
        "for name in ('multilevel.layered', 'multilevel.label_prop', 'eval.device', 'cli.evaluate',\n"
        "             'core.checkpoint', 'draw.svg', 'draw.ipe', 'draw.animate'):\n"
        "    assert 'wembed_tpu_torch.' + name in names, name\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'wembed_tpu.')) or m == 'wembed_tpu')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def _small_graph():
    return io.read_edge_list(os.path.join(REPO, "assets", "small_graph.edg"))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WEmbedEmbedder(_small_graph(), verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.createEmbedder(api.Graph(_small_graph()), api.Options())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LayeredEmbedder(_small_graph(), verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.createEmbedder(api.Graph(_small_graph()), api.Options(layeredEmbedding=True))
    space = Euclidean(np.zeros((5, 2)))
    for method in ("device", "auto"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            reconstruction_metrics(_small_graph(), space, method=method)


@pytest.mark.parametrize(
    "opts",
    [
        EmbedderOptions(repulsion_mode=RepulsionMode.BUCKET, span_layout="cells"),
        EmbedderOptions(dense_threshold=3, index_size=0.5),  # AUTO above the threshold
    ],
)
def test_unported_options_raise(opts):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        WEmbedEmbedder(_small_graph(), opts, verbose=False, device="cpu")


@pytest.mark.parametrize(
    "options", [api.Options(distributedMode="replicated"), api.Options(distributedMode="halo")]
)
def test_unported_api_modes_raise(options):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.createEmbedder(api.Graph(_small_graph()), options, device="cpu")


def test_kernel_wrapper_uses_plain_version_only_for_cpu_tensors():
    from wembed_tpu_torch.kernels import fused_dense

    n = 4
    args = (
        torch.zeros((n, 2)), torch.ones(n), torch.arange(n, dtype=torch.int32),
        torch.zeros((n, 1), dtype=torch.int32),  # the bit adjacency of no edges
    )
    before = fused_dense.fused_dense_forces.launches
    fused_dense.fused_dense_forces(*args, dim=2, L=1.0, att_scale=1.0, rep_scale=1.0, additive=False)
    assert fused_dense.fused_dense_forces.launches == before
    with pytest.raises(ValueError, match="no fused_dense kernel"):
        fused_dense.fused_dense_forces(
            *(a.to("meta") for a in args), dim=2, L=1.0, att_scale=1.0, rep_scale=1.0,
            additive=False,
        )
