"""wembed_tpu_torch — the PyTorch/CUDA port of wembed_tpu.

Weighted low-dimensional vertex embeddings by force-directed descent (the
capabilities of WEmbed), on one NVIDIA GPU.  The layout and names follow
``wembed_tpu``, which stays the reference the port is tested against; this
package imports torch and numpy and never jax.  Plain tensor code is
PyTorch; each Pallas kernel of the JAX package becomes a hand-written CUDA
kernel under ``csrc/`` with a plain PyTorch version beside it, which CPU
tensors run.

The port runs the flat embedding — the dense path (n <= dense_threshold),
the span path above it, and negative sampling — the layered (multilevel)
embedding over it (``multilevel``), the profiled step, checkpoints
(``core/checkpoint.py``), the evaluation metrics (``eval``), drawing
(``draw``), a partial index, both span layouts (windows, and cells with
``span_layout="cells"``), and the replicated and halo multi-device
backends (``distributed``): everything the JAX package does.
"""

from . import core, graphs, utils
from .core import EmbedderOptions, WEmbedEmbedder

__version__ = "0.1.0"

__all__ = ["core", "graphs", "utils", "EmbedderOptions", "WEmbedEmbedder", "__version__"]
