"""The replicated multi-device backend: replicated state, each rank's share
of the force pass, one all-reduce a step.

Counterpart of ``wembed_tpu/distributed/step.py`` (``MultiChipEmbedder``,
the graph-partitioning analogue of data parallelism, SURVEY.md §5.8).
Every rank holds the whole state (positions, weights, moments, generator)
and the whole span structures; a step's force pass computes one rank's
partial (``core/step.py:Share``):

  * dense: rows [r0, r1) of the fused kernel (``csrc/fused_dense.cu``),
    attraction included;
  * span: a contiguous slice of the sweep's work items
    (``csrc/span_sweep.cu``; the JAX package's ``_shard_work_tiles``) and a
    range of the directed edges for the merged attraction and correction
    pass;
  * sampled: a row range of the candidate draw and an edge range for
    attraction.

The partials go in one all-reduce (SUM), as the JAX step's one ``psum``
(``wembed_tpu/core/step.py:424-431``).  Kicks, the optimizer, gravity and
the displacement then run whole on every rank, so the state never
diverges: the generator's draws are made whole on every rank and sliced.

Where torch differs from the JAX package:
  * one process a rank (``distributed/mesh.py``), not one process over P
    devices;
  * the overflow comes from the replicated structures build, so it is the
    same on every rank; it is reduced with MAX, so the growth protocol
    (``core/span_driver.py``) decides alike everywhere.  The JAX package
    zeroes it off device 0 and psums it;
  * ``profile=True`` runs the normal step, as the JAX package's layer
    factory documents (``wembed_tpu/api.py:308-309``);
  * the span path keeps the windowed layout whatever ``span_layout`` says,
    as the JAX package's sharded step builds a ``SpanIndex``
    (``wembed_tpu/distributed/step.py:55-70``; ``_span_layout``);
  * ``dump_weights`` and the progress lines are rank 0's.

Every rank calls every method, in the same order (one program, many
ranks).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import step as step_mod
from ..core.embedder import WEmbedEmbedder
from ..core.options import EmbedderOptions
from ..graphs.csr import CSRGraph
from ..utils.timer import Timer
from .mesh import Mesh, make_mesh


class MultiChipEmbedder(WEmbedEmbedder):
    """``WEmbedEmbedder`` whose force pass is this rank's share, reduced
    over the mesh; the same public surface (``calculate_step``,
    ``calculate_embedding``, ``is_finished``, ``get_loss``, ``path``,
    ``growth_events``, ``final_overflow``, ``set_coordinates``,
    ``set_weights``, checkpoints).  Every rank first takes rank 0's host
    seed stream (``Mesh.share_host_stream``), unless ``share_stream`` is
    False because the caller already gave it (the layers of a replicated
    ``LayeredEmbedder``)."""

    def __init__(
        self,
        graph: CSRGraph,
        opts: EmbedderOptions | None = None,
        mesh: Mesh | None = None,
        timer: Timer | None = None,
        initial_coordinates: np.ndarray | None = None,
        initial_weights: np.ndarray | None = None,
        verbose: bool = True,
        profile: bool = False,
        device: torch.device | str | None = None,
        share_stream: bool = True,
    ):
        self.mesh = mesh or make_mesh(device=device)
        if device is not None and torch.device(device).type != self.mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's {self.mesh.device}")
        if share_stream:
            self.mesh.share_host_stream()
        super().__init__(
            graph, opts, timer, initial_coordinates, initial_weights,
            verbose=verbose and self.mesh.rank == 0, device=self.mesh.device,
        )
        self._share = step_mod.Share(self.mesh.rank, self.mesh.size, self._reduce)

    @property
    def profile(self) -> bool:
        return False

    @profile.setter
    def profile(self, on: bool) -> None:
        pass  # the normal step, as the JAX package's distributed embedders run it

    def _span_layout(self) -> str:
        """Windows: the cell layout is single-device in the JAX package
        (``wembed_tpu/kernels/span_compact.py:46-47``), whose multi-device
        steps build a ``SpanIndex`` (``distributed/step.py:55-70``, and the
        halo step, ``distributed/halo.py:200-220``, which ``HaloEmbedder``
        inherits this from)."""
        return "windows"

    def _reduce(self, force, zero_count, att_loss, rep_loss, rep_count, overflow):
        """Every rank's partials summed in one all-reduce, packed in f64:
        forces and losses (f32 or f64) pass through f64 unchanged, and the
        counts (below 2^53) stay exact.  The overflow, the same on every
        rank, is reduced with MAX."""
        n, d = force.shape
        packed = torch.cat([
            force.reshape(-1).to(torch.float64),
            zero_count.to(torch.float64),
            torch.stack([att_loss.to(torch.float64), rep_loss.to(torch.float64),
                         rep_count.to(torch.float64)]),
        ])
        self.mesh.all_reduce(packed)
        if overflow is not None:
            self.mesh.all_reduce(overflow, torch.distributed.ReduceOp.MAX)
        return (
            packed[: n * d].view(n, d).to(force.dtype),
            packed[n * d : n * d + n].to(torch.int32),
            packed[-3].to(att_loss.dtype),
            packed[-2].to(rep_loss.dtype),
            packed[-1].to(torch.int64),
            overflow,
        )

    def _dump_weights(self, iteration: int) -> None:
        if self.mesh.rank == 0:
            super()._dump_weights(iteration)
