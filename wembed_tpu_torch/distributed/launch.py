"""Spawn ranks on one host: the launcher of the tests and the smoke run.

``run_ranks(fn, world_size, backend, device, args)`` starts ``world_size``
processes with ``torch.multiprocessing``; each joins a process group
through a ``FileStore`` in a temporary directory (no TCP port, so
concurrent launchers never contend for one), builds its ``Mesh`` and runs
``fn(mesh, *args)``.  The return values come back in rank order; a rank
that raises fails the call.  ``fn`` is unpickled by module name in each
child, so it lives in an importable module (``run_replicated`` below is
one).  The CUDA kernels are built before the ranks start, so two ranks
never race to build the same library.

``run_replicated(mesh, jobs)`` runs the replicated backend on each job and
returns its final state; ``run_halo(mesh, jobs)`` the halo backend.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import Mesh, make_mesh


def run_ranks(fn, world_size: int, backend: str | None = None, device: str = "cuda", args=(),
              threads: int | None = None) -> list:
    """``fn(mesh, *args)`` on ``world_size`` spawned ranks; their return
    values in rank order.  Each rank runs on ``device`` (the card unless
    ``device="cpu"``); ``backend`` defaults to NCCL for CUDA and gloo for
    the CPU (``backend="gloo"`` lets several ranks share one card).
    ``threads`` caps each rank's torch threads."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda:
        from ..kernels import _build

        for name in ("fused_dense", "span_sweep"):
            _build.build(name)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(
            _rank_main, args=(fn, world_size, backend, device, tmp, args, threads),
            nprocs=world_size, join=True,
        )
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(rank, fn, world_size, backend, device, tmp, args, threads):
    if threads is not None:
        torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    try:
        out = fn(make_mesh(backend=backend, device=device), *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_replicated(mesh: Mesh, jobs: list[dict]) -> list[dict]:
    """Each job on this rank, in order: a ``MultiChipEmbedder`` on
    ``graph`` (a CSRGraph, or ``graph_path`` to an edge list) with
    ``options`` (EmbedderOptions), from ``coords`` and ``weights`` (or the
    host stream after ``setSeed(seed)``); or from the checkpoint
    ``resume``, if given; with the span windows ``windows`` ((NB, R) tiles),
    if given; ``steps`` calls of ``calculate_step``, or
    ``calculate_embedding`` when it is None; then a checkpoint to
    ``checkpoint``, if given.  Each job returns its final state on the
    host, kernel launches, growth events, loop seconds, the rank's shares
    (dense rows, work items, edges) and what the rank holds (state rows,
    correction edges)."""
    from .step import MultiChipEmbedder

    return _run_jobs(mesh, jobs, MultiChipEmbedder)


def run_halo(mesh: Mesh, jobs: list[dict]) -> list[dict]:
    """``run_replicated``'s jobs on the halo backend (``HaloEmbedder``)."""
    from .halo import HaloEmbedder

    return _run_jobs(mesh, jobs, HaloEmbedder)


def _run_jobs(mesh: Mesh, jobs: list[dict], embedder_class) -> list[dict]:
    from ..core.checkpoint import load_checkpoint, save_checkpoint
    from ..graphs import io
    from ..kernels import launch_counts
    from ..utils import set_seed

    results = []
    for job in jobs:
        graph = job.get("graph") or io.read_edge_list(job["graph_path"])
        if job.get("seed") is not None:
            set_seed(job["seed"])
        emb = embedder_class(
            graph, job["options"], mesh=mesh, initial_coordinates=job.get("coords"),
            initial_weights=job.get("weights"), verbose=False,
        )
        if job.get("resume"):
            load_checkpoint(job["resume"], emb)
        if job.get("windows") is not None:  # a start with these span windows
            emb._swap_index(emb._index._with_blk_t(job["windows"]))
        before = launch_counts()
        _sync(mesh)
        t0 = time.perf_counter()
        if job.get("steps") is None:
            emb.calculate_embedding()
        else:
            for _ in range(job["steps"]):
                emb.calculate_step()
        _sync(mesh)
        seconds = time.perf_counter() - t0
        if job.get("checkpoint"):
            save_checkpoint(job["checkpoint"], emb)
        s = emb.state
        n = graph.num_vertices
        shares = {"dense_rows": emb._share.cut(n), "edges": emb._share.cut(graph.num_directed_edges)}
        if emb._items is not None:
            shares["work_items"] = emb._share.cut(int(emb._items.shape[0]))
            shares["total_items"] = int(emb._items.shape[0])
        held = {"rows": tuple(s.positions.shape), "moments": tuple(s.adam_m.shape)}
        if emb._index is not None:
            held["correction_edges"] = int(emb._index.tensors(emb.device).edge_src.shape[0])
        results.append(dict(
            rank=mesh.rank, size=mesh.size, path=emb.path, iterations=emb.iteration,
            positions=emb.get_coordinates(), attract_loss=float(s.attract_loss),
            repel_loss=float(s.repel_loss), num_rep_forces=int(s.num_rep_forces),
            overflow=int(s.overflow), growth_events=emb.growth_events, seconds=seconds,
            launches={k: v - before[k] for k, v in launch_counts().items()},
            shares=shares, held=held, weights=np.asarray(emb.get_weights()),
        ))
        del emb
    return results


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
