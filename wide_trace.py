#!/usr/bin/env python3
"""The general kernels (f32 at d > 8, f64) as the loop runs them, on one CUDA card.

    python3 wide_trace.py --graph girg10k --dim 16 --seed 1
    python3 wide_trace.py --graph girg10k --dim 2 --dtype float64 --seed 1
    python3 wide_trace.py --graph girg100k --dim 16 --seed 1 [--max-steps 200]

One flat run from ``--seed`` to convergence (or to ``--max-steps``
iterations), then ``--steps`` steps of the public loop (``calculateStep()``,
replayed CUDA graphs as a run makes them) under ``torch.profiler``.  f32
runs go through ``api.createEmbedder``; an f64 run through the same
embedder class with ``EmbedderOptions(dtype="float64")``, which the public
options do not carry.  girg10k is the committed ``assets/girg10k.edg``;
girg100k is made as ``chip_smoke.py`` makes it (the port's generator,
cached in ``build/graphs/`` and md5-checked).  It prints:

- the run: iterations, the total loss recomputed in f64 from the final
  coordinates and weights by a plain pass (``bench_torch.plain_loss``),
  MAP (1,000 vertices ranked on the card), the launches of each kernel
  wrapper and of the general kernels, the peak device memory of the run
  (``max_memory_allocated`` since a reset before it), and a sha256 of the
  final coordinates' bytes (two trees agree bitwise when these agree);
- ``kernel_ms``: each general kernel's device ms a call in the trace
  (median, quartiles, count): ``fused_dense_general_kernel``,
  ``span_sweep_general_kernel``, ``span_reduce_general_kernel``, the edge
  pass's general variant and the frame's general route
  (``principal_axes_kernel`` with torch's mean and covariance around it);
- ``bound_ms`` and ``share`` of the general kernels at the run's end: the
  larger of their FP32 (FP64) operations over 67 (34) TFLOP/s and their
  bytes over 3.35 TB/s.  The dense and sweep kernels by operations as
  ``chip_smoke.py`` counts them (every pair's 3d + 3 or 3d + 1, and 14
  more for each candidate or neighbour); the sweep's reduce by bytes (its
  (items, d + 3, 256) scratch read once, the (NQ, d + 3) sums written
  once); the edge pass's general variant as
  ``chip_smoke.py:edge_pass_bound`` counts the fused pass at the final
  positions (its share against ``edge_pass_general_ms``, the device ms a
  step of whichever kernels the tree runs for it); the frame's
  ``principal_axes_kernel`` as ``chip_smoke.py:build_bounds`` counts the
  axes on a covariance;
- ``top``: the trace's ten kernels by device time a step, and the device
  ms and device events a step.

It reads no ``BENCHMARK.json`` and uses only what every tree since the
general kernels' first version has, so copied into another tree's checkout
it times that tree's kernels.  Prints the card's name and power limit, and
last one JSON object.  Exits non-zero without a CUDA card.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import sys
import time

import bench_torch as bt
import chip_smoke as cs

EDGE_PASS_GENERAL = ("segment_pass_general_kernel", "edge_pass_kernel", "edge_segment_kernel")  # a tree's, or an older's two
GENERAL = (
    "fused_dense_general_kernel", "span_sweep_general_kernel", "span_reduce_general_kernel",
    *EDGE_PASS_GENERAL, "principal_axes_kernel",
)


def kernel_name(name: str) -> str:
    """A traced kernel's name without its namespace, template and arguments."""
    m = re.search(r"(\w+)(?=[<(])", name)
    return m.group(1) if m else name[:60]


def traced_steps(emb, steps: int) -> tuple[dict[str, list[float]], float]:
    """({kernel: device ms of each call}, device ms of all kernels) over
    ``steps`` public steps under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    emb.calculateStep()  # a replay before the window, as the loop has made them
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            emb.calculateStep()
        torch.cuda.synchronize()
    calls: dict[str, list[float]] = {}
    total = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            calls.setdefault(kernel_name(e.name), []).append(ms)
            total += ms
    return calls, total


def graph_of(name: str):
    """The edge list of ``--graph``: girg10k committed, girg100k made or cached."""
    if name == "girg10k":
        return cs.GIRG10K
    path = cs.GIRG100K
    proc, t0 = cs.start_graph(path, cs.GIRG100K_FLAGS, cs.GIRG100K_MD5)
    cs.finish_graph(path, proc, t0)
    md5 = hashlib.md5(path.read_bytes()).hexdigest()
    if md5 != cs.GIRG100K_MD5:
        raise SystemExit(f"wide_trace: {path} md5 {md5} != {cs.GIRG100K_MD5}")
    return path


def bounds(impl, dim: int, f64: bool) -> dict:
    """The general kernels' least ms at the run's end (the sweep and its
    reduce at the current windows' work items, the edge pass at the final
    positions).  No public accessor gives the counts or the windows, so
    they are read from the embedder's state."""
    import torch

    from wembed_tpu_torch.kernels import span_build, span_sweep

    n = impl.state.positions.shape[0]
    candidates = int(impl.state.num_rep_forces)
    size = 8 if f64 else 4
    out = {}
    if impl.path == "dense":
        edges = 2 * int(impl._dg.num_edges)
        flop = n * n * (3 * dim + 3) + (candidates + edges) * cs.RARE_FLOP
        nbytes = n * (dim + 1) * size + n * 4 + n * (-(-n // 32)) * 4 + n * (dim * size + 4)
        out["fused_dense_general_kernel"] = cs.bound(flop, nbytes, f64)
    else:
        items = span_sweep.work_items(impl._blk_t.cpu().numpy())
        tiles = int(items[:, 3].sum())
        nq = impl._index.nq
        flop = tiles * span_sweep.Q * span_sweep.ST * (3 * dim + 1) + candidates * cs.RARE_FLOP
        nbytes = 2 * nq * ((dim + 3) * size + 4) + len(items) * 16 + nq * ((dim + 1) * size + 8)
        out["span_sweep_general_kernel"] = cs.bound(flop, nbytes, f64)
        out["tiles"] = tiles
        out["span_reduce_general_kernel"] = cs.bound(0, (len(items) * 256 + nq) * (dim + 3) * size, f64)
        axes_flop = 2 * (span_build.ITERS * (2 * dim * dim + 2 * dim) + 2 * dim * dim + 6 * dim)
        out["principal_axes_kernel"] = cs.bound(axes_flop, (dim * dim + 2 * dim) * size, f64)
        case = cs.edge_case(impl)
        args, kw = case["args"], case["kw"]
        pos = args[0]
        scalar = [torch.empty((), dtype=pos.dtype, device=pos.device)] * 2
        passed = (kw["force"], kw["zero_count"], *scalar, torch.empty((), dtype=torch.int64, device=pos.device))
        out["edge_pass_general"] = cs.edge_pass_bound("fused", args, kw, passed)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--graph", choices=("girg10k", "girg100k"), required=True)
    parser.add_argument("--dim", type=int, required=True)
    parser.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    parser.add_argument("--seed", type=int, default=1, help="seed of the run")
    parser.add_argument("--max-steps", type=int, default=None, help="stop the run at this iteration")
    parser.add_argument("--steps", type=int, default=50, help="steps in the profiler's window")
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from wembed_tpu_torch import api
    from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder
    from wembed_tpu_torch.kernels import edge_pass, fused_dense, span_sweep

    if not torch.cuda.is_available():
        print("wide_trace: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    device = bt.card()
    bt.build_sources(("fused_dense", "span_sweep", "edge_pass", "span_build"))
    graph = api.graphFromEdgeListFile(str(graph_of(args.graph)))
    f64 = args.dtype == "float64"
    api.setSeed(args.seed)
    if f64:
        emb = api.Embedder(WEmbedEmbedder(graph.csr, EmbedderOptions(embedding_dimension=args.dim, dtype=args.dtype),
                                          verbose=False))
    else:
        emb = api.createEmbedder(graph, api.Options(embeddingDimension=args.dim))
    impl = emb.impl
    wrappers = dict(fused_dense=fused_dense.fused_dense_forces, span_sweep=span_sweep.span_sweep,
                    edge_pass=edge_pass.edge_pass)
    before = {k: (w.launches, w.launches_general) for k, w in wrappers.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    impl.calculate_embedding(max_iterations=args.max_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: [w.launches - before[k][0], w.launches_general - before[k][1]] for k, w in wrappers.items()}
    coords, weights = impl.get_coordinates(), impl.get_weights()
    out = dict(graph=args.graph, n=graph.getNumVertices(), d=args.dim, dtype=args.dtype, seed=args.seed,
               max_steps=args.max_steps, path=impl.path, iterations=impl.iteration, wall_s=wall,
               launches=launches, final_overflow=impl.final_overflow, peak_memory_gib=peak,
               coords_sha256=hashlib.sha256(np.ascontiguousarray(coords).tobytes()).hexdigest(),
               plain_loss=bt.plain_loss(graph.csr, coords, weights, args.dim, 1.0, torch.device("cuda")),
               MAP=cs.map_only(graph.csr, coords, weights))
    bound = bounds(impl, args.dim, f64)
    calls, total = traced_steps(emb, args.steps)
    out["steps"] = args.steps
    out["device_ms_per_step"] = total / args.steps
    out["events_per_step"] = sum(len(v) for v in calls.values()) / args.steps
    out["kernel_ms"] = {k: bt.summary(calls[k]) for k in GENERAL if k in calls}
    edge = [k for k in EDGE_PASS_GENERAL if k in calls]
    if edge:
        out["edge_pass_general_ms"] = sum(sum(calls[k]) for k in edge) / args.steps  # device ms a step
        out["edge_pass_general_kernels"] = edge
    for k, (ms, by) in ((k, v) for k, v in bound.items() if k != "tiles"):
        out.setdefault("bound_ms", {})[k] = ms
        out.setdefault("bound_by", {})[k] = by
        if k in out["kernel_ms"]:
            out.setdefault("share", {})[k] = ms / out["kernel_ms"][k]["value"]
        elif k == "edge_pass_general" and edge:
            out.setdefault("share", {})[k] = ms / out["edge_pass_general_ms"]
    if "tiles" in bound:
        out["work_tiles"] = bound["tiles"]
    per_step = sorted(((sum(v) / args.steps, k, len(v) / args.steps) for k, v in calls.items()), reverse=True)
    out["top"] = [dict(kernel=k, ms_per_step=ms, calls_per_step=c) for ms, k, c in per_step[:10]]
    out["device"] = device
    for k, s in out["kernel_ms"].items():
        print(f"metric {k} = {s['value']!r} ms a call (median of {s['n']}; quartiles {s['q1']!r} .. {s['q3']!r})")
    print(f"run iterations={out['iterations']} plain_loss={out['plain_loss']!r} MAP={out['MAP']!r} "
          f"coords_sha256={out['coords_sha256']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
