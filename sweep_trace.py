#!/usr/bin/env python3
"""The span sweep's two kernels as the loop runs them, on one CUDA card.

    python3 sweep_trace.py --workload girg100k_d2_span --seed 1 --steps 50

One run of a span cell of ``BENCHMARK.json`` (flat or layered) to
convergence from ``--seed``, through ``bench_torch.py``'s set-up, then
``--steps`` steps of the public loop (``calculateStep()``, replayed CUDA
graphs around the eager sweep, as a run makes them) under
``torch.profiler``:

- ``reduce_ms`` and ``sweep_ms``: the device ms of each call of
  ``span_reduce_kernel`` and of ``span_sweep_kernel`` in the trace
  (median, quartiles, count): the reduction reads the scratch just after
  the sweep wrote it, as in every step;
- ``reduce_bound_ms``: the reduction's least time at the converged
  windows, the (items, d + 3, 256) f32 scratch read once and the
  (NQ, d + 3) outputs written once over the card's memory rate, and
  ``reduce_share``, the bound over ``reduce_ms``.

It reads only what every tree since the sweep's reduction kernel has, so
the script copied into another tree's checkout times that tree's kernels.
Prints the card's name and power limit, and last one JSON object.  Exits
non-zero without a CUDA card.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys

import bench_torch as bt

KERNELS = ("span_reduce_kernel", "span_sweep_kernel")


def traced_calls(emb, steps: int) -> dict[str, list[float]]:
    """{kernel: device ms of each call} of KERNELS over ``steps`` public
    steps under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    emb.calculateStep()  # a replay before the window, as the loop has made them
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            emb.calculateStep()
        torch.cuda.synchronize()
    calls: dict[str, list[float]] = {k: [] for k in KERNELS}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for k in KERNELS:
                if f"::{k}<" in e.name:
                    calls[k].append(e.time_range.elapsed_us() / 1e3)
    return calls


def reduce_bound(emb) -> dict:
    """The reduction's work items at the embedder's current windows (a
    layered embedder's current layer) and its least time by bytes.  No
    public accessor gives the windows, so they are read from the
    embedder's private state."""
    from wembed_tpu_torch.kernels import span_sweep

    impl = getattr(emb.impl, "_current", emb.impl)
    d = impl.state.positions.shape[1]
    items = len(span_sweep.work_items(impl._blk_t.cpu().numpy()))
    nbytes = items * (d + 3) * 256 * 4 + impl._index.nq * (d + 3) * 4
    return dict(n=impl.state.positions.shape[0], d=d, items=items, blocks=impl._index.nb, bytes=nbytes,
                bound_ms=nbytes / bt.HBM_BYTES * 1e3)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True, help="a span cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, default=1, help="seed of the run to convergence")
    parser.add_argument("--steps", type=int, default=50, help="steps in the profiler's window")
    args = parser.parse_args(argv)
    import torch

    from wembed_tpu_torch import api

    if not torch.cuda.is_available():
        print("sweep_trace: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    cell = bt.find_cell(bt.load_benchmark(), args.workload)
    if "span_sweep" not in cell["kernels"]:
        print(f"sweep_trace: {cell['name']} runs no span sweep", file=sys.stderr)
        return 1
    device = bt.card()
    spec = cell["graph"]
    path, proc, t0 = bt.start_graph(spec)
    bt.build_sources(tuple(cell["kernels"]))
    bt.finish_graph(spec, path, proc, t0)
    graph = api.graphFromEdgeListFile(str(path))
    record, emb = bt.one_run(graph, bt.cell_options(cell, None), args.seed, torch.device("cuda"))
    calls = traced_calls(emb, args.steps)
    if not calls["span_reduce_kernel"]:
        print("sweep_trace: the trace shows no span_reduce_kernel", file=sys.stderr)
        return 1
    bound = reduce_bound(emb)
    out = dict(workload=cell["name"], seed=args.seed, iterations=[r["iterations"] for r in record["layers"]],
               launches=record["launches"], steps=args.steps,
               reduce_ms=bt.summary(calls["span_reduce_kernel"]), sweep_ms=bt.summary(calls["span_sweep_kernel"]),
               reduce_bound_ms=bound["bound_ms"], reduce_bytes=bound["bytes"], reduce_items=bound["items"],
               blocks=bound["blocks"], n=bound["n"], d=bound["d"], device=device)
    out["reduce_share"] = bound["bound_ms"] / out["reduce_ms"]["value"]
    for name in ("reduce_ms", "sweep_ms"):
        s = out[name]
        print(f"metric {name} = {s['value']!r} ms a call (median of {s['n']}; quartiles {s['q1']!r} .. {s['q3']!r})")
    print(f"metric reduce_bound_ms = {bound['bound_ms']!r} ms ({bound['items']} items, {bound['bytes']} bytes)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
