#!/usr/bin/env python3
"""The span structures build timed eagerly on one CUDA card: where the
profiled step's ``index`` phase (``bench_torch.py``'s ``structures_ms``)
spends its time.

    python3 build_eager.py --workload girg100k_d4_span --seed 7 --builds 200

One run of a flat span cell of ``BENCHMARK.json`` to convergence from
``--seed`` (through ``bench_torch.py``'s set-up), then ``--builds`` eager
builds of the structures at its converged positions, made as the profiled
step makes them (``SpanIndex.structures``, after ``draw_members``), each
after a synchronisation, so that the device starts idle as it does in a
profiled step:

- ``host_ms``: the host clock around the call, which issues the build's
  launches and returns without waiting for them;
- ``event_ms``: CUDA events recorded before and after the call, the
  interval that the ``index`` phase reads;
- ``device_ms``: the build's kernels, copies and memsets summed from a
  ``torch.profiler`` trace of ``--traced`` further builds, a build;
  ``events``: their count a build.

When ``event_ms`` follows ``host_ms`` and ``device_ms`` is far below both,
the phase measures the host.

``--compare-build``: then ``chip_smoke.py``'s timed ``compare_build`` at
the same positions (the build's kernels against their plain versions,
bitwise, and each wrapper's ms a call from CUDA graph replays beside its
bound), whose timings go into the last line as ``build_kernels``; each
kernel's device ms a build from a trace of replays of the whole build
(``build_kernel_ms``); and the sweep's reduce kernel's work items and
bound at the same windows (``sweep_reduce``).  It is the ``chip_smoke.py`` beside this script that
runs, so the script copied into another tree's checkout times that
tree's kernels with that tree's comparison.

Prints the card's name and power limit, each metric as a median with
quartiles, and last one JSON object.  Exits non-zero without a CUDA card.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import bench_torch as bt


def build_args(emb):
    """(index, build) of a flat span embedder: ``build()`` makes this
    step's structures as ``core/step.py:profiled_step`` does.  No public
    accessor gives the index and the device tables, so they are read from
    the embedder's private state."""
    impl = emb.impl
    index = impl._index

    def build():
        pos = impl.state.positions
        in_index = index.draw_members(impl.state.generator)
        return index.structures(pos, impl._inv_w, impl._weights, impl._dg.colors, impl.opts, impl._blk_t,
                                in_index)

    return index, build


def time_builds(build, builds: int, warm: int) -> dict[str, list[float]]:
    """host_ms and event_ms of ``builds`` eager builds after ``warm``
    untimed ones, each started on an idle device."""
    import torch

    for _ in range(warm):
        build()
    torch.cuda.synchronize()
    host, event = [], []
    for _ in range(builds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        t0 = time.perf_counter()
        build()
        host.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        e1.synchronize()
        event.append(e0.elapsed_time(e1))
    return dict(host_ms=host, event_ms=event)


def trace_builds(build, builds: int) -> dict[str, float]:
    """device_ms and events a build, summed over the CUDA activity of a
    ``torch.profiler`` trace of ``builds`` eager builds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(builds):
            build()
        torch.cuda.synchronize()
    device = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(device_ms=sum(device) / builds, events=len(device) / builds)


def compare_build(name: str, emb) -> dict:
    """``chip_smoke.compare_build`` (timed) at a flat span embedder's
    positions: {"build_kernels": each wrapper's ms a call, plain ms, bound
    and share, and the device times its timing holds; "build_ms": the
    whole build replayed; "build_kernel_ms": each kernel's device ms a
    build, from a trace of replays of the whole build as the step makes
    it, the same measure in any tree}."""
    import chip_smoke

    impl = emb.impl
    st = impl.state
    row = chip_smoke.compare_build(f"{name}_converged", chip_smoke.build_case(
        st.positions, impl._inv_w, impl._weights, impl._dg.colors, impl._index, impl.opts), timed=True)
    fields = ("ms", "plain_ms", "bound_ms", "share", "kernel_ms", "settled_kernel_ms")
    kernels = {k: {m: v[m] for m in fields if m in v}
               for k, v in row["timing"].items() if k in chip_smoke.BUILD_KERNELS}

    def build():
        return impl._index.structures(st.positions, impl._inv_w, impl._weights, impl._dg.colors, impl.opts,
                                      impl._blk_t, None)

    return dict(build_kernels=kernels, build_ms=row["build_ms"], build_kernel_ms=chip_smoke.replay_kernel_ms(build, 200),
                sweep_reduce=reduce_bound(emb))


def reduce_bound(emb) -> dict:
    """The sweep's ``span_reduce_kernel`` at the embedder's windows: its
    work items, and its least time by bytes, the (items, d + 3, 256) f32
    scratch read once and the (NQ, d + 3) outputs written once, over the
    card's memory rate."""
    import chip_smoke
    from wembed_tpu_torch.kernels import span_sweep

    impl = emb.impl
    d = impl.state.positions.shape[1]
    items = len(span_sweep.work_items(impl._blk_t.cpu().numpy()))
    nbytes = items * (d + 3) * 256 * 4 + impl._index.nq * (d + 3) * 4
    return dict(items=items, bytes=nbytes, bound_ms=nbytes / chip_smoke.HBM_BYTES * 1e3)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True, help="a flat span cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, default=1, help="seed of the run to convergence")
    parser.add_argument("--builds", type=int, default=200, help="timed eager builds")
    parser.add_argument("--traced", type=int, default=50, help="eager builds in the profiler's trace")
    parser.add_argument("--warm", type=int, default=20, help="untimed builds first")
    parser.add_argument("--compare-build", action="store_true",
                        help="also chip_smoke.py's timed compare_build at the converged positions")
    args = parser.parse_args(argv)
    import torch

    from wembed_tpu_torch import api

    if not torch.cuda.is_available():
        print("build_eager: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    cell = bt.find_cell(bt.load_benchmark(), args.workload)
    if cell["layered"] or "span_sweep" not in cell["kernels"]:
        print(f"build_eager: {cell['name']} is not a flat span cell", file=sys.stderr)
        return 1
    device = bt.card()
    spec = cell["graph"]
    path, proc, t0 = bt.start_graph(spec)
    bt.build_sources(tuple(cell["kernels"]))
    bt.finish_graph(spec, path, proc, t0)
    graph = api.graphFromEdgeListFile(str(path))
    _, emb = bt.one_run(graph, bt.cell_options(cell, None), args.seed, torch.device("cuda"))
    if emb.impl.path != "span":
        print(f"build_eager: {cell['name']} ran the {emb.impl.path} path", file=sys.stderr)
        return 1
    _, build = build_args(emb)
    samples = time_builds(build, args.builds, args.warm)
    traced = trace_builds(build, args.traced)
    out = {k: bt.summary(v) for k, v in samples.items()}
    for name, s in out.items():
        print(f"metric {name} = {s['value']!r} ms (median of {s['n']}; quartiles {s['q1']!r} .. {s['q3']!r})")
    for name, v in traced.items():
        print(f"metric {name} = {v!r} a build (trace of {args.traced})")
    if args.compare_build:
        out.update(compare_build(cell["name"], emb))
    print(json.dumps(dict(workload=cell["name"], seed=args.seed, iterations=emb.impl.iteration,
                          **out, **traced, device=device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
