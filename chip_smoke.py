#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port, ``wembed_tpu_torch``.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. a CUDA card is present; print torch/CUDA versions, the card's name and
     power limit; start making girg100k (phase 7) in a subprocess;
  2. build the CUDA kernels from ``wembed_tpu_torch/csrc`` (one nvcc per
     source) and the layered path's host label propagation (g++), all
     started together; print the kernels' registers and spills, and fail
     on any spill at d <= 4;
  3. hold the fused force kernel against its plain PyTorch version on the
     card: girg10k d=2 with degree weights at positions after 20 steps of
     a seeded run (timed), n = 16384, the largest dense size (timed),
     n = 1100 (a shape whose last columns the TPU kernel's grid skips),
     additive weights, a bipartite colouring and coincident points, at
     d = 2, 3, 4 and 8; and at the sizes of girg100k's coarse layers
     (n = 4, 22, 133, 713, 3699, d=2, degree weights on a random graph);
  4. the dense main path: ``wembed_tpu_torch.api``, girg10k, d=2, seed 1,
     ``calculateEmbedding()``, which must converge before 1000 iterations,
     launch the kernel once per iteration, keep every state tensor finite
     and reach a total loss within 1.15x the C++ reference's; its MAP,
     constructDeg and F1 (1000 node samples ranked on the card), MAP at
     least 0.70; a profile of 20 further steps; seeds 2-4 and seed 1 with
     one column split in the kernel, each within the same limits (MAP
     included);
  5. the ``embed`` CLI as a subprocess, which must write a 10,000-row CSV;
  6. the layered CLIs on girg10k: ``embed --layered`` must write 10,000
     rows and ``evaluate`` on them print the evaluator's header and one row
     of five finite metrics; then a layered API run with reference
     expansion, which must converge with finite state after a first
     expanded step with coincident pairs;
  7. girg100k d=2 from the port's ``generate`` CLI (cached in
     ``build/graphs/``), checked by md5 and by n and m against
     ``baselines/reference_measured.json``;
  8. hold the span sweep kernel against its plain version on the card:
     girg100k d=2 at positions after 20 steps of a seeded run (timed; then
     with one tile a work item, and timed at other item sizes), girg100k
     d=4 after 20 steps (timed), and synthetic cases with additive weights
     at d=3, a bipartite colouring, coincident points at d=4 and starved
     windows;
  9. the span main path: the API on girg100k, d=2, seed 1,
     ``calculateEmbedding()``: below 1000 iterations, one sweep launch per
     iteration, final overflow 0, every state tensor finite, total loss
     within 1.15x the C++ reference's, MAP at least 0.9x the C++
     reference's; then a breakdown of a step at the converged positions by
     CUDA events (with the sweep at other item sizes) and a profile of 20
     further steps;
 10. the layered main path: the API with ``layeredEmbedding=True`` on
     girg100k, d=2, seed 1: a ``layer`` line a layer, every layer below
     1000 iterations, the dense kernel launched once per iteration of the
     dense layers and the sweep once per iteration of the span layers,
     final overflow 0, every state tensor finite, MAP at least 0.74 and
     above the flat run's; then the ranking on the card against the host
     loop on 128 pinned vertices.

Every kernel comparison also launches the kernel twice on the same inputs
and fails unless the two outputs are bitwise equal.  The line before the
last is a JSON summary of the kernels (time, bound, launches on the main
paths, flat and layered); the last line is ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
GIRG10K = REPO / "assets" / "girg10k.edg"
GIRG100K = REPO / "build" / "graphs" / "girg100k_d2.edg"
GIRG100K_FLAGS = ["-n", "100000", "-d", "2", "-s", "1", "--avg-deg", "15", "--ple", "2.5"]
GIRG100K_MD5 = "2da04136ab08cc3830049310680a0815"  # the JAX package's generator, same flags
GIRG100K_LAYERS = (4, 22, 133, 713, 3699)  # its dense coarse layers (seed 1, default partitioner)
REFERENCE = REPO / "baselines" / "reference_measured.json"
KERNELS = ("fused_dense", "span_sweep")
HOST_SOURCES = ("labelprop",)  # host C++ of the layered path, built with g++ beside the kernels
LOSS_FACTOR = 1.15  # total loss may exceed the C++ reference's by at most this
FORCE_RTOL = 1e-5  # summation order differs between the kernel and the plain version
FORCE_ATOL = 1e-5  # times max|force|
LOSS_RTOL = 1e-5
COMPARE_STEPS = 20
F32_FLOPS = 67e12  # H100 SXM FP32 peak outside the tensor cores (data sheet)
HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
RARE_FLOP = 14  # FLOP of a candidate or neighbour pair beyond the common path
SPILL_FREE_DIMS = (1, 2, 3, 4)
NODE_SAMPLES = 1000  # the evaluator's default sample of ranked vertices
MAP_FLAT_GIRG10K = 0.70
MAP_FACTOR = 0.9  # MAP at least this times the target's
MAP_LAYERED_TARGET = 0.823  # the JAX package's layered girg100k d=2 (baselines/tpu_measured.json)
PINNED = 128
EVAL_TOL = 1e-12
EVALUATE_HEADER = (  # the evaluator CLI's columns, as wembed_tpu/cli/evaluate.py prints them
    "edge-list-path,embedding-path,emb-type,seed,edge-sample-factor,node-sample-percent,"
    "num_nodes,num_edges,constructDeg,MAP,precision,recall,edgeF1"
)
STATE_TENSORS = ("positions", "adam_m", "adam_v", "attract_loss", "repel_loss", "pos_change")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes")."""
    ops_ms, bytes_ms = flop / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def spills(log: str) -> dict:
    """{kernel entry: (spill store bytes, spill load bytes)} from ptxas -v."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = (int(m.group(1)), int(m.group(2)))
    return out


def check_no_spills(name: str, log: str, kernel: str) -> None:
    """Fail unless ptxas reports ``kernel<D>`` spill-free for every D of
    SPILL_FREE_DIMS (mangled as ...kernelILi<D>EE...)."""
    found = spills(log)
    for d in SPILL_FREE_DIMS:
        entry = [k for k in found if f"{kernel}ILi{d}E" in k]
        check(len(entry) == 1, f"{name}: no ptxas report for {kernel}<{d}>")
        check(found[entry[0]] == (0, 0), f"{name}: {kernel}<{d}> spills {found[entry[0]]}")


def same_twice(name: str, first, fn) -> None:
    """A second launch on the same inputs must give bitwise equal outputs."""
    import torch

    second = fn()
    for a, b in zip(first, second):
        check(bool(torch.equal(a, b)), f"{name}: two launches differ")


def forces_agree(f_k, f_p) -> tuple[bool, float, float]:
    """(every entry within FORCE_RTOL + FORCE_ATOL x max|force|, max abs
    error, max|force|) of a kernel's forces against the plain version's."""
    import torch

    scale = float(f_p.abs().max())
    diff = (f_k - f_p).abs()
    ok = bool(torch.all(diff <= FORCE_ATOL * scale + FORCE_RTOL * f_p.abs()))
    return ok, float(diff.max()), scale


def synthetic_case(n, d, *, additive=False, bipartite=False, coincident=False, grid=False, edges=True, seed=0):
    """Inputs for the kernel comparison, as CUDA tensors."""
    import numpy as np
    import torch

    from wembed_tpu_torch.kernels.fused_dense import adjacency_bits

    rng = np.random.default_rng(seed)
    side = n ** (1.0 / d)
    if grid:  # multiples of 1/64: every difference and square is exact
        pos = rng.integers(0, int(side) * 64, size=(n, d)) / 64.0
    else:
        pos = rng.uniform(0.0, side, size=(n, d))
    if coincident:
        pos[1::7] = pos[0::7][: pos[1::7].shape[0]]
    w = rng.pareto(2.0, n) + 1.0
    invw = (w * n / w.sum()) ** (-1.0 / d) if edges else np.ones(n)
    colors = np.arange(n) % 2 if bipartite else np.arange(n)
    src, dst = np.zeros(0, np.int64), np.zeros(0, np.int64)
    if edges:
        src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
        keep = src != dst
        src, dst = np.r_[src[keep], dst[keep]], np.r_[dst[keep], src[keep]]
    dev = torch.device("cuda")
    return dict(
        pos=torch.tensor(pos, dtype=torch.float32, device=dev),
        invw=torch.tensor(invw, dtype=torch.float32, device=dev),
        colors=torch.tensor(colors, dtype=torch.int32, device=dev),
        adj=adjacency_bits(torch.tensor(src, device=dev), torch.tensor(dst, device=dev), n),
        additive=additive, edges=int(src.shape[0]),
    )


def girg10k_case():
    """girg10k, d=2, degree weights, positions after COMPARE_STEPS seeded steps."""
    import torch

    from wembed_tpu_torch import api
    from wembed_tpu_torch.core import forces
    from wembed_tpu_torch.core.state import DeviceGraph
    from wembed_tpu_torch.core.weights import inv_exp_weights

    api.setSeed(1)
    graph = api.graphFromEdgeListFile(str(GIRG10K))
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
    for _ in range(COMPARE_STEPS):
        embedder.calculateStep()
    dev = torch.device("cuda")
    dg = DeviceGraph.build(graph.csr, dev)
    return dict(
        pos=torch.tensor(embedder.impl.get_coordinates(), dtype=torch.float32, device=dev),
        invw=torch.tensor(inv_exp_weights(embedder.impl.get_weights(), 2), dtype=torch.float32, device=dev),
        colors=dg.colors,
        adj=forces.build_dense_adjacency(dg),
        additive=False, edges=graph.getNumEdges() * 2,
    )


def degree_case(n, seed):
    """Inputs for the kernel comparison at a coarse layer's size: a random
    graph with rescaled degree weights at d=2, built as the embedder builds
    its own (CUDA tensors)."""
    import numpy as np
    import torch

    from wembed_tpu_torch.core import EmbedderOptions, forces
    from wembed_tpu_torch.core.state import DeviceGraph
    from wembed_tpu_torch.core.weights import initial_weights, inv_exp_weights
    from wembed_tpu_torch.graphs import from_edges

    rng = np.random.default_rng(seed)
    g = from_edges(rng.integers(0, n, size=(4 * n, 2)), num_vertices=n)
    w = initial_weights(g, EmbedderOptions(embedding_dimension=2))
    dev = torch.device("cuda")
    dg = DeviceGraph.build(g, dev)
    return dict(
        pos=torch.tensor(rng.uniform(0.0, n ** 0.5, size=(n, 2)), dtype=torch.float32, device=dev),
        invw=torch.tensor(inv_exp_weights(w, 2), dtype=torch.float32, device=dev),
        colors=dg.colors,
        adj=forces.build_dense_adjacency(dg),
        additive=False, edges=g.num_directed_edges,
    )


def compare(name: str, case: dict, timed: bool) -> dict:
    """Kernel against the plain version on the same CUDA tensors."""
    import torch

    from wembed_tpu_torch.kernels import fused_dense

    n, d = case["pos"].shape
    args = (case["pos"], case["invw"], case["colors"], case["adj"])
    kw = dict(dim=d, L=1.0, att_scale=1.0, rep_scale=1.0, additive=case["additive"])
    out = fused_dense.fused_dense_forces(*args, **kw)
    f_k, z_k, a_k, r_k, c_k = out
    torch.cuda.synchronize()
    same_twice(name, out, lambda: fused_dense.fused_dense_forces(*args, **kw))
    f_p, z_p, a_p, r_p, c_p = fused_dense.fused_dense_forces_reference(*args, **kw)
    torch.cuda.synchronize()
    ok_force, err, scale = forces_agree(f_k, f_p)
    row = dict(
        case=name, n=case["pos"].shape[0], d=d,
        rep_count=[int(c_k), int(c_p)], zero_sum=[int(z_k.sum()), int(z_p.sum())],
        att_loss=[float(a_k), float(a_p)], rep_loss=[float(r_k), float(r_p)],
        max_abs_force=scale, max_abs_err=err,
        splits=fused_dense._split_cache.get((n, d, case["pos"].device.index)),
    )
    if timed:
        row["ms"] = cuda_ms(lambda: fused_dense.fused_dense_forces(*args, **kw), 50)
        row["plain_ms"] = cuda_ms(lambda: fused_dense.fused_dense_forces_reference(*args, **kw), 5)
        # every pair's common path, plus the rare path of candidates and neighbours
        flop = n * n * (3 * d + 3) + (int(c_p) + case["edges"]) * RARE_FLOP
        row["bound_ms"], row["bound_by"] = bound(flop, nbytes(*args, f_k, z_k) + 16)
    print("compare " + json.dumps(row))
    check(int(c_k) == int(c_p), f"{name}: rep count {int(c_k)} != {int(c_p)}")
    check(bool(torch.equal(z_k, z_p)), f"{name}: zero counts differ")
    check(ok_force, f"{name}: forces differ by up to {err} (max|force| {scale})")
    for label, k, p in (("att", a_k, a_p), ("rep", r_k, r_p)):
        k, p = float(k), float(p)
        check(abs(k - p) <= LOSS_RTOL * abs(p), f"{name}: {label} loss {k} != {p}")
    return row


def evaluate_embedding(csr, coords, weights, seed: int = 1) -> dict:
    """MAP and constructDeg (NODE_SAMPLES vertices ranked on the card) and
    edge-detection precision, recall and F1 (host sampling) of a weighted
    embedding, with the evaluator CLI's random stream for ``--seed``."""
    import numpy as np
    import torch

    from wembed_tpu_torch.eval import edge_detection_metrics, reconstruction_metrics
    from wembed_tpu_torch.eval.spaces import WeightedGeometric

    rng = np.random.default_rng(seed)
    space = WeightedGeometric(coords, weights=weights)
    t0 = time.perf_counter()
    out = reconstruction_metrics(csr, space, NODE_SAMPLES, rng, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out.update(edge_detection_metrics(csr, space, 10.0, rng))
    out.update(ranking_s=t1 - t0, edge_detection_s=time.perf_counter() - t1)
    return out


def check_finite(state, what: str) -> None:
    import torch

    for name in STATE_TENSORS:
        check(bool(torch.isfinite(getattr(state, name)).all()), f"non-finite {name} {what}")


def layered_clis(tmp: Path) -> dict:
    """``embed --layered`` on girg10k, then ``evaluate`` on its CSV, each a
    subprocess on the card."""
    import math

    out = tmp / "girg10k_layered.csv"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wembed_tpu_torch.cli.embed", "-i", str(GIRG10K), "-o", str(out),
         "--seed", "1", "--dim", "2", "--layered"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    embed_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"layered CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    rows = out.read_text().splitlines() if out.exists() else []
    check(len(rows) == 10000, f"layered CLI wrote {len(rows)} rows")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wembed_tpu_torch.cli.evaluate", "-g", str(GIRG10K), "-e", str(out),
         "--seed", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    evaluate_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"evaluate CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    check(len(lines) == 2 and lines[0] == EVALUATE_HEADER, f"evaluate CLI printed {lines!r}")
    values = lines[1].split(",")
    metrics = dict(zip(EVALUATE_HEADER.split(",")[-5:], (float(v) for v in values[-5:])))
    check(all(math.isfinite(v) for v in metrics.values()), f"evaluate CLI metrics {metrics}")
    return dict(rows=len(rows), embed_s=embed_s, evaluate_s=evaluate_s, **metrics)


def reference_expansion_run(graph) -> dict:
    """The layered API run with reference expansion (children on their
    parents): it must converge with finite state, and the first expanded
    layer must start with coincident pairs, which only the kicks separate."""
    from wembed_tpu_torch import api
    from wembed_tpu_torch.core import WEmbedEmbedder
    from wembed_tpu_torch.kernels.fused_dense import fused_dense_forces_reference

    starts = []

    def factory(layer_graph, opts, **kw):
        emb = WEmbedEmbedder(layer_graph, opts, **kw)
        check(emb.path == "dense", "girg10k's layers all take the dense path")
        zero = fused_dense_forces_reference(
            emb.state.positions, emb._inv_w, emb._dg.colors, emb._adj, dim=2, L=opts.edge_length,
            att_scale=opts.attraction_scale, rep_scale=opts.repulsion_scale, additive=False,
        )[1]
        starts.append(dict(n=layer_graph.num_vertices, coincident=int(zero.sum())))
        return emb

    api.setSeed(1)
    embedder = api.createEmbedder(
        graph, api.Options(embeddingDimension=2, layeredEmbedding=True, expansionMode="reference")
    )
    embedder.impl.embedder_factory = factory  # every layer after the coarsest
    t0 = time.perf_counter()
    embedder.calculateEmbedding()
    wall = time.perf_counter() - t0
    impl = embedder.impl
    iterations = [r.iterations for r in impl.layer_records]
    row = dict(layers=[r.n for r in impl.layer_records], iterations=iterations, wall_s=wall,
               first_expanded=starts[0] if starts else None, total_loss=embedder.getLoss().total)
    print("layered_reference " + json.dumps(row))
    check(embedder.isFinished(), "reference expansion: not finished")
    check(all(0 < it < 1000 for it in iterations), f"reference expansion: iterations {iterations}")
    check_finite(impl.state, "after reference expansion")
    check(bool(starts) and starts[0]["coincident"] > 0,
          f"reference expansion: no coincident pair at the first expanded step ({starts[:1]})")
    return row


def layered_main_path(graph, flat_map: float) -> dict:
    """The layered API run on girg100k with both kernels' counts set to 0
    just before ``calculateEmbedding()`` and read just after."""
    import dataclasses

    import torch

    from wembed_tpu_torch import api
    from wembed_tpu_torch.kernels import fused_dense, span_sweep

    api.setSeed(1)
    torch.cuda.reset_peak_memory_stats()  # each layer records the peak since here
    t0 = time.perf_counter()
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2, layeredEmbedding=True))
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    impl = embedder.impl
    fused_dense.fused_dense_forces.launches = 0
    span_sweep.span_sweep.launches = 0
    t0 = time.perf_counter()
    embedder.calculateEmbedding()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fused_dense=fused_dense.fused_dense_forces.launches,
                    span_sweep=span_sweep.span_sweep.launches)
    records = impl.layer_records
    for r in records:
        print("layer " + json.dumps(dataclasses.asdict(r)))
    coords, weights = embedder.impl.get_coordinates(), embedder.impl.get_weights()
    quality = evaluate_embedding(graph.csr, coords, weights)
    row = dict(
        graph="girg100k", n=graph.getNumVertices(), dim=2, seed=1, layers=len(records),
        hierarchy_s=impl.hierarchy_seconds, create_s=create_s, wall_s=wall,
        construct_s=sum(r.construct_s for r in records), loop_s=sum(r.loop_s for r in records),
        iterations=impl.iteration, launches=launches, total_loss=embedder.getLoss().total,
        peak_mem_bytes=max(r.peak_mem_bytes for r in records), flat_map=flat_map, **quality,
    )
    print("main_path_layered " + json.dumps(row))
    for r in records:
        check(0 < r.iterations < 1000, f"layer n={r.n}: {r.iterations} iterations")
        check(r.final_overflow == 0, f"layer n={r.n}: final overflow {r.final_overflow}")
    for kernel, path in (("fused_dense", "dense"), ("span_sweep", "span")):
        want = sum(r.iterations for r in records if r.path == path)
        check(launches[kernel] == want > 0,
              f"{kernel}: {launches[kernel]} launches for {want} iterations of the {path} layers")
    check(impl.iteration == sum(r.iterations for r in records), "layered iterations do not add up")
    check_finite(impl.state, "on the layered path")
    target = MAP_FACTOR * MAP_LAYERED_TARGET
    check(row["MAP"] >= target, f"layered MAP {row['MAP']} < {target}")
    check(row["MAP"] > flat_map, f"layered MAP {row['MAP']} <= the flat run's {flat_map}")
    return dict(row, embedding=(coords, weights))


def pinned_ranking(csr, coords, weights) -> dict:
    """The ranking on the card against the host loop on PINNED vertices:
    the same ids and degrees, precisions within EVAL_TOL."""
    import numpy as np

    from wembed_tpu_torch.eval import sample_node_entries
    from wembed_tpu_torch.eval.device import sample_node_entries_device
    from wembed_tpu_torch.eval.spaces import WeightedGeometric

    ids = np.random.default_rng(7).permutation(csr.num_vertices)[:PINNED]
    space = WeightedGeometric(coords, weights=weights)
    t0 = time.perf_counter()
    dev = sample_node_entries_device(csr, space, 0, node_ids=ids, device="cuda")
    t1 = time.perf_counter()
    host = sample_node_entries(csr, space, 0, node_ids=ids)
    t2 = time.perf_counter()
    err = max(max(abs(a.deg_precision - b.deg_precision), abs(a.average_precision - b.average_precision))
              for a, b in zip(dev, host))
    row = dict(ids=PINNED, max_abs_err=err, device_s=t1 - t0, host_s=t2 - t1)
    print("pinned_ranking " + json.dumps(row))
    check([(e.v, e.deg) for e in dev] == [(e.v, e.deg) for e in host], "pinned ranking: ids or degrees differ")
    check(err <= EVAL_TOL, f"pinned ranking: precisions differ by {err}")
    return row


def start_girg100k():
    """Make girg100k with the port's generator in a subprocess, unless the
    cached file is already the right one.  Returns (process or None, t0)."""
    if GIRG100K.exists() and hashlib.md5(GIRG100K.read_bytes()).hexdigest() == GIRG100K_MD5:
        return None, time.perf_counter()
    GIRG100K.parent.mkdir(parents=True, exist_ok=True)
    tmp = GIRG100K.with_name(GIRG100K.name + ".tmp")
    proc = subprocess.Popen(
        [sys.executable, "-m", "wembed_tpu_torch.cli.generate", "-o", str(tmp), *GIRG100K_FLAGS],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, time.perf_counter()


def finish_girg100k(proc, t0) -> float:
    """Wait for the generator; returns its wall seconds (0.0 when cached)."""
    if proc is None:
        return 0.0
    out, err = proc.communicate(timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"generate exit {proc.returncode}: {err[-2000:]}")
    print(f"generate girg100k: {out.strip()}, {seconds:.3f} s")
    GIRG100K.with_name(GIRG100K.name + ".tmp").replace(GIRG100K)
    return seconds


def span_case(positions, inv_w, weights, colors, idx, opts, k=None):
    """Inputs of the span sweep at the given CUDA tensors and windows, in
    work items of at most ``k`` tiles (default: the port's)."""
    import torch

    from wembed_tpu_torch.kernels import span_sparse, span_sweep

    s = span_sparse.build_span_structures(positions, inv_w, weights, colors, idx, opts)
    t = idx.tensors(positions.device)
    items = torch.as_tensor(
        span_sweep.work_items(idx.blk_t, k or span_sweep.WORK_ITEM_TILES), device=positions.device
    )
    return dict(
        args=(s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off),
        kw=dict(dim=idx.d, L=opts.edge_length, rep_scale=opts.repulsion_scale,
                additive=opts.additive_weights, items=items),
        n=idx.n, tiles=idx.w, items=int(items.shape[0]), overflow=int(s.overflow),
    )


def synthetic_span_case(n, d, *, additive=False, bipartite=False, coincident=False,
                        starved=False, seed=0):
    """A random graph with heavy-tailed weights at positions in the random-
    start cube; windows sized to the measured needs, or pinned to one tile
    at spread positions (``starved``)."""
    import numpy as np
    import torch

    from wembed_tpu_torch.core import EmbedderOptions
    from wembed_tpu_torch.core.weights import inv_exp_weights
    from wembed_tpu_torch.graphs import from_edges
    from wembed_tpu_torch.kernels import span_sparse

    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, n ** (1.0 / d), size=(n, d)) * (100.0 if starved else 1.0)
    if coincident:
        pos[1::7] = pos[0::7][: pos[1::7].shape[0]]
    w = rng.pareto(2.0, n) + 1.0
    g = from_edges(rng.integers(0, n, size=(4 * n, 2)), num_vertices=n)
    colors = np.arange(n) % 2 if bipartite else np.arange(n)
    opts = EmbedderOptions(embedding_dimension=d, additive_weights=additive)
    idx = span_sparse.SpanIndex.build(w, opts, g.edge_src, g.col_idx)
    dev = torch.device("cuda")
    tensors = (
        torch.tensor(pos, dtype=torch.float32, device=dev),
        torch.tensor(inv_exp_weights(w, d), dtype=torch.float32, device=dev),
        torch.tensor(w, dtype=torch.float32, device=dev),
        torch.tensor(colors, dtype=torch.int32, device=dev),
    )
    if starved:
        idx = idx._with_blk_t(np.minimum(idx.blk_t, 1))
    else:
        for _ in range(6):
            s = span_sparse.build_span_structures(*tensors, idx, opts)
            grown = idx.grow_from_needs(s.need.cpu().numpy())
            if int(s.overflow) == 0 or grown is None:
                break
            idx = grown
    return span_case(*tensors, idx, opts)


def compare_span(name: str, case: dict, timed: bool) -> dict:
    """The span sweep kernel against its plain version on the same CUDA
    tensors."""
    import torch

    from wembed_tpu_torch.kernels import span_sweep

    args, kw = case["args"], case["kw"]
    out = span_sweep.span_sweep(*args, **kw)
    f_k, l_k, c_k, z_k = out
    torch.cuda.synchronize()
    same_twice(name, out, lambda: span_sweep.span_sweep(*args, **kw))
    f_p, l_p, c_p, z_p = span_sweep.span_sweep_reference(*args, **kw)
    torch.cuda.synchronize()
    ok_force, err, scale = forces_agree(f_k, f_p)
    loss_k, loss_p = float(l_k.double().sum()), float(l_p.double().sum())
    row = dict(
        case=name, n=case["n"], d=kw["dim"], work_tiles=case["tiles"], items=case["items"],
        overflow=case["overflow"],
        rep_count=[int(c_k.sum()), int(c_p.sum())], zero_sum=[int(z_k.sum()), int(z_p.sum())],
        rep_loss=[loss_k, loss_p], max_abs_force=scale, max_abs_err=err,
    )
    if timed:
        row["ms"] = cuda_ms(lambda: span_sweep.span_sweep(*args, **kw), 20)
        row["plain_ms"] = cuda_ms(lambda: span_sweep.span_sweep_reference(*args, **kw), 3)
        # every (slot, member) pair of the work tiles, plus the candidates' rare path
        d = kw["dim"]
        flop = case["tiles"] * span_sweep.Q * span_sweep.ST * (3 * d + 1) + int(c_p.sum()) * RARE_FLOP
        row["bound_ms"], row["bound_by"] = bound(flop, nbytes(*args, kw["items"], *out))
    print("compare_span " + json.dumps(row))
    check(bool(torch.equal(c_k, c_p)), f"{name}: candidate counts differ")
    check(bool(torch.equal(z_k, z_p)), f"{name}: zero counts differ")
    check(ok_force, f"{name}: forces differ by up to {err} (max|force| {scale})")
    check(abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p), f"{name}: loss {loss_k} != {loss_p}")
    check(int(c_p.sum()) > 0, f"{name}: no candidate pairs")
    return row


def span_breakdown(impl) -> dict:
    """Milliseconds of the parts of one span step at the current positions
    and windows, by CUDA events, and the host wall of whole steps."""
    import torch

    from wembed_tpu_torch.kernels import span_sparse

    st = impl.state
    args = (st.positions, impl._inv_w, impl._weights, impl._dg.colors, impl._index, impl.opts)
    s = impl._span_structures()
    gen = torch.Generator(device=st.positions.device).manual_seed(0)
    parts = dict(
        structures_ms=cuda_ms(impl._span_structures, 20),
        sweep_ms=cuda_ms(lambda: span_sparse._sweep(s, impl._index, impl.opts, impl._items), 20),
        forces_ms=cuda_ms(
            lambda: span_sparse.span_fused_forces(*args, gen, structures=s, items=impl._items), 20
        ),
    )
    parts["edge_pass_ms"] = parts["forces_ms"] - parts["sweep_ms"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        impl._state = impl._step(impl._state)
        impl._state.pos_change.item()  # the loop's one synchronisation a step
    parts["step_wall_ms"] = (time.perf_counter() - t0) * 1000.0 / 20
    block_tiles = impl._index.blk_t.sum(axis=1)
    # the sweep's CTAs are query blocks: the longest one bounds the call
    t = impl._index.tensors(st.positions.device)
    parts["item_sizes"] = span_item_sizes(
        (s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off),
        dict(dim=impl._index.d, L=impl.opts.edge_length, rep_scale=impl.opts.repulsion_scale,
             additive=impl.opts.additive_weights),
    )
    items = impl._items
    parts.update(work_tiles=impl._index.w, blocks=int(block_tiles.shape[0]),
                 max_block_tiles=int(block_tiles.max()), mean_block_tiles=float(block_tiles.mean()),
                 items=int(items.shape[0]), max_item_tiles=int(items[:, 3].max()))
    return parts


def profile_steps(impl, steps: int = 20) -> dict:
    """A ``torch.profiler`` window over ``steps`` steps of the main loop
    (each step ends in its one synchronisation): host ms a step, kernel
    launches and device ms a step, the device's idle share (kernel time is
    summed; the step's kernels run on one stream, so they do not overlap)
    and the five kernels that take the most device time.  The profiler's
    own overhead lengthens the host time, so the idle share is an upper
    bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            impl._state = impl._step(impl._state)
            impl._state.pos_change.item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    by_name: dict[str, float] = {}
    launches = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        launches += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1000.0
    device_ms = sum(by_name.values())
    if device_ms == 0.0:
        return dict(steps=steps, step_wall_ms=wall_ms / steps, device="not measured")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(
        steps=steps, step_wall_ms=wall_ms / steps, device_ms_per_step=device_ms / steps,
        launches_per_step=launches / steps, idle_share=1.0 - device_ms / wall_ms,
        top_ms_per_step={name[:60]: ms / steps for name, ms in top},
    )


def span_item_sizes(args, kw) -> dict:
    """Sweep ms (CUDA events) at work items of at most k tiles."""
    import torch

    from wembed_tpu_torch.kernels import span_sweep

    blk_t = args[4].cpu().numpy()
    out = {}
    for k in (2, 4, 8, 16, 32):
        items = torch.as_tensor(span_sweep.work_items(blk_t, k), device=args[0].device)
        out[k] = dict(items=int(items.shape[0]),
                      ms=cuda_ms(lambda: span_sweep.span_sweep(*args, **{**kw, "items": items}), 20))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only", file=sys.stderr)
        return 1

    # ---- phase 1: the card; girg100k starts generating in the background
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    kind = torch.cuda.get_device_name(0)
    gen_proc, gen_t0 = start_girg100k()
    try:
        return run_phases(kind, gen_proc, gen_t0)
    finally:
        if gen_proc is not None and gen_proc.poll() is None:
            gen_proc.kill()
            gen_proc.wait()


def run_phases(kind, gen_proc, gen_t0) -> int:
    import torch

    from wembed_tpu_torch import api
    from wembed_tpu_torch.kernels import _build, fused_dense, span_sweep

    # ---- phase 2: build, one compiler per source, all started together
    sources = KERNELS + HOST_SOURCES
    with ThreadPoolExecutor(len(sources)) as pool:
        infos = dict(zip(sources, pool.map(_build.build, sources)))
    for name, info in infos.items():
        print(f"build {name}: {info.seconds:.3f} s -> {info.path.name}")
        for line in info.log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print("  " + line.strip())
    check_no_spills("fused_dense", infos["fused_dense"].log, "fused_dense_kernel")
    check_no_spills("span_sweep", infos["span_sweep"].log, "span_sweep_kernel")

    # ---- phase 3: the dense kernel against its plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    girg = compare("girg10k_d2_step20", girg10k_case(), timed=True)
    compare("n16384_d2", synthetic_case(16384, 2, seed=9), timed=True)
    compare("n1100_grid_no_edges", synthetic_case(1100, 2, grid=True, edges=False, seed=1), False)
    compare("n1000_additive_d8", synthetic_case(1000, 8, additive=True, seed=2), False)
    compare("n1000_bipartite_d3", synthetic_case(1000, 3, bipartite=True, seed=3), False)
    coinc = compare("n1000_coincident_d4", synthetic_case(1000, 4, coincident=True, seed=4), False)
    check(coinc["zero_sum"][0] > 0, "the coincident case produced no coincident pairs")
    for i, n in enumerate(GIRG100K_LAYERS):  # the layered path's dense sizes
        compare(f"n{n}_degree_d2", degree_case(n, seed=20 + i), timed=True)

    # ---- phase 4: the dense main path
    references = json.loads(REFERENCE.read_text())["configs"]
    reference = references["girg10k_d2"]
    ref_total = reference["att_loss"] + reference["rep_loss"]
    api.setSeed(1)
    graph = api.graphFromEdgeListFile(str(GIRG10K))
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_dense.fused_dense_forces.launches = 0
    t0 = time.perf_counter()
    embedder.calculateEmbedding()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_dense.fused_dense_forces.launches
    state = embedder.impl.state
    iterations = state.iteration
    loss = embedder.getLoss()
    edges_per_s = graph.getNumEdges() * iterations / wall
    print(
        "main_path " + json.dumps(dict(
            graph="girg10k", n=graph.getNumVertices(), m=graph.getNumEdges(), dim=2, seed=1,
            iterations=iterations, launches=launches, att_loss=loss.attractive,
            rep_loss=loss.repulsive, total_loss=loss.total, reference_total_loss=ref_total,
            wall_s=wall, edges_per_s=edges_per_s,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
        ))
    )
    check(0 < iterations < 1000, f"did not converge before the cap ({iterations} iterations)")
    check(launches == iterations, f"{launches} kernel launches for {iterations} iterations")
    check_finite(state, "on the dense path")
    check(loss.total <= LOSS_FACTOR * ref_total, f"total loss {loss.total} > {LOSS_FACTOR} x {ref_total}")
    quality = evaluate_embedding(graph.csr, embedder.impl.get_coordinates(), embedder.impl.get_weights())
    print("quality_girg10k " + json.dumps(quality))
    check(quality["MAP"] >= MAP_FLAT_GIRG10K, f"girg10k MAP {quality['MAP']} < {MAP_FLAT_GIRG10K}")
    print("profile_dense " + json.dumps(profile_steps(embedder.impl)))
    del embedder, state
    # the f32 trajectory, hence the final loss, moves with the seed and with
    # the order of the force sums: seeds 2-4 must stay within the limits
    # too, and seed 1 is run again with the kernel's column splits set to 1
    # (each row then summed over all columns by one warp)
    split_key = (graph.getNumVertices(), 2, torch.cuda.current_device())
    for seed, splits in ((2, None), (3, None), (4, None), (1, 1)):
        api.setSeed(seed)
        embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
        chosen = fused_dense._split_cache.get(split_key)
        if splits is not None:
            fused_dense._split_cache[split_key] = splits
        embedder.calculateEmbedding()
        if chosen is not None:
            fused_dense._split_cache[split_key] = chosen
        it, seed_loss = embedder.impl.state.iteration, embedder.getLoss()
        seed_quality = evaluate_embedding(
            graph.csr, embedder.impl.get_coordinates(), embedder.impl.get_weights()
        )
        print("main_path_seed " + json.dumps(dict(
            seed=seed, splits=splits or chosen, iterations=it, att_loss=seed_loss.attractive,
            rep_loss=seed_loss.repulsive, total_loss=seed_loss.total,
            MAP=seed_quality["MAP"], edgeF1=seed_quality["edgeF1"],
        )))
        check(0 < it < 1000, f"seed {seed}: did not converge before the cap")
        check(seed_loss.total <= LOSS_FACTOR * ref_total, f"seed {seed}: total loss {seed_loss.total}")
        check(seed_quality["MAP"] >= MAP_FLAT_GIRG10K, f"seed {seed}: MAP {seed_quality['MAP']}")
        del embedder

    # ---- phase 5: the CLI
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "girg10k.csv"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "wembed_tpu_torch.cli.embed", "-i", str(GIRG10K),
             "-o", str(out), "--seed", "1", "--dim", "2"],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        cli_wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
        rows = out.read_text().splitlines() if out.exists() else []
        print(f"cli: rc 0, {len(rows)} rows, {cli_wall:.3f} s including start-up")
        check(len(rows) == 10000, f"CLI wrote {len(rows)} rows")

    # ---- phase 6: the layered CLIs and reference expansion, girg10k
    with tempfile.TemporaryDirectory() as tmp:
        print("layered_cli " + json.dumps(layered_clis(Path(tmp))))
    reference_expansion_run(graph)

    # ---- phase 7: girg100k
    gen_seconds = finish_girg100k(gen_proc, gen_t0)
    md5 = hashlib.md5(GIRG100K.read_bytes()).hexdigest()
    reference = references["girg100k_d2"]
    graph = api.graphFromEdgeListFile(str(GIRG100K))
    n, m = graph.getNumVertices(), graph.getNumEdges()
    print("girg100k " + json.dumps(dict(md5=md5, n=n, m=m, generate_s=gen_seconds)))
    check(md5 == GIRG100K_MD5, f"girg100k md5 {md5} != {GIRG100K_MD5}")
    check((n, m) == (reference["n"], reference["m"]), f"girg100k n={n} m={m}")

    # ---- phase 8: the span sweep kernel against its plain version
    api.setSeed(1)
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
    impl = embedder.impl
    for _ in range(COMPARE_STEPS):
        embedder.calculateStep()
    st = impl.state
    at20 = (st.positions, impl._inv_w, impl._weights, impl._dg.colors, impl._index, impl.opts)
    case = span_case(*at20)
    girg_span = compare_span("girg100k_d2_step20", case, timed=True)
    print("span_item_sizes " + json.dumps(span_item_sizes(case["args"], case["kw"])))
    del case
    compare_span("girg100k_d2_step20_k1", span_case(*at20, k=1), False)
    del embedder, impl, st, at20
    api.setSeed(1)
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=4))
    impl = embedder.impl
    for _ in range(COMPARE_STEPS):
        embedder.calculateStep()
    st = impl.state
    compare_span(
        "girg100k_d4_step20",
        span_case(st.positions, impl._inv_w, impl._weights, impl._dg.colors, impl._index, impl.opts),
        timed=True,
    )
    del embedder, impl, st
    compare_span("n20000_additive_d3", synthetic_span_case(20000, 3, additive=True, seed=5), False)
    compare_span("n20000_bipartite_d2", synthetic_span_case(20000, 2, bipartite=True, seed=6), False)
    coinc = compare_span("n20000_coincident_d4", synthetic_span_case(20000, 4, coincident=True, seed=7), False)
    check(coinc["zero_sum"][0] > 0, "the coincident span case produced no coincident pairs")
    starved = compare_span("n20000_starved_d2", synthetic_span_case(20000, 2, starved=True, seed=8), False)
    check(starved["overflow"] > 0, "the starved case did not truncate its windows")

    # ---- phase 9: the span main path
    ref_total = reference["att_loss"] + reference["rep_loss"]
    api.setSeed(1)
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
    impl = embedder.impl
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    span_sweep.span_sweep.launches = 0
    t0 = time.perf_counter()
    embedder.calculateEmbedding()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    span_launches = span_sweep.span_sweep.launches
    state = impl.state
    iterations = state.iteration
    loss = embedder.getLoss()
    overflow = int(state.overflow)
    print(
        "main_path_span " + json.dumps(dict(
            graph="girg100k", n=n, m=m, dim=2, seed=1, iterations=iterations,
            launches=span_launches, growth_events=impl.growth_events,
            shrink_events=impl._shrink_events, final_work_tiles=impl._index.w,
            final_overflow=overflow, att_loss=loss.attractive, rep_loss=loss.repulsive,
            total_loss=loss.total, reference_total_loss=ref_total, wall_s=wall,
            edges_per_s=m * iterations / wall,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
        ))
    )
    check(0 < iterations < 1000, f"span path did not converge before the cap ({iterations} iterations)")
    check(span_launches == iterations, f"{span_launches} sweep launches for {iterations} iterations")
    check(overflow == 0, f"span path ended with overflow {overflow}")
    check_finite(state, "on the span path")
    check(loss.total <= LOSS_FACTOR * ref_total, f"span total loss {loss.total} > {LOSS_FACTOR} x {ref_total}")
    flat = evaluate_embedding(graph.csr, impl.get_coordinates(), impl.get_weights())
    print("quality_girg100k " + json.dumps(flat))
    map_floor = MAP_FACTOR * reference["map"]
    check(flat["MAP"] >= map_floor, f"girg100k MAP {flat['MAP']} < {map_floor}")
    print("span_breakdown " + json.dumps(span_breakdown(impl)))
    print("profile_span " + json.dumps(profile_steps(impl)))
    del embedder, impl, state

    # ---- phase 10: the layered main path, girg100k
    layered = layered_main_path(graph, flat["MAP"])
    pinned_ranking(graph.csr, *layered["embedding"])

    print(json.dumps({"kernels": [
        {
            "name": "fused_dense_forces",
            "route": "cuda",
            "source": "wembed_tpu_torch/csrc/fused_dense.cu",
            "replaces": "wembed_tpu/kernels/fused_dense.py:192",
            "launches": launches,
            "launches_layered": layered["launches"]["fused_dense"],
            "max_abs_err": girg["max_abs_err"],
            "ms": girg["ms"],
            "plain_ms": girg["plain_ms"],
            "bound_ms": girg["bound_ms"],
            "bound_by": girg["bound_by"],
            "library_ms": None,  # no PyTorch call computes the masked force pass with its tallies
        },
        {
            "name": "span_sweep",
            "route": "cuda",
            "source": "wembed_tpu_torch/csrc/span_sweep.cu",
            "replaces": "wembed_tpu/kernels/span_sparse.py:1735",
            "launches": span_launches,
            "launches_layered": layered["launches"]["span_sweep"],
            "max_abs_err": girg_span["max_abs_err"],
            "ms": girg_span["ms"],
            "plain_ms": girg_span["plain_ms"],
            "bound_ms": girg_span["bound_ms"],
            "bound_by": girg_span["bound_by"],
            "library_ms": None,  # no PyTorch call computes the windowed sweep with its tallies
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
