#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port, ``wembed_tpu_torch``.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. a CUDA card is present; print torch/CUDA versions, the card's name and
     power limit; start making girg100k d=2 (phase 8) and d=4 (phase 13b),
     each in a subprocess;
  2. build the CUDA kernels from ``wembed_tpu_torch/csrc`` (one nvcc per
     source) and the layered path's host label propagation (g++), all
     started together, compiled even where a library of the same sources
     exists; print the kernels' registers and spills (and a
     ``ptxas_span_sweep``, ``ptxas_span_reduce``, ``ptxas_edge_pass`` and
     ``ptxas_span_build`` lines: the fast kernels' registers and spills at
     each d), and fail on any spill of the dense and sweep fast kernels in
     f32 at d <= 4 and on any in the sweep's reduction, the edge pass and
     the structures build (every instantiation, f32 and f64), and in the
     general dense and sweep kernels (a ``ptxas_general`` line: their
     seven instantiations);
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
  7. girg10k resumed: a run capped at 200 iterations, checkpointed and
     continued, against a fresh embedder (another seed) that loads the file
     and continues; final state bitwise equal, same iterations and kernel
     launches after the checkpoint.  Then girg10k with ``profile`` (the
     phase tree from CUDA events, one launch a step, converged within the
     loss limit; its wall beside phase 4's), and 20 steps with
     ``debug_checks``, which must pass clean;
  8. girg100k d=2 from the port's ``generate`` CLI (cached in
     ``build/graphs/``), checked by md5 and by n and m against
     ``baselines/reference_measured.json``;
  9. hold the span sweep kernel against its plain version on the card:
     girg100k d=2 at positions after 20 steps of a seeded run (timed; then
     with one tile a work item, and timed at other item sizes), girg100k
     d=4 after 20 steps (timed), and synthetic cases with additive weights
     at d=3, a bipartite colouring, coincident points at d=4, starved
     windows and, at d = 2, 4 and 8, an adversarial case for the tensor-core
     prefilter (members on the radius edge of a query at coordinates near
     1e4, coincident and far members, blocks and tiles that end in padding
     records); every fast-kernel case also prints a ``prefilter`` line (the
     kernel's own count of the pairs its prefilter passed, over the pairs
     swept, beside the candidates' share, and the largest |position|), and
     fails unless the prefilter passed at least the candidates;
 9c. hold the span edge pass kernel against its plain version on the
     card, in its three modes (fused, correction, attraction): forces,
     zero counts and counted neighbours bitwise equal, losses within
     LOSS_RTOL, one launch a pass of the kernel d asks for (d <= 8: the
     segment-major kernel, else the general variant); girg100k d=2 after
     20 steps (timed), in f64, with a partial index, over one rank's share
     of three and with coincident endpoints whose raw kick draws include a
     zero row, rows whose squares underflow (to 0 and to subnormals) and
     rows whose squares overflow (kernel and ``unit_rows`` bitwise); a hub
     of 10,500 edges with coincident spokes at d = 1, 2, 4, 8 (f32), d = 4
     (f64) and d = 9 (the general variant); rows wider than a CTA (d=300 in
     f32 and f64, d=520, d=2100 in f64) with a vertex of 300 edges; d=4
     after 20 steps (timed, in phase 9), the cell layout at d=4 (phase
     13b, timed), and converged girg100k d=2 (phase 10) and d=4 (phase
     13b): an ``edge_pass_converged`` line each (ms a call, bound, share,
     the run's launches);
 9d. hold the structures build's kernels (``kernels/span_build.py``: the
     principal frame's three, K = 2 and 3, from the positions; the axes
     kernel, K = 2 and 3, on their covariance, which the frame takes at d
     > 8; the records, from the static vertex rows; the windows) against
     their plain versions on the card, bitwise, each on the inputs the
     build hands it, and the whole build through the kernels against the
     build through the plain versions (every field bitwise, one launch of
     each kernel of the route): girg100k d=2 at its start positions
     (timed), in f64 (timed) and with a partial index; synthetic graphs at
     d = 1, 3 and 16 (the general route), in f64 at d = 3, and degenerate
     clouds (every point equal, points on a line); converged girg100k d=2
     (phase 10) and d=4 (phase 13b), timed (each wrapper and each of the
     frame's kernels from graph replays, beside the parent's frame route),
     with a ``windows_kernel`` line each (the windows kernel's ms a call
     from graph replays and its device ms from a trace of replays, also
     with every radius factor +inf, where nothing is searched; bound,
     shares, the card's name and power limit),
     the windows on adversarial inputs made from their records (ties,
     radius factors +inf and 0, planted NaN; f32 and f64), a
     ``build_trace`` line each (the kernels a build launches,
     through the kernels and through the plain versions, at most
     BUILD_LAUNCH_LIMIT, three for the frame and no cuBLAS product) and a
     ``step_launch_account`` (a replayed step's events by phase); the cell
     layout's build (the frame at K = 3) in phase 13b; and the windows
     alone on synthetic indexes (300 rows; a longest row of 16^k and
     16^k + 1; one of 2^21, with NB R max_row above 2^40 and an overflow
     above 2^32), f32 and f64, a ``compare_windows`` line each;
 9e. hold the sweep's reduction kernel alone (``span_sweep.span_reduce``)
     against its plain version, bitwise on every output, on synthetic
     scratches (-0.0, +-inf, NaN, subnormals, counts up to 4 x 256 x 256;
     empty first, middle and last blocks, one-item blocks, a block of 300
     items): the fast kernel at d = 1 ... 8, the general one at d = 16
     (f32) and d = 2 (f64), each whole and over a slice that starts and
     ends inside blocks, and a table of over 256 x 257 items (three search
     rounds); at converged girg100k d=2 (phase 10) and d=4 (phase 13b) on
     a sweep's own scratch (``span_sweep(scratch=)``, whose outputs must
     be that reduction's) and a slice of it, timed: a ``reduce_converged``
     line each (the reduction's device ms a call in a trace of
     sweep-then-reduce pairs, alone on the scratch, the bytes bound and
     share, ``torch.segment_reduce``'s device ms on the same scratch, the
     plain version's ms, the run's launches, the card);
 10. the span main path: the API on girg100k, d=2, seed 1,
     ``calculateEmbedding()``: below 1000 iterations, one sweep launch (and
     one of its reduction) and one edge pass launch per iteration, one
     launch of each build kernel per iteration and growth measurement,
     final overflow 0, every state tensor finite, total loss
     within 1.15x the C++ reference's, MAP at least 0.9x the C++
     reference's; then a breakdown of a step at the converged positions by
     CUDA events (with the sweep at other item sizes) and a profile of 20
     further steps;
 10c. the same run through the edge pass's plain version: its
     iterations, MAP and coordinates beside phase 10's, which must be
     equal, with both runs' tallied losses (printed; no kernel launch
     allowed);
 10b. the captured step (``core/step.py:StepGraph``): the Adam update
     with the optimizer schedule's device rows bitwise the update by host
     scalars on the card (t = 1 ... 1000, f32 and f64); girg10k (dense),
     girg100k (span) and girg100k with ``index_size=0.5``, 120 steps from
     seed 1 replayed from CUDA graphs and run eagerly: state bitwise
     equal, the same iterations, launches and window changes, at least one
     window change on the span runs and one capture a run; host ms a step
     of both modes, and from a trace one sweep, one reduction and the
     edge pass's two kernels (or one dense kernel) a replay;
 11. the layered main path: the API with ``layeredEmbedding=True`` on
     girg100k, d=2, seed 1: a ``layer`` line a layer, every layer below
     1000 iterations, the dense kernel launched once per iteration of the
     dense layers and the sweep once per iteration of the span layers,
     final overflow 0, every state tensor finite, MAP at least 0.74 and
     above the flat run's; then the ranking on the card against the host
     loop on 128 pinned vertices;
 12. girg100k resumed as in phase 7 (the cap a multiple of the span
     windows' resize interval; growth events and final overflow 0 equal
     too); the layered run stepped into its 18,190-vertex span layer,
     checkpointed there and continued, against a layered embedder from
     another seed that loads the file: hierarchy from the file, final
     coordinates bitwise equal, MAP at least 0.74; girg100k with
     ``profile`` as in phase 7;
 13. negative sampling on girg100k (10 negatives a vertex): finite state,
     every step's candidate count within [0.99 n k, n k], MAP and F1
     printed.
 13b. girg100k d=4 (the reference's default dimension; n and m checked
     against ``baselines/reference_measured.json``) under both span
     layouts: the cells sweep against its plain version at the positions
     after 20 steps of a ``span_layout="cells"`` run (timed; capacity,
     live and dead tiles), and the windows sweep at the same positions
     (timed); then ``WEmbedEmbedder`` with each layout, windows then
     cells, to convergence from seed 1: below 1000 iterations, one sweep
     launch a step (the fast kernel), final overflow 0, finite state,
     total loss within 1.15x and MAP at least 0.9x the C++ reference's;
     MAP and F1, and at the converged positions the structures build,
     sweep, edge pass and step by CUDA events (the sweep's share of the
     step) and a profile of 20 steps; then a cells run of 2 x 60 steps
     with a checkpoint between, bitwise equal to 120 straight steps.

And the general kernels, the partial index and the replicated backend:
  3b. the general dense kernel (f32 at d = 9, 12, 16, 24, 32, 33 and 64,
      f64 at d = 1, 2, 8 and 16 on n = 3,000; coincident points at d = 16
      and 33 and in f64 at d = 2 and 16; d = 300 on n = 400) against its
      plain version on synthetic cases and girg10k positions (timed at
      d=16 f32 and d=2 f64, with the kernel's own device ms from a trace;
      the d=16 positions after 20 steps crowded about their centroid until
      pairs repel), every case with candidate pairs and every force and
      coincident count bitwise the column-order fold (``dense_fold``, the
      general kernel's arithmetic in plain torch), and the row range
      [3000, 7000) of girg10k bitwise the whole launch's rows (fast kernel
      and f64);
  7b. girg10k at d=16 to convergence (the general dense kernel), 20 steps
      of girg10k on the span path at d=16 (the general sweep, then timed
      at its positions crowded as in 3b), girg10k in f64 to convergence
      within the loss and MAP limits, f64 on the card against the CPU (3
      steps, n = 3,200, dense and span, rtol 1e-9);
  9b. the general sweep at the (d, dtype) pairs of 3b on n = 8,000
      synthetic cases and at d = 300 on n = 2,000 (narrower clouds at
      d = 64 and 300, so that pairs repel), each item's partials bitwise
      the member-order fold (``sweep_fold``) and the outputs its reduction;
  13c. girg100k at d=16 through ``api.createEmbedder`` to convergence (the
      span path through the general sweep and reduction, the edge pass's
      general variant and the frame's general route): finite state, final
      overflow 0, below 1000 iterations, one general sweep launch a step;
      MAP, a profile of 20 steps (device ms a step, its top kernels), and
      the sweep at the converged positions against its plain version
      (timed, bitwise the fold);
  14. girg100k in f64 (the sweep timed at iteration 20, then to
      convergence within the limits), with ``index_size=0.5`` (exact
      sample sizes every step, overflow 0, MAP printed, bitwise resume);
      then the replicated backend, last, so that no earlier phase runs
      beside its NCCL group: the API with ``distributedMode="replicated"``
      on one NCCL rank bitwise phase 4's and phase 10's runs (layered:
      phase 11's layers and MAP), ``embed --distributed replicated`` under
      ``torch.distributed.run`` writing phase 5's CSV, and girg10k and
      girg100k on two ranks sharing the card over gloo (each rank's share
      and launches, the step time, the first step's reduced force against
      the single-device step, ranks identical, the loss and MAP limits;
      the all-reduce's share from a separate timed run of 50 steps); the
      same spawn runs both graphs on the halo backend too (gathered
      positions identical across the ranks, the first step's forces of
      each rank's rows against the single-device step, counts exact, the
      loss and MAP limits, the step time; each rank's peak memory on both
      backends).

And the halo backend and the native parser:
  15. on the one-rank NCCL group of phase 14: the API with
      ``distributedMode="halo"`` on girg10k (dense) and girg100k (span) to
      convergence within the flat limits, each first force pass against
      the single-device step's (f32 tolerance, counts exact); girg100k
      with ``halo_resident_structures=True``, bitwise the halo run (one
      rank's blocks are all of them), and at its converged positions each
      rank's resident sweep for 2, 4 and 8 ranks bitwise the whole sweep
      on its blocks; a profile of 20 further steps of each one-rank run,
      with the host operations that take the most time, and each
      collective's cost on one NCCL rank and on the two gloo ranks; layered girg100k through the halo backend (MAP at
      least 0.74); ``embed --distributed halo`` under
      ``torch.distributed.run`` (10,000 finite rows, the girg10k MAP
      floor); girg100k's edge list through the native parser and the
      Python loop (equal pairs, both times).

Every kernel comparison also launches the kernel twice on the same inputs
and fails unless the two outputs are bitwise equal.  The main paths must
launch the fast kernels only.  The line before the last is a JSON summary
of the kernels (time, bound, launches on the main paths: flat, layered,
profiled, resumed, the general kernels' runs, replicated, with a partial
index, on the halo backend: one rank, resident, layered, two ranks, and
girg100k d=4 in the cell layout, resumed, and in windows; the general
kernels' times and both layouts' d=4 sweeps); the last line is ``{"ok":
true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import gc
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
GIRG100K_D4 = REPO / "build" / "graphs" / "girg100k_d4.edg"  # the reference's default dimension
GIRG100K_D4_FLAGS = ["-n", "100000", "-d", "4", "-s", "1", "--avg-deg", "15", "--ple", "2.5"]
GIRG100K_D4_MD5 = "3c113cf38828864d4bf07e943d5bd850"  # the port's generator, these flags
CELLS_RESUME = 60  # steps on each side of the cells checkpoint
GIRG100K_LAYERS = (4, 22, 133, 713, 3699)  # its dense coarse layers (seed 1, default partitioner)
REFERENCE = REPO / "baselines" / "reference_measured.json"
KERNELS = ("fused_dense", "span_sweep", "edge_pass", "span_build")
BUILD_KERNELS = ("principal_frame", "principal_axes", "span_records", "span_windows")  # csrc/span_build.cu's wrappers
FRAME_KERNELS = ("frame_mean_kernel", "frame_axes_kernel", "frame_project_kernel")  # principal_frame's, d <= 8
BUILD_TRACE_BUILDS = 10  # structures builds in each traced window of build_trace
BUILD_LAUNCH_LIMIT = 41  # most kernels a structures build may launch, sorts and frame included
EDGE_MODES = ("fused", "correction", "attraction")  # kernels/edge_pass.py MODES
HOST_SOURCES = ("labelprop",)  # host C++ of the layered path, built with g++ beside the kernels
LOSS_FACTOR = 1.15  # total loss may exceed the C++ reference's by at most this
FORCE_RTOL = 1e-5  # summation order differs between the kernel and the plain version
FORCE_ATOL = 1e-5  # times max|force|
LOSS_RTOL = 1e-5
F64_RTOL = 1e-12  # the same in f64: forces (rtol and atol x max|force|) and losses
COMPARE_STEPS = 20
GENERAL_CASES = tuple((d, None) for d in (9, 12, 16, 24, 32, 33, 64)) + tuple(
    (d, "float64") for d in (1, 2, 8, 16))  # (d, dtype) of the general kernels' synthetic cases
GENERAL_SPAN_SPREAD = {64: 0.4, 300: 0.15}  # narrower clouds at these d, so that pairs repel
F32_FLOPS = 67e12  # H100 SXM FP32 peak outside the tensor cores (data sheet)
F64_FLOPS = 34e12  # H100 SXM FP64 peak outside the tensor cores (data sheet)
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
RESUME_CAP = 200  # iterations before the checkpoint; a multiple of span_resize_interval (50)
RESUME_LAYER_N = 18190  # girg100k's first span layer (seed 1, default partitioner)
PHASES = ("attracting_forces", "repelling_forces", "apply_forces", "gravity", "position_change")
NEGATIVE_SAMPLES = 10
DEBUG_STEPS = 20
REDUCE_STEPS = 50  # steps of the two-rank run that times its all-reduce
GRAPH_STEPS = 120  # steps of each step-graph run: past the window changes at 50 and 100
STEPS_TIMED = 20  # further single steps of each step-graph run, timed one by one
EDGE_S = 0.05  # idle seconds between a kernel-count trace's edges and its replays


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


def captured(fn):
    """A CUDA graph of one call of ``fn`` (after one eager call on a side
    stream), replayed once."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` replays of a
    CUDA graph of one call, by CUDA events: the device's time, without the
    host's work between calls (a wrapper's checks and ctypes call)."""
    import torch

    graph = captured(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flop: float, nbytes: float, f64: bool = False) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes"), the
    operations at the FP32 or FP64 rate outside the tensor cores."""
    ops_ms, bytes_ms = flop / (F64_FLOPS if f64 else F32_FLOPS) * 1e3, nbytes / HBM_BYTES * 1e3
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


def ptxas_usage(log: str, kernel: str, dim: str = "ILi{}E") -> dict:
    """{d: {registers, spill_stores, spill_loads}} of ``kernel<d>`` from
    ptxas -v (entries mangled as ...kernel followed by ``dim`` with d in
    it: ...kernelILi<d>E... for a first template argument d; d may also be
    a type, ``f`` or ``d``, as in ``dim="I{}E"`` for kernel<T>)."""
    import re

    out, d = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*" + kernel + dim.format(r"(\d+|[fd])"), line)
        if m or "Function properties for" in line:
            d = (int(m.group(1)) if m.group(1).isdigit() else m.group(1)) if m else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and d is not None:
            out.setdefault(d, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and d is not None:
            out.setdefault(d, {})["registers"] = int(m.group(1))
    return dict(sorted(out.items()))


def ptxas_entries(log: str) -> dict:
    """{kernel<type, args>: {registers, spill_stores, spill_loads}} of every
    entry in a ptxas -v log, named from the mangled names (``f`` float,
    ``d`` double, then the integer template arguments)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for _Z\w*?\d+([a-z_]+_kernel)I([fd])((?:Li\d+E)*)E", line)
        if m:
            args = [m.group(2), *re.findall(r"Li(\d+)E", m.group(3))]
            name = f"{m.group(1)}<{','.join(args)}>"
        elif "Function properties for" in line:
            name = None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return dict(sorted(out.items()))


def check_no_spills(name: str, log: str, kernel: str, dim: str = "ILi{}E") -> None:
    """Fail unless ptxas reports ``kernel<D>`` (every instantiation of it
    at D) spill-free for every D of SPILL_FREE_DIMS (mangled as in
    ``ptxas_usage``)."""
    found = spills(log)
    for d in SPILL_FREE_DIMS:
        entries = [k for k in found if kernel + dim.format(d) in k]
        check(len(entries) >= 1, f"{name}: no ptxas report for {kernel}<{d}>")
        for k in entries:
            check(found[k] == (0, 0), f"{name}: {k} spills {found[k]}")


def same_twice(name: str, first, fn) -> None:
    """A second launch on the same inputs must give bitwise equal outputs."""
    import torch

    second = fn()
    for a, b in zip(first, second):
        check(bool(torch.equal(a, b)), f"{name}: two launches differ")


def forces_agree(f_k, f_p) -> tuple[bool, float, float]:
    """(every entry within FORCE_RTOL + FORCE_ATOL x max|force|, F64_RTOL
    for both in f64, max abs error, max|force|) of a kernel's forces
    against the plain version's."""
    import torch

    rtol, atol = (F64_RTOL, F64_RTOL) if f_p.dtype == torch.float64 else (FORCE_RTOL, FORCE_ATOL)
    scale = float(f_p.abs().max()) if f_p.numel() else 0.0
    diff = (f_k - f_p).abs()
    ok = bool(torch.all(diff <= atol * scale + rtol * f_p.abs()))
    return ok, float(diff.max()) if diff.numel() else 0.0, scale


def losses_agree(k: float, p: float, dtype) -> bool:
    import torch

    return abs(k - p) <= (F64_RTOL if dtype == torch.float64 else LOSS_RTOL) * abs(p)


def synthetic_case(n, d, *, additive=False, bipartite=False, coincident=False, grid=False, edges=True,
                   seed=0, dtype=None, spread=1.0):
    """Inputs for the kernel comparison, as CUDA tensors (f32 unless
    ``dtype``), in the random-start cube times ``spread``."""
    import numpy as np
    import torch

    from wembed_tpu_torch.kernels.fused_dense import adjacency_bits

    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    side = n ** (1.0 / d) * spread
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
        pos=torch.tensor(pos, dtype=dtype, device=dev),
        invw=torch.tensor(invw, dtype=dtype, device=dev),
        colors=torch.tensor(colors, dtype=torch.int32, device=dev),
        adj=adjacency_bits(torch.tensor(src, device=dev), torch.tensor(dst, device=dev), n),
        additive=additive, edges=int(src.shape[0]),
    )


def girg10k_case(dim=2, dtype=None):
    """girg10k, degree weights, positions after COMPARE_STEPS seeded f32
    steps at dimension ``dim``, as ``dtype`` (default f32)."""
    import torch

    from wembed_tpu_torch import api
    from wembed_tpu_torch.core import forces
    from wembed_tpu_torch.core.state import DeviceGraph
    from wembed_tpu_torch.core.weights import inv_exp_weights

    dtype = dtype or torch.float32
    api.setSeed(1)
    graph = api.graphFromEdgeListFile(str(GIRG10K))
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=dim))
    for _ in range(COMPARE_STEPS):
        embedder.calculateStep()
    dev = torch.device("cuda")
    dg = DeviceGraph.build(graph.csr, dev)
    return dict(
        pos=torch.tensor(embedder.impl.get_coordinates(), dtype=dtype, device=dev),
        invw=torch.tensor(inv_exp_weights(embedder.impl.get_weights(), dim), dtype=dtype, device=dev),
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
    dtype = case["pos"].dtype
    args = (case["pos"], case["invw"], case["colors"], case["adj"])
    kw = dict(dim=d, L=1.0, att_scale=1.0, rep_scale=1.0, additive=case["additive"])
    general = fused_dense.fused_dense_forces.launches_general
    out = fused_dense.fused_dense_forces(*args, **kw)
    general = fused_dense.fused_dense_forces.launches_general - general
    f_k, z_k, a_k, r_k, c_k = out
    torch.cuda.synchronize()
    same_twice(name, out, lambda: fused_dense.fused_dense_forces(*args, **kw))
    f_p, z_p, a_p, r_p, c_p = fused_dense.fused_dense_forces_reference(*args, **kw)
    torch.cuda.synchronize()
    ok_force, err, scale = forces_agree(f_k, f_p)
    row = dict(
        case=name, n=case["pos"].shape[0], d=d, dtype=str(dtype).split(".")[1],
        kernel="general" if general else "fast",
        rep_count=[int(c_k), int(c_p)], zero_sum=[int(z_k.sum()), int(z_p.sum())],
        att_loss=[float(a_k), float(a_p)], rep_loss=[float(r_k), float(r_p)],
        max_abs_force=scale, max_abs_err=err,
        splits=None if general else fused_dense._split_cache.get((n, d, case["pos"].device.index)),
    )
    if general:  # the column-order fold, bitwise
        f_f, z_f = dense_fold(*args, **kw)
        row["bitwise_fold"] = bitwise(f_k, f_f) and bitwise(z_k, z_f)
    if timed:
        row["ms"] = cuda_ms(lambda: fused_dense.fused_dense_forces(*args, **kw), 50)
        row["plain_ms"] = cuda_ms(lambda: fused_dense.fused_dense_forces_reference(*args, **kw), 5)
        # every pair's common path, plus the rare path of candidates and neighbours
        flop = n * n * (3 * d + 3) + (int(c_p) + case["edges"]) * RARE_FLOP
        row["bound_ms"], row["bound_by"] = bound(
            flop, nbytes(*args, f_k, z_k) + 16, f64=dtype == torch.float64
        )
        if general:  # the kernel's own device time, without the wrapper's host work
            row["kernel_ms"] = traced_call_ms(
                lambda: fused_dense.fused_dense_forces(*args, **kw), "fused_dense_general_kernel", 20)
            row["share"] = row["bound_ms"] / row["kernel_ms"]
    print("compare " + json.dumps(row))
    if general:
        check(row["bitwise_fold"], f"{name}: the general kernel is not the column-order fold")
    check(int(c_k) == int(c_p), f"{name}: rep count {int(c_k)} != {int(c_p)}")
    check(bool(torch.equal(z_k, z_p)), f"{name}: zero counts differ")
    check(ok_force, f"{name}: forces differ by up to {err} (max|force| {scale})")
    for label, k, p in (("att", a_k, a_p), ("rep", r_k, r_p)):
        k, p = float(k), float(p)
        check(losses_agree(k, p, dtype), f"{name}: {label} loss {k} != {p}")
    return row


def compare_rows(name: str, case: dict, rows: tuple[int, int]) -> dict:
    """A row range of the dense kernel: bitwise the rows of the whole
    launch, and in agreement with the plain version's range."""
    import torch

    from wembed_tpu_torch.kernels import fused_dense

    d = case["pos"].shape[1]
    args = (case["pos"], case["invw"], case["colors"], case["adj"])
    kw = dict(dim=d, L=1.0, att_scale=1.0, rep_scale=1.0, additive=case["additive"])
    whole = fused_dense.fused_dense_forces(*args, **kw)
    part = fused_dense.fused_dense_forces(*args, **kw, rows=rows)
    plain = fused_dense.fused_dense_forces_reference(*args, **kw, rows=rows)
    torch.cuda.synchronize()
    r0, r1 = rows
    bitwise = bool(torch.equal(part[0], whole[0][r0:r1]) and torch.equal(part[1], whole[1][r0:r1]))
    ok_force, err, scale = forces_agree(part[0], plain[0])
    row = dict(case=name, rows=list(rows), d=d, dtype=str(case["pos"].dtype).split(".")[1],
               bitwise_equal_to_whole=bitwise, rep_count=[int(part[4]), int(plain[4])],
               max_abs_err=err, max_abs_force=scale)
    print("compare_rows " + json.dumps(row))
    check(bitwise, f"{name}: rows {rows} differ from the whole launch's")
    check(int(part[4]) == int(plain[4]) and bool(torch.equal(part[1], plain[1])),
          f"{name}: the range's counts differ from the plain version's")
    check(ok_force, f"{name}: the range's forces differ by up to {err}")
    return row


def crowd_scale(pos, invw, colors, adj, additive=False) -> float:
    """The largest 0.8^k by which ``pos`` scaled about its centroid gives
    at least n candidate pairs in the plain dense version.  At d=16 the
    first steps spread girg10k beyond every radius, so its positions are
    crowded for the general kernels' comparisons to run their candidate
    path at the main path's shapes."""
    from wembed_tpu_torch.kernels import fused_dense

    n, d = pos.shape
    kw = dict(dim=d, L=1.0, att_scale=1.0, rep_scale=1.0, additive=additive)
    scale = 1.0
    for _ in range(60):
        count = int(fused_dense.fused_dense_forces_reference(about_centre(pos, scale), invw, colors, adj, **kw)[4])
        if count >= n:
            return scale
        scale *= 0.8
    check(False, "no scale of the positions gives candidate pairs")


def about_centre(pos, scale: float):
    centre = pos.mean(0, keepdim=True)
    return centre + (pos - centre) * scale


def crowd(case: dict) -> dict:
    """``case`` at the positions ``crowd_scale`` picks."""
    scale = crowd_scale(case["pos"], case["invw"], case["colors"], case["adj"], case["additive"])
    return dict(case, pos=about_centre(case["pos"], scale), scale=scale)


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
    span_sweep.span_reduce.launches = 0
    for wrapper in build_wrappers().values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    embedder.calculateEmbedding()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fused_dense=fused_dense.fused_dense_forces.launches,
                    span_sweep=span_sweep.span_sweep.launches, span_reduce=span_sweep.span_reduce.launches,
                    **{name: w.launches for name, w in build_wrappers().items()})
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
    row["layer_tuples"] = [(r.n, r.path, r.iterations, r.launches, r.growth_events) for r in records]
    for r in records:
        check(0 < r.iterations < 1000, f"layer n={r.n}: {r.iterations} iterations")
        check(r.final_overflow == 0, f"layer n={r.n}: final overflow {r.final_overflow}")
    for kernel, path in (("fused_dense", "dense"), ("span_sweep", "span"), ("span_reduce", "span")):
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


def start_graph(path: Path, flags: list[str], md5: str | None):
    """Make a graph with the port's generator in a subprocess, unless the
    cached file is already the right one (any finished file when ``md5``
    is None).  Returns (process or None, t0)."""
    if path.exists() and (md5 is None or hashlib.md5(path.read_bytes()).hexdigest() == md5):
        return None, time.perf_counter()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    proc = subprocess.Popen(
        [sys.executable, "-m", "wembed_tpu_torch.cli.generate", "-o", str(tmp), *flags],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, time.perf_counter()


def finish_graph(path: Path, proc, t0) -> float:
    """Wait for the generator; returns its wall seconds (0.0 when cached)."""
    if proc is None:
        return 0.0
    out, err = proc.communicate(timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"generate {path.name} exit {proc.returncode}: {err[-2000:]}")
    print(f"generate {path.name}: {out.strip()}, {seconds:.3f} s")
    path.with_name(path.name + ".tmp").replace(path)
    return seconds


def span_case(positions, inv_w, weights, colors, idx, opts, k=None):
    """Inputs of the span sweep at the given CUDA tensors and windows (a
    cell index: its capacities), in work items of at most ``k`` tiles
    (default: the port's)."""
    import torch

    from wembed_tpu_torch.kernels import span_sweep

    s = idx.structures(positions, inv_w, weights, colors, opts)
    t = idx.tensors(positions.device)
    items = torch.as_tensor(
        span_sweep.work_items(s.blk_t.cpu().numpy(), k or span_sweep.WORK_ITEM_TILES),
        device=positions.device,
    )
    return dict(
        args=(s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off),
        kw=dict(dim=idx.d, L=opts.edge_length, rep_scale=opts.repulsion_scale,
                additive=opts.additive_weights, items=items),
        n=idx.n, tiles=idx.w, items=int(items.shape[0]), overflow=int(s.overflow), need=s.need,
        max_abs_pos=float(positions.abs().max()),
    )


def synthetic_span_case(n, d, *, additive=False, bipartite=False, coincident=False,
                        starved=False, seed=0, dtype=None, spread=1.0):
    """A random graph with heavy-tailed weights at positions in the random-
    start cube times ``spread``, as ``dtype`` (default f32); windows sized
    to the measured needs, or pinned to one tile at spread positions
    (``starved``)."""
    import numpy as np
    import torch

    from wembed_tpu_torch.core import EmbedderOptions
    from wembed_tpu_torch.core.weights import inv_exp_weights
    from wembed_tpu_torch.graphs import from_edges
    from wembed_tpu_torch.kernels import span_sparse

    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, n ** (1.0 / d), size=(n, d)) * (100.0 if starved else spread)
    if coincident:
        pos[1::7] = pos[0::7][: pos[1::7].shape[0]]
    w = rng.pareto(2.0, n) + 1.0
    g = from_edges(rng.integers(0, n, size=(4 * n, 2)), num_vertices=n)
    colors = np.arange(n) % 2 if bipartite else np.arange(n)
    opts = EmbedderOptions(embedding_dimension=d, additive_weights=additive)
    idx = span_sparse.SpanIndex.build(w, opts, g.edge_src, g.col_idx)
    dev = torch.device("cuda")
    tensors = (
        torch.tensor(pos, dtype=dtype, device=dev),
        torch.tensor(inv_exp_weights(w, d), dtype=dtype, device=dev),
        torch.tensor(w, dtype=dtype, device=dev),
        torch.tensor(colors, dtype=torch.int32, device=dev),
    )
    if starved:
        return span_case(*tensors, idx._with_blk_t(np.minimum(idx.blk_t, 1)), opts)
    return sized_span_case(tensors, idx, opts)


def sized_span_case(tensors, idx, opts):
    """``span_case`` with the windows (or a cell index's capacities) grown
    to the needs of the positions (positions, inverse weights, weights,
    colours)."""
    for _ in range(6):
        s = idx.structures(*tensors, opts)
        grown = idx.grow_from_needs(s.need.cpu().numpy())
        if int(s.overflow) == 0 or grown is None:
            break
        idx = grown
    return span_case(*tensors, idx, opts)


def radius_edge(q, s, thr, steps):
    """Members ``s`` (f32, placed within a few hundred f32 steps of the
    radius) moved along their largest axis of difference from their
    queries ``q`` to the last f32 step at which the exact test's squared
    distance is within ``thr``, then ``steps`` further steps out (beyond
    the radius) or, where negative, in."""
    import numpy as np

    s = s.copy()
    rows = np.arange(s.shape[0])
    axis = np.argmax(np.abs(s - q), axis=1)
    out = np.where(s[rows, axis] >= q[rows, axis], np.inf, -np.inf).astype(np.float32)
    steps = np.broadcast_to(np.asarray(steps), rows.shape)

    def dist2(x):
        diff, acc = q - x, np.zeros(x.shape[0], np.float32)
        for k in range(x.shape[1]):
            acc = acc + diff[:, k] * diff[:, k]
        return acc

    for _ in range(400):  # in until within the radius
        inside = dist2(s) <= thr
        if inside.all():
            break
        s[rows, axis] = np.where(inside, s[rows, axis], np.nextafter(s[rows, axis], -out))
    for _ in range(400):  # out while the next step stays within it
        trial = s.copy()
        trial[rows, axis] = np.nextafter(s[rows, axis], out)
        grow = dist2(trial) <= thr
        if not grow.any():
            break
        s[grow] = trial[grow]
    for i in range(int(np.abs(steps).max(initial=0))):
        move = np.abs(steps) > i
        toward = np.where(steps > 0, out, -out)
        s[rows, axis] = np.where(move, np.nextafter(s[rows, axis], toward), s[rows, axis])
    return s


def adversarial_span_case(d: int, seed: int) -> dict:
    """Sweep inputs built directly: three query blocks of a compact cloud
    about a corner 1e4 from the origin, the last ending in 100 padding slots
    (+1e15, radius factor 0), against six member tiles of one row, each
    block's window: members on the radius edge of a query (the last f32
    step within it, or one step beyond), coincident with one, of the same
    colour as one, far away, and the last tile ending in 90 padding members
    (-1e15, bm2 0; 20 of them at +1e15, on the padding queries)."""
    import numpy as np
    import torch

    from wembed_tpu_torch.kernels import span_sweep

    rng = np.random.default_rng(seed)
    nb, tiles, pad_q, pad_s = 3, 6, 100, 90
    nq, ns = nb * span_sweep.Q, tiles * span_sweep.ST
    corner = 1e4 * rng.choice([-1.0, 1.0], d)
    qpos = (corner + rng.normal(size=(nq, d)) * 8.0).astype(np.float32)
    lw2 = ((rng.pareto(1.5, nq) + 1.0) ** 2).astype(np.float32)
    bm2 = ((rng.pareto(1.5, ns) + 1.0) ** 2).astype(np.float32)
    partner = rng.integers(0, nq - pad_q, ns)
    thr = lw2[partner] * bm2
    direction = rng.normal(size=(ns, d))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    spos = (qpos[partner] + direction * np.sqrt(thr.astype(np.float64))[:, None]).astype(np.float32)
    spos = radius_edge(qpos[partner], spos, thr, (rng.random(ns) < 0.5).astype(int))
    coincident = rng.random(ns) < 0.08
    spos[coincident] = qpos[partner[coincident]]
    far = rng.random(ns) < 0.08
    spos[far] = (corner + rng.normal(size=(int(far.sum()), d)) * 400.0).astype(np.float32)
    qcol = np.arange(nq, dtype=np.int32)
    scol = np.arange(nq, nq + ns, dtype=np.int32)
    same = rng.random(ns) < 0.05
    scol[same] = qcol[partner[same]]
    qpos[nq - pad_q:], lw2[nq - pad_q:], qcol[nq - pad_q:] = 1e15, 0.0, -2
    spos[ns - pad_s:], bm2[ns - pad_s:], scol[ns - pad_s:] = -1e15, 0.0, -3
    spos[ns - pad_s: ns - pad_s + 20] = 1e15
    wq, ws = rng.pareto(2.0, nq) + 1.0, rng.pareto(2.0, ns) + 1.0

    def rec(pos, w, radius):
        return np.concatenate([pos, 1.0 / w[:, None], radius[:, None], w[:, None]], axis=1)

    dev = torch.device("cuda")
    blk_t = np.full((nb, 1), tiles, np.int32)
    items = torch.as_tensor(span_sweep.work_items(blk_t), device=dev)
    args = tuple(torch.tensor(a, device=dev) for a in (
        rec(qpos, wq, lw2).astype(np.float32), qcol, rec(spos, ws, bm2).astype(np.float32), scol,
        blk_t, np.zeros((nb, 1), np.int32), np.zeros(1, np.int32)))
    return dict(args=args, kw=dict(dim=d, L=1.0, rep_scale=1.0, additive=False, items=items),
                n=nq - pad_q, tiles=tiles, items=int(items.shape[0]), overflow=0,
                max_abs_pos=float(np.abs(qpos[: nq - pad_q]).max()))


def prefilter_share(args, kw) -> dict:
    """The fast sweep's prefilter on these inputs: the pairs swept, the pairs
    it passed (the kernel's own count) and the candidates, each also as a
    share of the pairs swept."""
    import torch

    from wembed_tpu_torch.kernels import span_sweep

    dev = args[0].device
    span_sweep.count_prefilter_passes(True, dev)
    out = span_sweep.span_sweep(*args, **kw)
    passes = span_sweep.prefilter_passes(dev)
    span_sweep.count_prefilter_passes(False, dev)
    pairs = int(kw["items"][:, 3].sum()) * span_sweep.Q * span_sweep.ST
    candidates = int(out[2].sum())
    torch.cuda.synchronize()
    return dict(pairs=pairs, prefilter_passes=passes, prefilter_pass_rate=passes / pairs,
                candidates=candidates, candidate_share=candidates / pairs,
                passes_per_candidate=passes / max(candidates, 1))


def compare_span(name: str, case: dict, timed: bool) -> dict:
    """The span sweep kernel against its plain version on the same CUDA
    tensors; some pair must be a candidate."""
    import torch

    from wembed_tpu_torch.kernels import span_sweep

    args, kw = case["args"], case["kw"]
    dtype = args[0].dtype
    general = span_sweep.span_sweep.launches_general
    scratch = torch.empty((kw["items"].shape[0], kw["dim"] + 3, span_sweep.Q), dtype=dtype, device=args[0].device)
    out = span_sweep.span_sweep(*args, **kw, scratch=scratch)
    general = span_sweep.span_sweep.launches_general - general
    f_k, l_k, c_k, z_k = out
    torch.cuda.synchronize()
    same_twice(name, out, lambda: span_sweep.span_sweep(*args, **kw))
    f_p, l_p, c_p, z_p = span_sweep.span_sweep_reference(*args, **kw)
    torch.cuda.synchronize()
    ok_force, err, scale = forces_agree(f_k, f_p)
    loss_k, loss_p = float(l_k.double().sum()), float(l_p.double().sum())
    row = dict(
        case=name, n=case["n"], d=kw["dim"], dtype=str(dtype).split(".")[1],
        kernel="general" if general else "fast", work_tiles=case["tiles"], items=case["items"],
        overflow=case["overflow"],
        rep_count=[int(c_k.sum()), int(c_p.sum())], zero_sum=[int(z_k.sum()), int(z_p.sum())],
        rep_loss=[loss_k, loss_p], max_abs_force=scale, max_abs_err=err,
    )
    if general:  # each slot's member-order fold, bitwise, and the reduction of it
        folded = sweep_fold(*args, **kw)
        row["bitwise_fold"] = bitwise(scratch, folded) and all(
            bitwise(a, b) for a, b in zip(out, span_sweep.span_reduce_reference(
                folded, kw["items"], args[4].shape[0], kw["dim"])))
        del folded
    if timed:
        row["ms"] = cuda_ms(lambda: span_sweep.span_sweep(*args, **kw), 20)
        row["plain_ms"] = cuda_ms(lambda: span_sweep.span_sweep_reference(*args, **kw), 3)
        # every (slot, member) pair of the work tiles (a cell case: of the
        # kept members), plus the candidates' rare path
        d = kw["dim"]
        pairs = case.get("pairs", case["tiles"] * span_sweep.Q * span_sweep.ST)
        flop = pairs * (3 * d + 1) + int(c_p.sum()) * RARE_FLOP
        row["bound_ms"], row["bound_by"] = bound(
            flop, nbytes(*args, kw["items"], *out), f64=dtype == torch.float64
        )
        if general:  # the item kernel's own device time, without the wrapper's host work
            row["kernel_ms"] = traced_call_ms(
                lambda: span_sweep.span_sweep(*args, **kw), "span_sweep_general_kernel", 20)
            row["share"] = row["bound_ms"] / row["kernel_ms"]
    if not general:
        row.update(prefilter_share(args, kw), max_abs_pos=case.get("max_abs_pos"))
        print("prefilter " + json.dumps(dict(case=name, **{k: row[k] for k in (
            "pairs", "prefilter_passes", "prefilter_pass_rate", "candidates", "candidate_share",
            "passes_per_candidate", "max_abs_pos")})))
    print("compare_span " + json.dumps(row))
    if general:
        check(row["bitwise_fold"], f"{name}: the general sweep is not the member-order fold")
    check(bool(torch.equal(c_k, c_p)), f"{name}: candidate counts differ")
    check(bool(torch.equal(z_k, z_p)), f"{name}: zero counts differ")
    check(ok_force, f"{name}: forces differ by up to {err} (max|force| {scale})")
    check(losses_agree(loss_k, loss_p, dtype), f"{name}: loss {loss_k} != {loss_p}")
    check(int(c_p.sum()) > 0, f"{name}: no candidate pairs")
    if not general:
        check(row["prefilter_passes"] >= row["candidates"],
              f"{name}: the prefilter passed {row['prefilter_passes']} pairs for {row['candidates']} candidates")
    return row


# ------------------------------------------------ the general kernels' folds
def ordered_fold(acc, group, terms):
    """``acc`` with ``terms[i]`` added into row ``group[i]`` one entry at a
    time in entry order (``group`` nondecreasing): acc[g] + t, each sum
    rounded on its own, the left fold of each row's entries."""
    import torch

    if group.numel() == 0:
        return acc
    counts = torch.bincount(group, minlength=acc.shape[0])
    rank = torch.arange(group.numel(), device=group.device) - (torch.cumsum(counts, 0) - counts)[group]
    order = torch.argsort(rank, stable=True)  # the entries of rank 0, then of rank 1, ...
    start = 0
    for end in torch.cumsum(torch.bincount(rank), 0).tolist():
        sel = order[start:end]
        g = group[sel]
        acc[g] = acc[g] + terms[sel]
        start = end
    return acc


def ieee_sqrt(x):
    """sqrt correctly rounded in x's type, as the kernels' sqrtf and sqrt:
    torch's on the card, numpy's on the CPU (torch's vectorised CPU sqrt is
    within an ulp, not correctly rounded)."""
    import numpy as np
    import torch

    return torch.from_numpy(np.sqrt(x.numpy())) if x.device.type == "cpu" else torch.sqrt(x)


def dense_fold(pos, invw, colors, adj, *, dim, L, att_scale, rep_scale, additive, rows=None):
    """The general dense kernel's forces and coincident counts transcribed
    in plain torch: each row's active columns folded from +0 in ascending
    column order, acc + coeff * (p_r - p_c), every operation rounded on its
    own as the kernel's (built with --fmad=false): bitwise the kernel's."""
    import torch

    from wembed_tpu_torch.kernels.fused_dense import neighbour_mask

    n = pos.shape[0]
    r0, r1 = rows or (0, n)
    L2 = float(L) * float(L)
    force = torch.zeros((r1 - r0, dim), dtype=pos.dtype, device=pos.device)
    zero = torch.zeros((r1 - r0,), dtype=torch.int32, device=pos.device)
    for s in range(r0, r1, 1024):
        e = min(s + 1024, r1)
        dist2 = torch.zeros((e - s, n), dtype=pos.dtype, device=pos.device)
        for k in range(dim):
            diff = pos[s:e, k, None] - pos[None, :, k]
            dist2 = dist2 + diff * diff
        iw_r, iw_c = invw[s:e, None], invw[None, :]
        ws = iw_r + iw_c if additive else iw_r * iw_c
        nbr = neighbour_mask(adj, slice(s, e), n)
        wdist2 = dist2 * (ws * ws)
        rep = ~nbr & (colors[s:e, None] != colors[None, :]) & (wdist2 <= L2)
        att = nbr & (wdist2 > L2)
        posd = dist2 > 0
        zero[s - r0 : e - r0] = torch.sum(~posd & (nbr | rep), dim=1).to(torch.int32)
        inv = 1.0 / torch.clamp_min(ieee_sqrt(dist2), 1e-30)
        coeff = torch.where(rep, rep_scale * ws * inv, -(att_scale * ws * inv))
        r, c = torch.nonzero((rep & posd) | att, as_tuple=True)  # rows ascending, then columns
        terms = coeff[r, c][:, None] * (pos[s + r] - pos[c])
        force[s - r0 : e - r0] = ordered_fold(force[s - r0 : e - r0], r, terms)
    return force, zero


def sweep_fold(qrec, qcol, srec, scol, blk_t, start_tile, tile_off, *, dim, L, rep_scale, additive,
               items, chunk=16):
    """The general sweep kernel's per-item partials, the scratch (items,
    d + 3, 256) with the counts as values, transcribed in plain torch: each
    slot's candidates of an item folded from +0 in member (walk) order,
    acc + coeff * (q - s) and loss + (L/ws - dist), every operation rounded
    on its own: bitwise the kernel's scratch."""
    import torch

    from wembed_tpu_torch.kernels import span_sweep

    Q, ST, d = span_sweep.Q, span_sweep.ST, dim
    dtype, dev = qrec.dtype, qrec.device
    n_items = items.shape[0]
    _, stile, item = span_sweep._item_tiles(items, blk_t, start_tile, tile_off)
    k_max = int(items[:, 3].max()) if n_items else 0
    first = torch.cumsum(items[:, 3].to(torch.int64), 0) - items[:, 3].to(torch.int64)
    slot_of_tile = torch.arange(item.numel(), device=dev) - first[item]
    members = torch.full((n_items, k_max * ST), -1, dtype=torch.int64, device=dev)
    members.view(n_items, k_max, ST)[item, slot_of_tile] = stile[:, None].to(torch.int64) * ST + torch.arange(ST, device=dev)
    q3, qc3 = qrec.view(-1, Q, d + 3), qcol.view(-1, Q)
    scratch = torch.zeros((n_items, d + 3, Q), dtype=dtype, device=dev)
    L2 = float(L) * float(L)
    for a in range(0, n_items, chunk):
        b = min(a + chunk, n_items)
        blk = items[a:b, 0].to(torch.int64)
        q, qc = q3[blk], qc3[blk]  # (B, Q, C), (B, Q)
        m = members[a:b]
        present = m >= 0
        s, sc = srec[m.clamp_min(0)], scol[m.clamp_min(0)]  # (B, M, C), (B, M)
        dist2 = torch.zeros((b - a, Q, m.shape[1]), dtype=dtype, device=dev)
        for k in range(d):
            diff = q[:, :, k, None] - s[:, None, :, k]
            dist2 = dist2 + diff * diff
        valid = (dist2 <= q[:, :, d + 1, None] * s[:, None, :, d + 1]) & (qc[:, :, None] != sc[:, None, :])
        valid &= present[:, None, :]
        posd = dist2 > 0
        ws = q[:, :, d, None] + s[:, None, :, d] if additive else q[:, :, d, None] * s[:, None, :, d]
        act = valid & posd & (dist2 * (ws * ws) <= L2)
        bb, qq, mm = torch.nonzero(act, as_tuple=True)  # slots in order, then members in walk order
        d2, w = dist2[bb, qq, mm], ws[bb, qq, mm]
        dist = ieee_sqrt(d2)
        coeff = rep_scale * w * (1.0 / dist)
        sm = s[bb, mm]
        qv = q[bb, qq]
        l_over_ws = torch.full_like(w, L) / w if additive else (L * qv[:, d + 2]) * sm[:, d + 2]  # one division
        group = bb * Q + qq
        force = ordered_fold(torch.zeros(((b - a) * Q, d), dtype=dtype, device=dev), group,
                             coeff[:, None] * (qv[:, :d] - sm[:, :d]))
        loss = ordered_fold(torch.zeros(((b - a) * Q,), dtype=dtype, device=dev), group, l_over_ws - dist)
        scratch[a:b, :d] = force.view(b - a, Q, d).transpose(1, 2)
        scratch[a:b, d] = loss.view(b - a, Q)
        scratch[a:b, d + 1] = valid.sum(2).to(dtype)
        scratch[a:b, d + 2] = (valid & ~posd).sum(2).to(dtype)
    return scratch


# ------------------------------------------------------- the sweep's reduction
def reduce_table(per_block):
    """A block-major (items, 4) int32 work-item table on the card with
    ``per_block[b]`` items of block b (the reduction reads the block
    column only)."""
    import numpy as np
    import torch

    per_block = np.asarray(per_block, np.int64)
    items = np.zeros((int(per_block.sum()), 4), np.int32)
    items[:, 0] = np.repeat(np.arange(per_block.shape[0]), per_block)
    return torch.as_tensor(items, device="cuda")


def synthetic_scratch(per_block, d: int, seed: int, dtype=None):
    """(scratch, items): per-item partials (items, d + 3, Q) of ``dtype``
    (default f32) as a sweep writes them, for ``per_block[b]`` items of
    block b.  The float channels mix magnitudes from 1e-3 to 1e3 with -0.0
    (also as the first item of half of each block's slots), +-inf, NaN (a
    few with payloads) and subnormals; the counts run up to 4 x 256 x 256
    (int32 bits in the fast layout, values in the general one)."""
    import numpy as np
    import torch

    from wembed_tpu_torch.kernels import span_sweep

    dtype = dtype or torch.float32
    real = np.float64 if dtype == torch.float64 else np.float32
    bits, nan = (np.uint64, 0x7FF4000000000001) if dtype == torch.float64 else (np.uint32, 0x7FA00001)
    rng = np.random.default_rng(seed)
    per_block = np.asarray(per_block, np.int64)
    n, q = int(per_block.sum()), span_sweep.Q
    shape = (n, d + 1, q)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)).astype(real)
    pick = rng.random(shape)
    x[pick < 0.02] = -0.0
    x[(pick >= 0.02) & (pick < 0.022)] = np.inf
    x[(pick >= 0.022) & (pick < 0.024)] = -np.inf
    x[(pick >= 0.024) & (pick < 0.026)] = np.nan
    payload = (pick >= 0.026) & (pick < 0.027)
    x.view(bits)[payload] = nan  # a signalling NaN with a payload
    sub = (pick >= 0.03) & (pick < 0.06)
    x[sub] = (rng.normal(size=int(sub.sum())) * np.finfo(real).tiny / 4).astype(real)
    first = (np.cumsum(per_block) - per_block)[per_block > 0]
    x[first, :, : q // 2] = -0.0
    counts = rng.integers(0, 4 * 256 * 256 + 1, size=(n, 2, q))
    general = span_sweep._general(dtype, d)
    counts = counts.astype(real) if general else counts.astype(np.int32).view(np.float32)
    return torch.as_tensor(np.concatenate([x, counts], axis=1), device="cuda"), reduce_table(per_block)


def reduce_blocks(seed: int, blocks: int = 48):
    """Items a block: 1-23, with empty first, middle and last blocks,
    one-item blocks and a block of 300 items (more than a CTA's threads)."""
    import numpy as np

    per = np.random.default_rng(seed).integers(1, 24, size=blocks)
    per[[0, 5, 6, blocks - 1]] = 0
    per[[7, 8, 20]] = 1
    per[30] = 300
    return per


def inside_slice(items) -> tuple[int, int]:
    """(lo, hi) of a contiguous slice of a block-major table that starts and
    ends inside blocks, about its middle third (one rank's share)."""
    block = items[:, 0].cpu().numpy()
    n = block.shape[0]
    lo = next(i for i in range(n // 3, n) if 0 < i and block[i - 1] == block[i])
    hi = next(i for i in range(max(2 * n // 3, lo + 1), n) if block[i - 1] == block[i])
    return lo, hi


def kernel_ms_of(prof, reps: int) -> dict:
    """{kernel name: device ms a call} of a ``torch.profiler`` trace of
    ``reps`` calls."""
    import re

    import torch

    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+)(?=[<(])", e.name)  # the name before its template or argument list
            key = m.group(1) if m else e.name[:60]
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1000.0 / reps
    return out


def traced_kernel_ms(fn, reps: int) -> dict:
    """{kernel name: device ms a call} of the kernels that ``reps`` eager
    calls of ``fn`` launch, from a ``torch.profiler`` trace (after one
    untraced call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_ms_of(prof, reps)


def traced_call_ms(fn, kernel: str, reps: int) -> float:
    """The median device ms of one ``kernel`` call over ``reps`` eager calls
    of ``fn`` in a ``torch.profiler`` trace (after one untraced call): a
    median of the calls the trace holds, so that calls it drops at its
    window's edges do not count as zero."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    calls = [e.time_range.elapsed_us() / 1000.0 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and f"{kernel}<" in e.name]
    check(len(calls) > 0, f"the trace shows no {kernel}")
    return float(np.median(calls))


def compare_reduce(name: str, scratch, items, nb: int, dim: int, timed: bool = False) -> dict:
    """The sweep's reduction kernel alone (``span_sweep.span_reduce``) on
    ``scratch`` against its plain version, bitwise on every output (two
    launches bitwise equal too).  Timed: the kernel's device ms a call from
    a trace of calls on this scratch, the plain version's ms, the bytes
    bound and ``torch.segment_reduce``'s device ms on the same scratch
    (the library call of the kernels line; it sums the count channels' int
    bits as floats, so only its time is kept)."""
    import torch

    from wembed_tpu_torch.kernels import span_sweep

    fields = ("force", "loss", "count", "zero")
    before = span_sweep.span_reduce.launches
    out = span_sweep.span_reduce(scratch, items, nb, dim)
    second = span_sweep.span_reduce(scratch, items, nb, dim)
    launched = span_sweep.span_reduce.launches - before
    plain = span_sweep.span_reduce_reference(scratch, items, nb, dim)
    torch.cuda.synchronize()
    per_block = torch.bincount(items[:, 0].long(), minlength=nb)[:nb]
    same = {f: bitwise(a, b) for f, a, b in zip(fields, out, plain)}
    row = dict(
        case=name, d=dim, dtype=str(scratch.dtype).split(".")[1],
        kernel="general" if span_sweep._general(scratch.dtype, dim) else "fast",
        items=int(items.shape[0]), blocks=nb, empty_blocks=int((per_block == 0).sum()),
        longest_block=int(per_block.max()) if nb else 0, bitwise=same,
        twice_bitwise=all(bitwise(a, b) for a, b in zip(out, second)),
        nan=int(torch.isnan(out[0]).sum() + torch.isnan(out[1]).sum()),
        negative_zero=int(((out[0] == 0) & torch.signbit(out[0])).sum()),
        max_abs_err=0.0 if all(same.values()) else max_abs_diff(
            [torch.nan_to_num(t) for t in out], [torch.nan_to_num(t) for t in plain]),
    )
    for f, a, b in zip(fields, out, plain):
        if not same[f]:  # the first differing words, as hex bits
            bits = torch.int64 if a.element_size() == 8 else torch.int32
            ka, kb = a.reshape(-1).view(bits), b.reshape(-1).view(bits)
            where = torch.nonzero(ka != kb).squeeze(1)[:4].tolist()
            row.setdefault("differ", {})[f] = [(i, f"{int(ka[i]) & (2**64 - 1):x}", f"{int(kb[i]) & (2**64 - 1):x}")
                                              for i in where]
    if timed:
        lengths = per_block.to(torch.int64)
        flat = scratch.view(scratch.shape[0], -1)
        row["kernel_ms"] = sum(traced_kernel_ms(lambda: span_sweep.span_reduce(scratch, items, nb, dim), 50).values())
        row["library_ms"] = sum(traced_kernel_ms(
            lambda: torch.segment_reduce(flat, "sum", lengths=lengths, unsafe=True), 50).values())
        row["plain_ms"] = cuda_ms(lambda: span_sweep.span_reduce_reference(scratch, items, nb, dim), 3)
        row["bytes"] = nbytes(scratch, *out)  # the scratch read once, the outputs written once
        row["bound_ms"], row["bound_by"] = bound(0, row["bytes"], f64=scratch.dtype == torch.float64)
    print("compare_reduce " + json.dumps(row))
    check(launched == 2, f"{name}: {launched} launches of the reduction kernel for two calls")
    check(row["twice_bitwise"], f"{name}: two launches differ")
    check(all(same.values()), f"{name}: the reduction differs from its plain version: {same}")
    return row


def reduce_cases_synthetic() -> list[dict]:
    """The reduction on synthetic scratches: fast kernel at d = 1 ... 8, the
    general one at d = 16 (f32) and d = 2 (f64), each whole and over a slice
    that starts and ends inside blocks; and a table of over 256 x 257 items
    at d = 1 (three search rounds)."""
    import torch

    rows = []
    for d, dtype in [*((d, None) for d in range(1, 9)), (16, None), (2, torch.float64)]:
        per = reduce_blocks(100 + d)
        scratch, items = synthetic_scratch(per, d, seed=200 + d, dtype=dtype)
        label = f"d{d}_{'f64' if dtype else 'f32'}"
        rows.append(compare_reduce(f"synthetic_{label}", scratch, items, len(per), d))
        lo, hi = inside_slice(items)
        rows.append(compare_reduce(f"synthetic_{label}_slice", scratch[lo:hi], items[lo:hi], len(per), d))
        del scratch, items
    import numpy as np

    per = np.random.default_rng(7).integers(0, 468, size=300)
    scratch, items = synthetic_scratch(per, 1, seed=8)
    check(items.shape[0] > 256 * 257, f"the long table has {items.shape[0]} items")
    rows.append(compare_reduce(f"synthetic_d1_{items.shape[0]}_items", scratch, items, len(per), 1))
    del scratch, items
    for row in rows:
        check(row["kernel"] == ("general" if row["d"] > 8 or row["dtype"] == "float64" else "fast"),
              f"{row['case']}: the {row['kernel']} kernel ran")
    # a fold from +0.0 gives +0.0 for a one-item block of -0.0 (and never -0.0)
    check(any(r["nan"] for r in rows) and not any(r["negative_zero"] for r in rows),
          "no synthetic case produced NaN outputs, or one produced -0.0")
    return rows


def reduce_converged(name: str, case: dict, launches: int) -> dict:
    """The reduction at a converged run's windows (``span_case``): a sweep
    into a kept scratch (``span_sweep(scratch=)``), whose outputs must be
    the reduction of that scratch, bitwise; ``compare_reduce`` on it,
    timed, and on a slice of it that starts and ends inside blocks; the
    reduction's device ms a call in a trace of sweep-then-reduce pairs (the
    scratch as the loop leaves it, partly in L2), its bytes bound and share,
    beside the library call's and the run's launches."""
    import torch

    from wembed_tpu_torch.kernels import span_sweep

    args, kw = case["args"], case["kw"]
    items, d, nb = kw["items"], kw["dim"], args[4].shape[0]
    scratch = torch.empty((items.shape[0], d + 3, span_sweep.Q), dtype=args[0].dtype, device=args[0].device)
    swept = span_sweep.span_sweep(*args, **kw, scratch=scratch)
    row = compare_reduce(name, scratch, items, nb, d, timed=True)
    check(all(bitwise(a, b) for a, b in zip(swept, span_sweep.span_reduce(scratch, items, nb, d))),
          f"{name}: the sweep's outputs are not the reduction of its scratch")
    lo, hi = inside_slice(items)
    compare_reduce(f"{name}_slice", scratch[lo:hi], items[lo:hi], nb, d)
    del scratch
    trace = traced_kernel_ms(lambda: span_sweep.span_sweep(*args, **kw), 50)
    out = dict(case=name, items=row["items"], blocks=nb, longest_block=row["longest_block"],
               bytes=row["bytes"], bound_ms=row["bound_ms"], bound_by=row["bound_by"], ms=trace["span_reduce_kernel"],
               sweep_ms=trace["span_sweep_kernel"], share=row["bound_ms"] / trace["span_reduce_kernel"],
               kernel_ms=row["kernel_ms"], library_ms=row["library_ms"], plain_ms=row["plain_ms"],
               max_abs_err=row["max_abs_err"], launches=launches, card=card_line())
    print("reduce_converged " + json.dumps(out))
    return out


def edge_case(impl, index=None, in_index=None, share=None, dtype=None, positions=None, draws=None) -> dict:
    """The edge pass's inputs at a span embedder's current positions (or
    ``positions``), in ``dtype`` (default: the embedder's), over its index
    (or ``index``, with the member sample ``in_index``): ``edge_inputs``."""
    pos = impl.state.positions if positions is None else positions
    dtype = dtype or pos.dtype
    return edge_inputs(pos.to(dtype), impl._inv_w.to(dtype), impl._weights.to(dtype), impl._dg.colors,
                       impl._index if index is None else index, impl.opts, in_index, share, draws)


def edge_inputs(pos, inv_w, weights, colors, index, opts, in_index=None, share=None, draws=None) -> dict:
    """The edge pass's inputs: the structures of ``index`` at ``pos`` (with
    the member sample ``in_index``), the sweep's per-vertex force and zero
    counts, the raw kick draw from a fixed seed (``draws``, when given,
    overwrites rows of it: {edge: row}), and the edges of ``share``
    (default: all of them) with their schedule."""
    import torch

    from wembed_tpu_torch.core.forces import edge_share, normal_rows
    from wembed_tpu_torch.kernels import span_sparse

    s = index.structures(pos, inv_w, weights, colors, opts, None, in_index)
    force_k, _, _, zero_k = span_sparse._sweep(s, index, opts)
    t = index.tensors(pos.device)
    lo, hi, row_ptr = edge_share(t.edge_row_ptr, t.edge_src.shape[0], share)
    gen = torch.Generator(device=pos.device).manual_seed(7)
    kicks = normal_rows(gen, t.edge_src.shape[0], pos.shape[1], pos.dtype)
    for j, row in (draws or {}).items():
        kicks[j] = row
    return dict(
        args=(pos, inv_w, t.edge_src[lo:hi], t.edge_dst[lo:hi], row_ptr, opts),
        kw=dict(kicks=kicks[lo:hi], schedule=t.edge_schedules.get(lo, hi), structures=s, colors=colors,
                bm2=t.edge_bm2[lo:hi], in_index=in_index, force=force_k, zero_count=zero_k),
    )


def wide_edge_case(d: int, dtype, n: int = 4000, hub: int = 300, seed: int = 90, coincident: int = 0,
                   share=None) -> dict:
    """The edge pass's inputs around a long segment: a random graph whose
    vertex 0 has ``hub`` more edges (folded by a whole CTA; in slabs of 256
    columns for rows wider than a CTA) at distances around the edge
    length, every ``coincident``-th of them (when given) with its endpoint
    on the hub, heavy-tailed weights, windows sized to the needs, in
    ``dtype``, over the edges of ``share`` (default: all; vertex 0's edges
    come first, so the first share of a few holds the hub)."""
    import numpy as np
    import torch

    from wembed_tpu_torch.core import EmbedderOptions
    from wembed_tpu_torch.core.weights import inv_exp_weights
    from wembed_tpu_torch.graphs import from_edges
    from wembed_tpu_torch.kernels import span_sparse

    rng = np.random.default_rng(seed)
    spokes = np.stack([np.zeros(hub, np.int64), rng.choice(np.arange(1, n), hub, replace=False)], 1)
    g = from_edges(np.r_[rng.integers(0, n, size=(4 * n, 2)), spokes], num_vertices=n)
    w = rng.pareto(2.0, n) + 1.0
    opts = EmbedderOptions(embedding_dimension=d)
    idx = span_sparse.SpanIndex.build(w, opts, g.edge_src, g.col_idx)
    dev = torch.device("cuda")
    pos = rng.uniform(0.0, np.sqrt(6.0 / d), size=(n, d))
    if coincident:
        pos[spokes[::coincident, 1]] = pos[0]
    tensors = (
        torch.tensor(pos, dtype=dtype, device=dev),
        torch.tensor(inv_exp_weights(w, d), dtype=dtype, device=dev),
        torch.tensor(w, dtype=dtype, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev),
    )
    for _ in range(6):
        s = idx.structures(*tensors, opts)
        grown = idx.grow_from_needs(s.need.cpu().numpy())
        if int(s.overflow) == 0 or grown is None:
            break
        idx = grown
    case = edge_inputs(*tensors, idx, opts, share=share)
    row_ptr = case["args"][4]
    check(int((row_ptr[1:] - row_ptr[:-1]).max()) >= hub, f"wide_d{d}: no segment of {hub} edges")
    return case


def extreme_draws(pos, picks, dtype) -> dict:
    """Raw kick rows for the edges ``picks`` (coincident ones): a zero row,
    rows whose squares underflow to 0 and to subnormals, and rows whose
    squares overflow, in ``dtype`` (``unit_rows``' edge cases; the kernel
    must give its bits)."""
    import torch

    d = pos.shape[1]
    big, tiny, sub = (1e30, 1e-30, 1e-20) if dtype == torch.float32 else (1e200, 1e-200, 1e-160)
    ramp = torch.arange(1, d + 1, dtype=dtype, device=pos.device)
    rows = [torch.zeros(d, dtype=dtype, device=pos.device), tiny * ramp, sub * ramp, big * ramp, -big * ramp]
    return {int(j): row for j, row in zip(picks.tolist(), rows)}


def edge_pass_bound(mode: str, args, kw, out) -> tuple[float, str]:
    """The edge pass's least time on the card: each input it needs read
    once and each output written once, against ~(4d + 16) operations an
    edge.  The inputs: the positions and inverse weights, the CSR offsets,
    the destinations at 4 bytes an edge (the schedule's int32 copy; no
    source index: the offsets say it; not the schedule's table either, which
    the kernel derives from the offsets), in the span modes the radius factors,
    colours, lw, the structures' three per-vertex columns (8 bytes a
    vertex each) and window tables, the sweep's force and zero counts and
    the member sample; kick rows only at the coincident edges (dist2 = 0),
    the only ones the pass reads.  (The two-kernel design's bound counted
    src and dst at 16 bytes an edge and every kick row.)"""
    import torch

    from wembed_tpu_torch.core.edge_geometry import edge_geometry

    pos, inv_w, src, dst, row_ptr, _ = args
    n, d = pos.shape
    schedule = kw["schedule"]
    moved = nbytes(pos, inv_w, row_ptr, schedule.dst, *(t for t in out if t is not None))
    if mode != "correction":
        _, dist2 = edge_geometry(pos, src, dst)
        moved += int((dist2 == 0).sum()) * d * pos.element_size()
    if mode != "attraction":
        s = kw["structures"]
        tables = (s.start, s.stop, s.prefix) if hasattr(s, "prefix") else (s.start_tile,)
        moved += nbytes(kw["colors"], kw["bm2"], kw["force"], kw["zero_count"], s.lwpow, s.blk_t, *tables)
        moved += 3 * n * 8 + (0 if kw["in_index"] is None else nbytes(kw["in_index"]))
    return bound(src.shape[0] * (4 * d + 16), moved, f64=pos.dtype == torch.float64)


def compare_edge_pass(name: str, case: dict, modes=EDGE_MODES, timed: bool = False) -> dict:
    """The edge pass kernel against its plain version on the same CUDA
    tensors, in each of ``modes``: forces, zero counts and counted
    neighbours bitwise equal (every operation repeats the plain version's,
    kicks normalised as ``unit_rows`` normalises them, and each vertex's
    edges are folded in edge order from 0, as ``torch.segment_reduce``
    folds them), the losses within LOSS_RTOL (F64_RTOL in f64; the kernel
    adds them in another order), one launch of the variant d asks for
    (d <= 8: the segment-major kernel), two launches bitwise equal; in the
    span modes some neighbour pair counted by the sweep.  ``timed``: ms a
    call of the kernel replayed from a CUDA graph (``graph_ms``), of the
    plain version by CUDA events around eager calls, and the bound."""
    import torch

    from wembed_tpu_torch.kernels import edge_pass as ep

    args = case["args"]
    pos = args[0]
    fast = pos.shape[1] <= ep.MAX_FAST_DIM
    rows = {}
    for mode in modes:
        kw = case["kw"] if mode != "attraction" else dict(kicks=case["kw"]["kicks"], schedule=case["kw"]["schedule"])
        label = f"{name}_{mode}"
        before, general = ep.edge_pass.launches, ep.edge_pass.launches_general
        out = ep.edge_pass(mode, *args, **kw)
        torch.cuda.synchronize()
        check(ep.edge_pass.launches == before + 1, f"{label}: the kernel did not launch")
        check(ep.edge_pass.launches_general == general + (not fast),
              f"{label}: the {'general' if fast else 'segment-major'} kernel ran at d = {pos.shape[1]}")
        same_twice(label, [t for t in out if t is not None],
                   lambda: [t for t in ep.edge_pass(mode, *args, **kw) if t is not None])
        ref = ep.edge_pass_reference(mode, *args, **kw)
        torch.cuda.synchronize()
        row = dict(case=name, mode=mode, n=pos.shape[0], d=pos.shape[1], dtype=str(pos.dtype).split(".")[1],
                   kernel="segment_pass" if fast else "general", edges=int(args[2].shape[0]),
                   longest_segment=int((args[4][1:] - args[4][:-1]).max()),
                   bitwise_force=bool(torch.equal(out.force, ref.force)),
                   max_abs_err=float((out.force - ref.force).abs().max()),
                   max_abs_force=float(ref.force.abs().max()))
        losses = [(key, getattr(out, key), getattr(ref, key)) for key in ("att_loss", "corr_loss")
                  if getattr(ref, key) is not None]
        row.update({key: [float(k), float(p)] for key, k, p in losses})
        if mode != "attraction":
            row.update(corr_count=[int(out.corr_count), int(ref.corr_count)],
                       coincident_neighbours=int((kw["zero_count"] - ref.zero_count).sum()),
                       bitwise_zero=bool(torch.equal(out.zero_count, ref.zero_count)))
        if timed:  # the kernel replayed from a graph (its time, not the wrapper's); the plain version eagerly
            row["ms"] = graph_ms(lambda: ep.edge_pass(mode, *args, **kw), 50)
            ep.edge_pass.launches -= 1  # of graph_ms's two calls, the capture's launched nothing
            row["plain_ms"] = cuda_ms(lambda: ep.edge_pass_reference(mode, *args, **kw), 5)
            row["bound_ms"], row["bound_by"] = edge_pass_bound(mode, args, kw, out)
            row["share"] = row["bound_ms"] / row["ms"]
        print("compare_edge_pass " + json.dumps(row))
        check(row["bitwise_force"], f"{label}: forces differ by up to {row['max_abs_err']}")
        for key, k, p in losses:
            check(losses_agree(float(k), float(p), pos.dtype), f"{label}: {key} {float(k)} != {float(p)}")
        if mode != "attraction":
            check(row["bitwise_zero"], f"{label}: zero counts differ")
            check(row["corr_count"][0] == row["corr_count"][1] > 0, f"{label}: counted neighbours {row['corr_count']}")
        rows[mode] = row
    return rows


def edge_pass_converged(name: str, impl, launches: int) -> dict:
    """The fused pass at a converged run's positions: ms a call, bound and
    share (``compare_edge_pass``, timed), beside the run's launches."""
    row = compare_edge_pass(name, edge_case(impl), modes=("fused",), timed=True)["fused"]
    line = {k: row[k] for k in ("case", "d", "edges", "longest_segment", "kernel", "ms", "plain_ms", "bound_ms",
                                "bound_by", "share", "max_abs_err")}
    line["launches"] = launches
    print("edge_pass_converged " + json.dumps(line))
    return line


def edge_pass_cases_d2(impl) -> dict:
    """Phase 9c at girg100k d=2 after 20 steps: the edge pass in every
    mode (timed), in f64 (timed), with a partial index (``index_size=0.5``, one
    member draw), over one rank's share of three (its range of the edges,
    the segments clipped to it), with every 97th edge's endpoints made to
    coincide (kicks, among them ``extreme_draws``, and coincident
    neighbours); then ``wide_edge_case`` with a hub of 10,500 edges (every
    97th spoke coincident) at d = 1, 2, 4, 8 (f32), 4 (f64), 9 and 16 (f32,
    f64; the general variant), d = 4 and 16 timed in both types, d = 16
    over the first share of three (the hub, the last segment clipped), and
    at d=300 (f32, f64), d=520 and d=2100 (f64).  Returns the girg100k
    rows and the timed d = 16 hub rows."""
    import torch

    from wembed_tpu_torch.core import EmbedderOptions
    from wembed_tpu_torch.core.step import Share
    from wembed_tpu_torch.kernels.span_sparse import SpanIndex

    rows = compare_edge_pass("girg100k_d2_step20", edge_case(impl), timed=True)
    compare_edge_pass("girg100k_d2_step20_f64", edge_case(impl, dtype=torch.float64), timed=True)
    half = SpanIndex.build(impl.get_weights(), EmbedderOptions(embedding_dimension=2, index_size=0.5),
                           *impl._span_edges())
    members = half.draw_members(torch.Generator(device=impl.state.positions.device).manual_seed(3))
    compare_edge_pass("girg100k_d2_step20_partial_index", edge_case(impl, index=half, in_index=members),
                      modes=("fused", "correction"))
    compare_edge_pass("girg100k_d2_step20_share_1_of_3", edge_case(impl, share=Share(1, 3, None)))
    pos = impl.state.positions.clone()
    t = impl._index.tensors(pos.device)
    pick = torch.arange(0, t.edge_src.shape[0], 97, device=pos.device)
    pos[t.edge_dst[pick]] = pos[t.edge_src[pick]]
    met = pick[(pos[t.edge_dst[pick]] == pos[t.edge_src[pick]]).all(dim=1)]
    for dtype in (torch.float32, torch.float64):
        p = pos.to(dtype)
        coincident = compare_edge_pass(
            f"girg100k_d2_step20_coincident_{str(dtype).split('.')[1]}",
            edge_case(impl, positions=p, draws=extreme_draws(p, met[:5], dtype)))
        check(all(coincident[m]["coincident_neighbours"] > 0 for m in ("fused", "correction")),
              "the coincident edge case counted no coincident neighbour")
    hub16 = {}
    for d, dtype in ((1, torch.float32), (2, torch.float32), (4, torch.float32), (8, torch.float32),
                     (4, torch.float64), (9, torch.float32), (16, torch.float32), (16, torch.float64)):
        name = f"n12000_hub10500_d{d}_{str(dtype).split('.')[1]}"
        got = compare_edge_pass(name, wide_edge_case(d, dtype, n=12000, hub=10500, coincident=97), timed=d in (4, 16))
        if d == 16:
            hub16[name] = got
    compare_edge_pass("n12000_hub10500_d16_float32_share_0_of_3",
                      wide_edge_case(16, torch.float32, n=12000, hub=10500, coincident=97, share=Share(0, 3, None)))
    for d, dtype, n in ((300, torch.float32, 4000), (300, torch.float64, 4000), (520, torch.float32, 4000),
                        (2100, torch.float64, 1500)):
        compare_edge_pass(f"n{n}_hub_d{d}_{str(dtype).split('.')[1]}", wide_edge_case(d, dtype, n=n))
    return rows, hub16


def plain_edge_pass_run(graph, single: dict, kernel_map: float) -> dict:
    """Phase 10c: girg100k d=2 seed 1 to convergence through the API with
    the edge pass's plain version in place of the kernel (the span step
    calls ``edge_pass.edge_pass`` through its module), beside phase 10's
    kernel run ``single``: iterations, MAP and coordinates, which must be
    equal (the trajectory), and the losses each run tallies (the kernel
    and the plain version sum them in different orders, so these may
    differ in their last bits on equal coordinates).  The plain run must
    launch no edge pass kernel."""
    import numpy as np
    import torch

    from wembed_tpu_torch import api
    from wembed_tpu_torch.kernels import edge_pass as ep

    api.setSeed(1)
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
    kernel = ep.edge_pass
    launches = kernel.launches
    ep.edge_pass = ep.edge_pass_reference
    try:
        t0 = time.perf_counter()
        embedder.calculateEmbedding()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ep.edge_pass = kernel
    impl = embedder.impl
    loss = embedder.getLoss()
    coords = impl.get_coordinates()
    row = dict(
        iterations=[single["iterations"], impl.iteration],
        tallied_att_loss=[single["losses"][0], loss.attractive],
        tallied_rep_loss=[single["losses"][1], loss.repulsive],
        MAP=[kernel_map, map_only(graph.csr, coords, impl.get_weights())],
        coords_bitwise=bool(np.array_equal(single["coords"], coords)), wall_s=[single["wall_s"], wall],
    )
    row["trajectory_equal"] = (row["coords_bitwise"] and row["iterations"][0] == row["iterations"][1]
                               and row["MAP"][0] == row["MAP"][1])
    print("edge_pass_trajectory " + json.dumps(row))
    check(kernel.launches == launches, "the plain edge pass run launched the kernel")
    check(row["trajectory_equal"], f"the plain edge pass run left the kernel run's trajectory: {row}")
    check_finite(impl.state, "on the span path with the plain edge pass")
    return row


# ------------------------------------------------------ the structures build


def plain_build():
    """A context in which the structures build runs its kernels' plain
    versions (the build as torch operations): the callers reach the four
    wrappers through ``kernels.span_build``."""
    import contextlib

    from wembed_tpu_torch.kernels import span_build as sb

    @contextlib.contextmanager
    def swapped():
        saved = (sb.principal_frame, sb.principal_axes, sb.span_records, sb.span_windows)
        sb.principal_frame, sb.principal_axes, sb.span_records, sb.span_windows = (
            sb.principal_frame_reference, sb.principal_axes_reference, sb.span_records_reference,
            sb.span_windows_reference)
        try:
            yield
        finally:
            sb.principal_frame, sb.principal_axes, sb.span_records, sb.span_windows = saved

    return swapped()


def bitwise(a, b) -> bool:
    """Same dtype, shape and bits (a float's sign of zero and NaN payload
    included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = torch.int64 if a.element_size() == 8 else torch.int32
        return bool(torch.equal(a.contiguous().view(view), b.contiguous().view(view)))
    return bool(torch.equal(a, b))


def max_abs_diff(a_list, b_list) -> float:
    """The largest |a - b| over paired tensors (integers too), in f64."""
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0 for a, b in zip(a_list, b_list))


def build_case(positions, inv_w, weights, colors, idx, opts, in_index=None) -> dict:
    return dict(pos=positions, inv_w=inv_w, weights=weights, colors=colors, idx=idx, opts=opts,
                in_index=in_index)


def synthetic_build_case(n: int, d: int, seed: int, dtype=None, cloud: str = "uniform") -> dict:
    """A random graph with heavy-tailed weights (as ``synthetic_span_case``)
    and its index, at positions in the random-start cube, all equal
    (``cloud="equal"``: a zero covariance) or on a line (``"line"``)."""
    import numpy as np
    import torch

    from wembed_tpu_torch.core import EmbedderOptions
    from wembed_tpu_torch.core.weights import inv_exp_weights
    from wembed_tpu_torch.graphs import from_edges
    from wembed_tpu_torch.kernels import span_sparse

    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, n ** (1.0 / d), size=(n, d))
    if cloud == "equal":
        pos[:] = 1.5  # exact sums: the centred cloud is exactly 0
    elif cloud == "line":
        pos = rng.normal(size=(n, 1)) * np.linspace(1.0, 2.0, d)[None, :] * 4.0
    w = rng.pareto(2.0, n) + 1.0
    g = from_edges(rng.integers(0, n, size=(4 * n, 2)), num_vertices=n)
    opts = EmbedderOptions(embedding_dimension=d)
    idx = span_sparse.SpanIndex.build(w, opts, g.edge_src, g.col_idx)
    dev = torch.device("cuda")
    return build_case(
        torch.tensor(pos, dtype=dtype, device=dev), torch.tensor(inv_exp_weights(w, d), dtype=dtype, device=dev),
        torch.tensor(w, dtype=dtype, device=dev), torch.tensor(np.arange(n), dtype=torch.int32, device=dev),
        idx, opts)


def build_bounds(case: dict, nb: int, rr: int, max_row: int) -> dict:
    """(least ms, "bytes" or "operations") of each build kernel at this
    case: the inputs it reads, each once, and its outputs written once,
    over HBM, its operations over the FP32 (FP64) rate.  The frame (K =
    2): the positions in, the two projections out, the tree sums' adds and
    products, the axes' 12 power steps an axis (each of its three kernels
    apart too: the mean and the covariance read the positions, the
    projections read them and write the projections); the axes on a
    covariance: the covariance and the axes; the records: the permutation,
    the positions, what the function needs of each vertex (its inverse
    weight and L w^(1/d), its int32 colour and f32 bm2: the packed row's
    derived values are the kernel's choice, not the function's), the
    projections, the int32 slot maps (and the member sample) in, the
    records, colours, inverse maps and sorted values out; the windows: the
    slot map, the sorted values, the block and row tables and the widths in
    (of the first sort and the first-axis values only a row's two ends),
    the start tiles and needs out, two binary searches of log2(longest row)
    steps a window."""
    import math

    from wembed_tpu_torch.kernels import span_build as sb

    pos = case["pos"]
    n, d = pos.shape
    T = pos.element_size()
    f64 = T == 8
    idx = case["idx"]
    nq, npa = idx.nq, idx.npa
    upper = d * (d + 1) // 2
    axes_flop = 2 * (sb.ITERS * (2 * d * d + 2 * d) + 2 * d * d + 6 * d)
    frame = dict(
        frame_mean_kernel=bound(n * d, n * d * T + d * T, f64),
        frame_axes_kernel=bound(n * (d + 2 * upper) + axes_flop, n * d * T + 3 * d * T, f64),
        frame_project_kernel=bound(n * (d + 2 * 2 * d), n * d * T + 2 * n * T, f64),
    )
    records_in = n * 8 + n * d * T + 2 * n * T + 2 * 4 * n + 2 * n * T + (nq + npa) * 4 + 3 * n * 4 + (
        n if case.get("in_index") is not None else 0)
    records_out = (nq + npa) * ((d + 3) * T + 4) + n * 32 + 3 * n * T
    windows_in = nq * 4 + 3 * n * T + 2 * nb * 8 + rr * 28 + nb * rr * 4 + 2 * rr * (8 + T)
    windows_out = nb * rr * 12 + 8
    searches = 2 * math.ceil(math.log2(max_row + 1))
    return dict(
        principal_frame=bound(n * (2 * d + 2 * upper + 4 * d) + axes_flop, n * d * T + 2 * n * T, f64),
        principal_axes=bound(axes_flop, (d * d + 2 * d) * T, f64),
        span_records=bound(2 * (nq + npa), records_in + records_out, f64),
        span_windows=bound(nb * rr * (searches + 12), windows_in + windows_out, f64),
        frame_kernels=frame,
    )


def replay_ms(fn, reps: int) -> float:
    """``graph_ms``, with the capture's wrapper calls (which launched
    nothing) taken back off the build's counters."""
    wrappers = build_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    ms = graph_ms(fn, reps)
    for k, w in wrappers.items():
        w.launches -= (w.launches - before[k]) // 2
    return ms


def replay_kernel_ms(fn, reps: int) -> dict:
    """{kernel name: device ms a call} of the kernels one call of ``fn``
    launches, from a ``torch.profiler`` trace of ``reps`` replays of a CUDA
    graph of it (capture bookkeeping as ``replay_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wrappers = build_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    graph = captured(fn)
    for k, w in wrappers.items():
        w.launches -= (w.launches - before[k]) // 2
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    return kernel_ms_of(prof, reps)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def compare_windows(name: str, wargs) -> dict:
    """``span_windows`` against its plain version on ``wargs`` (sorted
    values, y, order1, index tables, widths): start tiles, needs and
    overflow bitwise, one launch a call, two launches bitwise alike."""
    import torch

    from wembed_tpu_torch.kernels import span_build as sb

    before = sb.span_windows.launches
    win = sb.span_windows(*wargs)
    torch.cuda.synchronize()
    check(sb.span_windows.launches == before + 1, f"{name}: span_windows did not launch its kernel")
    same_twice(f"{name}_windows", list(win), lambda: list(sb.span_windows(*wargs)))
    win_p = sb.span_windows_reference(*wargs)
    t = wargs[3]
    row = dict(case=name, dtype=str(wargs[1].dtype).split(".")[1], rows=int(t.row_lo.shape[0]),
               blocks=int(t.blk_first.shape[0]), max_row=int(t.max_row),
               bitwise=[bitwise(a, b) for a, b in zip(win, win_p)], overflow=int(win_p[2]),
               need=int(win_p[1].sum()), nonempty=int((win_p[1] > 0).sum()),
               need_max_row=int((win_p[1] == t.max_row).sum()))
    print("compare_windows " + json.dumps(row))
    check(all(row["bitwise"]), f"{name}: span_windows differs from its plain version (start_tile, need, "
                               f"overflow: {row['bitwise']})")
    return row


def adversarial_windows_inputs(wargs) -> dict:
    """{label: (3, n) f64 sorted values} made from a case's windows
    arguments: the second-axis values rounded to 8 values (ties
    everywhere, +0.0 and -0.0 alternating; each row stays sorted), the
    radius factors scaled to +inf (every row in reach, every window its
    whole row) and to 0, and NaN planted at the tail of the shortest row,
    over the last query block of the longest (its minx and maxx, so NaN
    bounds; each row stays sorted with NaN last, as torch sorts) and in
    one block's first-axis values, with the radius factors scaled by 64
    (many windows in reach and searched)."""
    import torch

    sorted_xyl, _, _, t, _ = wargs
    xyl = sorted_xyl.double()
    x0 = xyl[0]
    lo, hi = float(x0.min()), float(x0.max())
    q = torch.floor((x0 - lo) / max(hi - lo, 1e-30) * 7.999)  # monotone in x
    ties = (q - 3.0) * (hi - lo) / 8.0
    zeros = (ties == 0).nonzero().flatten()
    ties[zeros[::2]] = -0.0
    cases = {"ties8": torch.stack([ties, xyl[1], xyl[2]])}
    c = xyl.clone()
    c[2] = float("inf")
    cases["lw_inf"] = c
    c = xyl.clone()
    c[2] = 0.0
    cases["lw_zero"] = c
    sizes = (t.row_hi - t.row_lo + 1).cpu()
    short, long = int(sizes.argmin()), int(sizes.argmax())
    c = xyl.clone()
    c[0, t.row_hi[short]] = float("nan")
    tail = int(t.blk_first[t.blk_last == t.row_hi[long]][0])  # the first rank of the row's last block
    c[0, tail:int(t.row_hi[long]) + 1] = float("nan")
    c[1, t.src_of_q[0].long()] = float("nan")
    c[2] = c[2] * 64.0
    cases["nan"] = c
    return cases


def windows_adversarial(name: str, wargs) -> dict:
    """``compare_windows`` on ``adversarial_windows_inputs``, each in f32
    and f64."""
    import torch

    _, y, order1, t, blk = wargs
    rows = {}
    for label, xyl in adversarial_windows_inputs(wargs).items():
        for dtype in (torch.float32, torch.float64):
            tag = f"{name}_{label}_{str(dtype).split('.')[1]}"
            rows[tag] = compare_windows(tag, (xyl.to(dtype), y.to(dtype), order1, t, blk))
    check(all(r["need_max_row"] > 0 for k, r in rows.items() if "_lw_inf_" in k),
          f"{name}: no window of the +inf radius case took the whole longest row")
    return rows


def synthetic_windows_case(rows: int, max_row: int, seed: int, dtype, device: str = "cuda", reach: float = 1.0):
    """``span_windows`` arguments of a synthetic index: ``rows`` rows of
    1-40 members and one of ``max_row``, each row's second-axis values
    drawn from 11 (ties, -0.0 beside +0.0, +-inf) and sorted, every 25th
    row ending in NaN; query blocks of up to 256 consecutive ranks of one
    row; random first-axis values, radius factors (scaled by ``reach``)
    and widths of 0-3 tiles."""
    import types

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 41, size=rows)
    sizes[rng.integers(rows)] = max_row
    row_lo = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    n = int(sizes.sum())
    values = np.array([-np.inf, -3.0, -1.5, -0.0, 0.0, 0.5, 0.75, 2.0, 7.0, 1e30, np.inf])
    x = np.concatenate([values[np.sort(rng.integers(0, len(values), size=s))] for s in sizes])
    for r in range(0, rows, 25):
        x[row_lo[r] + sizes[r] - 1 - rng.integers(0, min(3, sizes[r])):row_lo[r] + sizes[r]] = np.nan
    first, last, src = [], [], []
    for r in range(rows):
        for c in range(0, int(sizes[r]), 256):
            ranks = np.arange(row_lo[r] + c, row_lo[r] + min(c + 256, sizes[r]))
            first.append(ranks[0])
            last.append(ranks[-1])
            src.append(np.concatenate([ranks, np.full(256 - len(ranks), n)]))
    nb = len(first)
    dev = torch.device(device)

    def on(a, kind):
        return torch.as_tensor(np.asarray(a), dtype=kind, device=dev)

    t = types.SimpleNamespace(
        src_of_q=on(np.concatenate(src), torch.int32), blk_first=on(first, torch.int64),
        blk_last=on(last, torch.int64), row_lo=on(row_lo, torch.int64), row_hi=on(row_lo + sizes - 1, torch.int64),
        row_tiles=on((sizes + 255) // 256, torch.int64), bmax_row=on(rng.uniform(0.5, 2.0, rows), torch.float32),
        max_row=int(max_row))
    sorted_xyl = on(np.stack([x, rng.uniform(0.0, 100.0, n), rng.uniform(0.0, 1.0, n) * reach]), dtype)
    y = on(rng.uniform(0.0, 100.0, n), dtype)
    order1 = on(rng.permutation(n), torch.int64)
    blk = on(rng.integers(0, 4, size=(nb, rows)), torch.int32)
    return sorted_xyl, y, order1, t, blk


def windows_cases_synthetic() -> dict:
    """Phase 9d's windows-only synthetic cases, f32 and f64: more rows
    than a CTA has threads (300, and the longest 4,097), a longest row of
    exactly 16^k and 16^k + 1 (k = 2, 3), and a wide one: 256 rows, the
    longest 2^21 (some 8,450 blocks: NB R max_row above 2^40), every radius
    factor +inf, so that every window takes its whole row and the overflow
    passes 2^32."""
    import torch

    rows = {}
    for label, rr, max_row, reach in (("r300_m4097", 300, 4097, 1.0), ("r40_m4096", 40, 4096, 1.0),
                                      ("r40_m256", 40, 256, 1.0), ("r40_m257", 40, 257, 1.0),
                                      ("r256_m2097152_inf", 256, 1 << 21, float("inf"))):
        for dtype in (torch.float32, torch.float64):
            tag = f"windows_{label}_{str(dtype).split('.')[1]}"
            rows[tag] = compare_windows(tag, synthetic_windows_case(rr, max_row, seed=rr + max_row, dtype=dtype,
                                                                    reach=reach))
    wide = rows["windows_r256_m2097152_inf_float32"]
    check(wide["blocks"] * wide["rows"] * wide["max_row"] >= 2 ** 40 and wide["overflow"] >= 2 ** 32,
          f"the wide windows case is too small: {wide}")
    return rows


def compare_build(name: str, case: dict, timed: bool = False) -> dict:
    """The structures build's kernels against their plain versions on the
    card, each on the inputs the build hands it at these tensors:
    ``principal_frame`` (K = 2 and the cell layout's K = 3; its three
    kernels at d <= 8, the general route through ``principal_axes`` above)
    on the positions, ``principal_axes`` (K = 2, 3) on their covariance,
    ``span_records`` on the permutation that the frame's projections give,
    ``span_windows`` on its records; every output bitwise equal, one launch
    a call, two launches bitwise alike (timed cases: also the windows on
    ``windows_adversarial``'s inputs).  Then the whole build through the
    kernels against the build through the plain versions (the parent's
    build, no kernel launched): every field bitwise equal, one launch of
    each kernel of the route.  ``timed``: ms a call of each wrapper and of
    the whole build replayed from a CUDA graph (``graph_ms``), of each of
    the frame's kernels and of the parent's frame (torch's mean, centring,
    covariance product and projections around ``principal_axes``) from a
    trace of replays, of the plain versions by CUDA events around eager
    calls, each bound and share."""
    import torch

    from wembed_tpu_torch.kernels import span_build as sb
    from wembed_tpu_torch.kernels import span_sparse

    pos, inv_w, weights, colors, idx, opts = (case[k] for k in ("pos", "inv_w", "weights", "colors", "idx", "opts"))
    in_index = case["in_index"]
    n, d = pos.shape
    dtype, dev = pos.dtype, pos.device
    fast = d <= sb.MAX_FAST_DIM
    frame_route = "principal_frame" if fast else "principal_axes"
    t = idx.tensors(dev)
    blk = idx.blk_t_tensor(dev)
    wrappers = build_wrappers()
    row = dict(case=name, n=n, d=d, dtype=str(dtype).split(".")[1], partial=in_index is not None,
               rows=idx.num_rows, blocks=idx.nb, max_row=t.max_row, frame_route=frame_route)

    def launched(what, fn):
        before = wrappers[what].launches
        out = fn()
        torch.cuda.synchronize()
        check(wrappers[what].launches == before + 1, f"{name}: {what} did not launch its kernel")
        return out

    centered = pos - torch.mean(pos, dim=0)
    cov = centered.T @ centered
    err = {}
    for k in (2, 3):
        got = launched("principal_axes", lambda: sb.principal_axes(cov, k))
        same_twice(f"{name}_axes{k}", [got], lambda: [sb.principal_axes(cov, k)])
        want = sb.principal_axes_reference(cov, k)
        row[f"axes{k}_bitwise"] = bitwise(got, want)
        row[f"axes{k}_finite"] = bool(torch.isfinite(got).all())
        err["principal_axes"] = max(err.get("principal_axes", 0.0), max_abs_diff([got], [want]))
        frame = launched(frame_route, lambda: sb.principal_frame(pos, k))
        same_twice(f"{name}_frame{k}", list(frame), lambda: list(sb.principal_frame(pos, k)))
        frame_p = sb.principal_frame_reference(pos, k)
        row[f"frame{k}_bitwise"] = all(bitwise(a, b) for a, b in zip(frame, frame_p))
        row[f"frame{k}_finite"] = all(bool(torch.isfinite(a).all()) for a in frame)
        err["principal_frame"] = max(err.get("principal_frame", 0.0), max_abs_diff(frame, frame_p))
    steps = launched("span_records", lambda: span_sparse.build_steps(pos, inv_w, weights, colors, idx, opts, blk,
                                                                      in_index))
    rargs, rec, wargs = steps
    same_twice(f"{name}_records", list(rec), lambda: list(sb.span_records(*rargs)))
    rec_p = sb.span_records_reference(*rargs)
    row["records_bitwise"] = all(bitwise(a, b) for a, b in zip(rec, rec_p))
    err["span_records"] = max_abs_diff(rec, rec_p)
    win = launched("span_windows", lambda: sb.span_windows(*wargs))
    same_twice(f"{name}_windows", list(win), lambda: list(sb.span_windows(*wargs)))
    win_p = sb.span_windows_reference(*wargs)
    row["windows_bitwise"] = all(bitwise(a, b) for a, b in zip(win, win_p))
    err["span_windows"] = max_abs_diff(win, win_p)
    row["max_abs_err"] = err
    row.update(overflow=int(win[2]), need=int(win[1].sum()),
               non_members=int((rec.srec[:, 0] == -1e15).sum()) if in_index is not None else 0)

    before = {k: w.launches for k, w in wrappers.items()}
    s_k = idx.structures(pos, inv_w, weights, colors, opts, blk, in_index)
    torch.cuda.synchronize()
    mid = {k: w.launches for k, w in wrappers.items()}
    with plain_build():
        s_p = idx.structures(pos, inv_w, weights, colors, opts, blk, in_index)
    torch.cuda.synchronize()
    after = {k: w.launches for k, w in wrappers.items()}
    row["build_launches"] = {k: mid[k] - before[k] for k in wrappers}
    row["plain_build_launches"] = {k: after[k] - mid[k] for k in wrappers}
    row["build_bitwise"] = {f: bitwise(getattr(s_k, f), getattr(s_p, f)) for f in s_k._fields}
    if timed:
        bounds = build_bounds(case, idx.nb, idx.num_rows, row["max_row"])
        calls = dict(principal_frame=(lambda: sb.principal_frame(pos, 2), lambda: sb.principal_frame_reference(pos, 2)),
                     principal_axes=(lambda: sb.principal_axes(cov, 2), lambda: sb.principal_axes_reference(cov, 2)),
                     span_records=(lambda: sb.span_records(*rargs), lambda: sb.span_records_reference(*rargs)),
                     span_windows=(lambda: sb.span_windows(*wargs), lambda: sb.span_windows_reference(*wargs)))
        timing = {}
        for what, (kernel, plain) in calls.items():
            ms = replay_ms(kernel, 50)
            bound_ms, bound_by = bounds[what]
            timing[what] = dict(ms=ms, plain_ms=cuda_ms(plain, 5), bound_ms=bound_ms, bound_by=bound_by,
                                share=bound_ms / ms)
        kernel_ms = replay_kernel_ms(lambda: sb.principal_frame(pos, 2), 50)
        timing["principal_frame"]["kernels"] = {
            k: dict(ms=kernel_ms.get(k), bound_ms=bounds["frame_kernels"][k][0],
                    bound_by=bounds["frame_kernels"][k][1],
                    share=bounds["frame_kernels"][k][0] / kernel_ms[k] if kernel_ms.get(k) else None)
            for k in FRAME_KERNELS}
        def parent_frame():  # the parent's route: torch's mean, centring, covariance and projections
            return sb._general_frame(pos, 2, sb.ITERS, sb.principal_axes)

        timing["parent_frame"] = dict(ms=replay_ms(parent_frame, 50), kernels=replay_kernel_ms(parent_frame, 50))
        w = timing["span_windows"]
        w["kernel_ms"] = replay_kernel_ms(lambda: sb.span_windows(*wargs), 200)["span_windows_kernel"]
        # the same windows with every radius factor +inf: every bound settles
        # from its row's ends, so the kernel searches nothing
        settled = (adversarial_windows_inputs(wargs)["lw_inf"].to(dtype), *wargs[1:])
        w["settled_kernel_ms"] = replay_kernel_ms(lambda: sb.span_windows(*settled), 200)["span_windows_kernel"]
        row["timing"] = timing
        print("windows_kernel " + json.dumps(dict(case=name, ms=w["ms"], kernel_ms=w["kernel_ms"], bound_ms=w["bound_ms"],
                                                  share=w["share"], kernel_share=w["bound_ms"] / w["kernel_ms"],
                                                  settled_kernel_ms=w["settled_kernel_ms"],
                                                  plain_ms=w["plain_ms"], card=card_line())))
        row["windows_adversarial"] = windows_adversarial(name, wargs)
        row["build_ms"] = replay_ms(lambda: idx.structures(pos, inv_w, weights, colors, opts, blk, in_index), 20)
        with plain_build():
            row["plain_build_ms"] = cuda_ms(lambda: idx.structures(pos, inv_w, weights, colors, opts, blk, in_index), 5)
    print("compare_build " + json.dumps(row))
    for k in (2, 3):
        check(row[f"axes{k}_bitwise"], f"{name}: principal_axes (K = {k}) differs from its plain version")
        check(row[f"axes{k}_finite"], f"{name}: principal_axes (K = {k}) is not finite")
        check(row[f"frame{k}_bitwise"], f"{name}: principal_frame (K = {k}) differs from its plain version")
        check(row[f"frame{k}_finite"], f"{name}: principal_frame (K = {k}) is not finite")
    check(row["records_bitwise"], f"{name}: span_records differs from its plain version")
    check(row["windows_bitwise"], f"{name}: span_windows differs from its plain version")
    check(all(row["build_bitwise"].values()), f"{name}: the build differs from the plain build: {row['build_bitwise']}")
    want = dict(principal_frame=int(fast), principal_axes=int(not fast), span_records=1, span_windows=1)
    check(row["build_launches"] == want, f"{name}: build launches {row['build_launches']}")
    check(not any(row["plain_build_launches"].values()), f"{name}: the plain build launched a kernel")
    if in_index is not None:
        check(row["non_members"] > 0, f"{name}: the member sample left no vertex out")
    return row


def compare_cell_build(name: str, impl) -> dict:
    """The cell layout's build at a cells embedder's positions and
    capacities, through ``principal_frame`` (K = 3, one call) against the
    build through its plain version: every field bitwise equal."""
    import torch

    wrappers = build_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    s_k = impl._span_structures()
    torch.cuda.synchronize()
    launches = {k: w.launches - before[k] for k, w in wrappers.items()}
    with plain_build():
        s_p = impl._span_structures()
    torch.cuda.synchronize()
    row = dict(case=name, layout=impl.span_layout, launches=launches,
               bitwise={f: bitwise(getattr(s_k, f), getattr(s_p, f)) for f in s_k._fields})
    print("compare_cell_build " + json.dumps(row))
    check(impl.span_layout == "cells", f"{name}: not the cell layout")
    check(launches == dict(principal_frame=1, principal_axes=0, span_records=0, span_windows=0),
          f"{name}: launches {launches}")
    check(all(row["bitwise"].values()), f"{name}: the cell build differs from the plain build: {row['bitwise']}")
    return row


def build_trace(name: str, impl) -> dict:
    """Kernels a structures build launches at an embedder's positions and
    windows, from a ``torch.profiler`` trace of BUILD_TRACE_BUILDS eager
    builds: through the hand kernels, and through their plain versions
    (the parent's route); each route's device ms a build and its most
    frequent kernels.  A build through the kernels may launch at most
    BUILD_LAUNCH_LIMIT kernels, its sorts included, and no cuBLAS product
    (the frame's covariance and projections are its own kernels)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    routes = {}
    for route in ("kernels", "plain"):
        with plain_build() if route == "plain" else contextlib.nullcontext():
            impl._span_structures()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(BUILD_TRACE_BUILDS):
                    impl._span_structures()
                torch.cuda.synchronize()
        kernels_n, copies, device_ms, names = 0, 0, 0.0, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if e.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels_n += 1
                names[e.name[:48]] = names.get(e.name[:48], 0) + 1
            device_ms += e.time_range.elapsed_us() / 1000.0
        top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
        routes[route] = dict(
            kernels_per_build=kernels_n / BUILD_TRACE_BUILDS, copies_per_build=copies / BUILD_TRACE_BUILDS,
            device_ms_per_build=device_ms / BUILD_TRACE_BUILDS,
            top_kernels_per_build={k: v / BUILD_TRACE_BUILDS for k, v in top},
            products=sorted(k for k in names if "gemm" in k or "gemv" in k),
            frame_kernels_per_build=sum(v for k, v in names.items() if any(f in k for f in FRAME_KERNELS))
            / BUILD_TRACE_BUILDS,
        )
    row = dict(case=name, **routes)
    print("build_trace " + json.dumps(row))
    k = routes["kernels"]["kernels_per_build"]
    check(0 < k <= BUILD_LAUNCH_LIMIT, f"{name}: a structures build launched {k} kernels")
    check(not routes["kernels"]["products"], f"{name}: the build ran a cuBLAS product: {routes['kernels']['products']}")
    # a trace may miss its first launches, so a build shows at most, not exactly, three
    check(0 < routes["kernels"]["frame_kernels_per_build"] <= len(FRAME_KERNELS),
          f"{name}: the frame took {routes['kernels']['frame_kernels_per_build']} launches a build")
    return row


BUILD_REPLACES = dict(  # the JAX lines each build kernel stands for (plain jnp, not Pallas)
    principal_frame="wembed_tpu/kernels/span_sparse.py:977",
    principal_axes="wembed_tpu/core/candidates.py:409",
    span_records="wembed_tpu/kernels/span_sparse.py:995",
    span_windows="wembed_tpu/kernels/span_sparse.py:1159",
)


def build_kernel_entries(rows: dict, traces: dict, d4: dict, paths: dict) -> list[dict]:
    """The kernels line's entries of the structures build's four wrappers
    (the frame's three kernels one entry; the axes kernel the frame's
    general route, d > 8): launches on the flat span main path and on every
    other path that ran them, the times, bound and error at converged
    girg100k d=2 (d=4 and the start positions beside them), and the
    build's kernels a call in the traces, through the kernels and through
    the plain versions."""
    conv = rows["girg100k_d2_converged"]
    entries = []
    for name in BUILD_KERNELS:
        timing = conv["timing"][name]
        if name == "principal_frame":
            extra = dict(kernels=timing["kernels"], parent_frame=conv["timing"]["parent_frame"])
        elif name == "span_windows":
            extra = dict(kernel_ms=timing["kernel_ms"])  # its device time, from a trace of replays
        else:
            extra = {}
        entries.append({
            **extra,
            "name": name,
            "route": "cuda",
            "source": "wembed_tpu_torch/csrc/span_build.cu",
            # no Pallas kernel: the JAX package builds the span structures as plain jnp
            "replaces": BUILD_REPLACES[name],
            "launches": paths["flat"][name],
            "launches_paths": {path: launches[name] for path, launches in paths.items()},
            "girg100k_d4_converged": d4["runs"]["windows"]["build"]["timing"][name],
            "girg100k_d2_iter0": rows["girg100k_d2_iter0"]["timing"][name],
            "girg100k_d2_iter0_f64": rows["girg100k_d2_iter0_f64"]["timing"][name],
            "max_abs_err": max(row["max_abs_err"][name] for row in rows.values()),
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": None,  # no PyTorch call computes this part of the build
        })
    entries[0]["build_kernels_a_call"] = {
        case: {route: trace[route]["kernels_per_build"] for route in ("kernels", "plain")}
        for case, trace in {**traces, "girg100k_d4_converged": d4["runs"]["windows"]["build_trace"]}.items()
    }
    return entries


LAUNCH_PHASES = (  # name patterns of a span step's device events, in the order they are tried
    ("copies", ("Memcpy", "Memset", "memset", "memcpy")),
    ("build_kernels", ("principal_axes_kernel", "span_records_kernel", "span_windows_kernel", *FRAME_KERNELS)),
    ("sorts", ("RadixSort", "fill_reverse", "radix_sort", "sort_")),
    ("sweep", ("span_sweep_kernel", "span_reduce_kernel", "span_sweep_general", "span_reduce_general")),
    ("edge_pass", ("segment_pass_kernel", "segment_pass_general_kernel")),
)


def launch_phases(prof, calls: int) -> dict:
    """A trace's device events a call, by LAUNCH_PHASES (the rest:
    ``other``)."""
    import torch

    counts = {name: 0 for name, _ in LAUNCH_PHASES}
    counts["other"] = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        phase = next((name for name, pats in LAUNCH_PHASES if any(p in e.name for p in pats)), "other")
        counts[phase] += 1
    return {k: v / calls for k, v in counts.items()}


def step_launch_account(name: str, impl, steps: int = 10) -> dict:
    """A replayed span step's device events by phase, from a trace of
    ``steps`` steps, beside one eager build's: the build's axes and
    gathers are the build's ``other`` events, and the step's ``other``
    less those is the finish (the kick draws, the optimizer, gravity, the
    displacement and the sums)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    impl._state = impl._step(impl._state)
    impl._state.pos_change.item()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            impl._state = impl._step(impl._state)
            impl._state.pos_change.item()
        torch.cuda.synchronize()
    step = launch_phases(prof, steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            impl._span_structures()
        torch.cuda.synchronize()
    build = launch_phases(prof, steps)
    row = dict(case=name, step=step, build=build, step_total=sum(step.values()), build_total=sum(build.values()),
               finish=step["other"] - build["other"])
    print("step_launch_account " + json.dumps(row))
    return row


def build_cases_iteration0(impl) -> dict:
    """Phase 9d at girg100k d=2's start positions (iteration 0): the build
    kernels against their plain versions (timed), in f64 (timed), and with
    a partial index (``index_size=0.5``, one member draw)."""
    import torch

    from wembed_tpu_torch.core import EmbedderOptions
    from wembed_tpu_torch.kernels.span_sparse import SpanIndex

    st = impl.state
    at0 = (st.positions, impl._inv_w, impl._weights, impl._dg.colors)
    rows = {"girg100k_d2_iter0": compare_build("girg100k_d2_iter0", build_case(*at0, impl._index, impl.opts),
                                               timed=True)}
    f64 = torch.float64
    rows["girg100k_d2_iter0_f64"] = compare_build("girg100k_d2_iter0_f64", build_case(
        at0[0].to(f64), at0[1].to(f64), at0[2].to(f64), at0[3], impl._index, impl.opts), timed=True)
    half_opts = EmbedderOptions(embedding_dimension=2, index_size=0.5)
    half = SpanIndex.build(impl.get_weights(), half_opts, *impl._span_edges())
    members = half.draw_members(torch.Generator(device=st.positions.device).manual_seed(5))
    rows["girg100k_d2_iter0_partial_index"] = compare_build(
        "girg100k_d2_iter0_partial_index", build_case(*at0, half, half_opts, in_index=members))
    return rows


def build_cases_synthetic() -> dict:
    """Phase 9d on synthetic graphs: d = 1 (the first axis searched too),
    d = 3 (the cell layout's dimension; K = 3 axes), d = 16 (the records
    kernel's general instance), f64 at d = 3, and degenerate clouds at d
    = 2 and 3: every point equal (a zero covariance, every norm 0) and
    points on a line (a covariance of rank 1)."""
    import torch

    rows = {}
    for label, n, d, kw in (("n20000_d1", 20000, 1, {}), ("n20000_d3", 20000, 3, {}),
                            ("n8000_d16", 8000, 16, {}), ("n20000_d3_f64", 20000, 3, dict(dtype=torch.float64)),
                            ("n20000_d2_equal", 20000, 2, dict(cloud="equal")),
                            ("n20000_d3_equal", 20000, 3, dict(cloud="equal")),
                            ("n20000_d3_line", 20000, 3, dict(cloud="line"))):
        rows[label] = compare_build(label, synthetic_build_case(n, d, seed=70 + d, **kw))
    return rows


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
    block_tiles = impl._blk_t.cpu().numpy().sum(axis=1)  # windows, or a cell index's capacities
    # the sweep's CTAs are query blocks: the longest one bounds the call
    t = impl._index.tensors(st.positions.device)
    parts["item_sizes"] = span_item_sizes(
        (s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off),
        dict(dim=impl._index.d, L=impl.opts.edge_length, rep_scale=impl.opts.repulsion_scale,
             additive=impl.opts.additive_weights),
    )
    items = impl._items
    if st.positions.dtype == torch.float32 and impl._index.d <= 8:
        parts["prefilter"] = dict(
            prefilter_share((s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off),
                            dict(dim=impl._index.d, L=impl.opts.edge_length,
                                 rep_scale=impl.opts.repulsion_scale,
                                 additive=impl.opts.additive_weights, items=items)),
            max_abs_pos=float(st.positions.abs().max()))
    parts.update(work_tiles=impl._index.w, blocks=int(block_tiles.shape[0]),
                 max_block_tiles=int(block_tiles.max()), mean_block_tiles=float(block_tiles.mean()),
                 items=int(items.shape[0]), max_item_tiles=int(items[:, 3].max()))
    return parts


def profile_steps(impl, steps: int = 20) -> dict:
    """A ``torch.profiler`` window over ``steps`` steps of the main loop
    (each step ends in its one synchronisation): host ms a step, kernel
    launches and device ms a step, the device's idle share (kernel time is
    summed; the step's kernels run on one stream, so they do not overlap)
    and the five kernels that take the most device time; and the six host
    operations that take the most host time of their own (self CPU ms a
    step).  The profiler's own overhead lengthens the host time, so the
    idle share is an upper bound."""
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
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:6]
    host_top = {a.key[:60]: a.self_cpu_time_total / 1000.0 / steps for a in host}
    if device_ms == 0.0:
        return dict(steps=steps, step_wall_ms=wall_ms / steps, device="not measured",
                    host_top_ms_per_step=host_top)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(
        steps=steps, step_wall_ms=wall_ms / steps, device_ms_per_step=device_ms / steps,
        launches_per_step=launches / steps, idle_share=1.0 - device_ms / wall_ms,
        top_ms_per_step={name[:60]: ms / steps for name, ms in top},
        host_top_ms_per_step=host_top,
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


def counters():
    """The launch counter of each hand kernel's wrapper."""
    from wembed_tpu_torch.kernels import edge_pass, fused_dense, span_sweep

    return dict(fused_dense=fused_dense.fused_dense_forces, span_sweep=span_sweep.span_sweep,
                span_reduce=span_sweep.span_reduce, edge_pass=edge_pass.edge_pass, **build_wrappers())


def build_wrappers() -> dict:
    """The structures build's three wrappers, which hold their counters
    (taken from ``kernels._COUNTERS``, so ``plain_build`` does not hide
    them)."""
    from wembed_tpu_torch import kernels

    found = {fn.__name__: fn for fn, _ in kernels._COUNTERS}
    return {name: found[name] for name in BUILD_KERNELS}


def reset_launches() -> None:
    for wrapper in counters().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in counters().items()}


def continue_run(impl, cap: int | None = None) -> tuple[float, dict]:
    """``calculate_embedding()`` (of a flat embedder: to ``cap`` iterations
    when given) with every launch count set to 0 just before and read just
    after: (wall seconds, launches)."""
    import torch

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cap is None:
        impl.calculate_embedding()
    else:
        impl.calculate_embedding(max_iterations=cap)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, read_launches()


def same_state(a, b) -> bool:
    """Every state tensor of two embedders bitwise equal."""
    import torch

    names = STATE_TENSORS + ("num_rep_forces", "overflow")
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in names)


def flat_resume(name: str, graph, kernel: str, tmp: Path, make=None) -> dict:
    """``calculate_embedding`` capped at RESUME_CAP, a checkpoint, then on
    to convergence; a fresh embedder from another seed loads the file and
    continues.  Final state, iterations, growth events and ``kernel``'s
    launches after the checkpoint must be equal, bit for bit.  ``make()``
    builds each embedder (default: the API's, d=2)."""
    from wembed_tpu_torch import api
    from wembed_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint

    if make is None:
        def make():
            return api.createEmbedder(graph, api.Options(embeddingDimension=2)).impl

    api.setSeed(1)
    saved = make()
    saved.calculate_embedding(max_iterations=RESUME_CAP)
    path = str(tmp / f"{name}.npz")
    t0 = time.perf_counter()
    save_checkpoint(path, saved)
    save_s = time.perf_counter() - t0
    saved_wall, saved_launches = continue_run(saved)
    api.setSeed(2)
    resumed = make()
    t0 = time.perf_counter()
    load_checkpoint(path, resumed)
    load_s = time.perf_counter() - t0
    resumed_wall, resumed_launches = continue_run(resumed)
    row = dict(
        graph=name, path=resumed.path, cap=RESUME_CAP, iterations=[saved.iteration, resumed.iteration],
        launches_after_checkpoint=[saved_launches[kernel], resumed_launches[kernel]],
        launches_resumed=resumed_launches,
        growth_events=[saved.growth_events, resumed.growth_events],
        final_overflow=[saved.final_overflow, resumed.final_overflow],
        total_loss=[saved.get_loss().total, resumed.get_loss().total],
        bitwise_equal=same_state(saved.state, resumed.state),
        file_bytes=Path(path).stat().st_size, save_s=save_s, load_s=load_s,
        continue_wall_s=[saved_wall, resumed_wall],
    )
    print(f"resume_{name} " + json.dumps(row))
    check(row["bitwise_equal"], f"{name} resume: the final states differ")
    check(saved.iteration == resumed.iteration < 1000, f"{name} resume: iterations {row['iterations']}")
    check(saved_launches == resumed_launches and resumed_launches[kernel] == saved.iteration - RESUME_CAP,
          f"{name} resume: launches after the checkpoint {saved_launches} / {resumed_launches}")
    check(saved.growth_events == resumed.growth_events, f"{name} resume: growth events differ")
    check(saved.final_overflow == resumed.final_overflow == 0, f"{name} resume: final overflow")
    return row


def layered_resume(graph, tmp: Path) -> dict:
    """The layered API run stepped by ``calculateStep`` into girg100k's
    first span layer, checkpointed there, and continued by
    ``calculate_embedding``; a layered embedder built from another seed
    loads the file (its hierarchy then comes from the file) and continues.
    Final coordinates bitwise equal, both kernels launched as often after
    the checkpoint, MAP at least MAP_FACTOR x the JAX package's."""
    import numpy as np

    from wembed_tpu_torch import api
    from wembed_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
    from wembed_tpu_torch.eval import reconstruction_metrics
    from wembed_tpu_torch.eval.spaces import WeightedGeometric

    options = api.Options(embeddingDimension=2, layeredEmbedding=True)
    api.setSeed(1)
    saved = api.createEmbedder(graph, options)
    impl = saved.impl
    t0 = time.perf_counter()
    steps = 0
    while impl.current_layer > 1:
        saved.calculateStep()
        steps += 1
    step_s = time.perf_counter() - t0
    check(impl.num_vertices == RESUME_LAYER_N and impl._current.path == "span",
          f"layered resume: layer 1 has {impl.num_vertices} vertices on the {impl._current.path} path")
    path = str(tmp / "layered.npz")
    save_checkpoint(path, impl)
    saved_wall, saved_launches = continue_run(impl)
    api.setSeed(2)
    resumed = api.createEmbedder(graph, options).impl
    load_checkpoint(path, resumed)
    parents_equal = all(
        np.array_equal(a.parent, b.parent) for a, b in zip(resumed.hierarchy.layers, impl.hierarchy.layers)
    )
    resumed_wall, resumed_launches = continue_run(resumed)
    coords, weights = resumed.get_coordinates(), resumed.get_weights()
    quality = reconstruction_metrics(
        graph.csr, WeightedGeometric(coords, weights=weights), NODE_SAMPLES, np.random.default_rng(1),
        device="cuda",
    )
    row = dict(
        steps_to_layer=steps, step_s=step_s, layer_n=RESUME_LAYER_N, parents_equal=parents_equal,
        layers=[r.n for r in resumed.layer_records], iterations=[impl.iteration, resumed.iteration],
        launches_after_checkpoint=[saved_launches, resumed_launches],
        final_overflow=[impl._current.final_overflow, resumed._current.final_overflow],
        bitwise_equal=bool(np.array_equal(coords, impl.get_coordinates()))
        and same_state(impl.state, resumed.state),
        continue_wall_s=[saved_wall, resumed_wall], **quality,
    )
    print("resume_layered " + json.dumps(row))
    check(parents_equal, "layered resume: the hierarchy does not come from the file")
    check(row["layers"] == [RESUME_LAYER_N, graph.getNumVertices()], f"layered resume: layers {row['layers']}")
    check(row["bitwise_equal"], "layered resume: the final coordinates differ")
    check(impl.iteration == resumed.iteration, f"layered resume: iterations {row['iterations']}")
    check(saved_launches == resumed_launches and resumed_launches["span_sweep"] > 0,
          f"layered resume: launches {saved_launches} / {resumed_launches}")
    check(row["final_overflow"] == [0, 0], f"layered resume: final overflow {row['final_overflow']}")
    target = MAP_FACTOR * MAP_LAYERED_TARGET
    check(quality["MAP"] >= target, f"layered resume: MAP {quality['MAP']} < {target}")
    return dict(row, launches=resumed_launches)


def profiled_run(name: str, graph, kernel: str, normal_wall: float, ref_total: float) -> dict:
    """The API run with ``profile`` set on the embedder (as ``embed
    --profile-timings`` sets it) to convergence: the phase tree from CUDA
    events, one launch of ``kernel`` a step, the loss limit, and the
    profiled wall beside the normal run's."""
    import torch

    from wembed_tpu_torch import api

    api.setSeed(1)
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
    embedder.impl.profile = True
    wall, launches = continue_run(embedder.impl)
    iterations = embedder.impl.iteration
    timings = embedder.getTimings()
    tree = [(t.depth, t.display_name) for t in timings]
    want = [(0, "Embedding")] + [(1, p) for p in (("index",) if kernel == "span_sweep" else ()) + PHASES]
    loss = embedder.getLoss()
    row = dict(
        graph=name, iterations=iterations, launches=launches[kernel], launches_all=launches, wall_s=wall,
        normal_wall_s=normal_wall, total_loss=loss.total, reference_total_loss=ref_total,
        phase_ms_per_step={t.display_name: t.value * 1000.0 / iterations for t in timings[1:]},
        embedding_s=timings[0].value,
    )
    print(f"profile_tree_{name}\n" + api.timingsToString(timings))
    print(f"profiled_{name} " + json.dumps(row))
    check(tree == want, f"{name} profile: tree {tree}")
    check(0 < iterations < 1000, f"{name} profile: {iterations} iterations")
    check(launches[kernel] == iterations, f"{name} profile: {launches[kernel]} launches for {iterations} steps")
    check_finite(embedder.impl.state, f"after the profiled {name} run")
    check(loss.total <= LOSS_FACTOR * ref_total, f"{name} profile: total loss {loss.total}")
    torch.cuda.synchronize()
    return row


def sampled_run(graph) -> dict:
    """girg100k d=2 with NEGATIVE_SAMPLES negatives a vertex: finite state,
    every step's candidate count within [0.99 n k, n k] (non-neighbours of
    another colour among the draws), MAP and F1 printed with no floor."""
    import torch

    from wembed_tpu_torch import api
    from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder

    api.setSeed(1)
    impl = WEmbedEmbedder(
        graph.csr, EmbedderOptions(embedding_dimension=2, num_negative_samples=NEGATIVE_SAMPLES), verbose=False
    )
    counts = []
    step = impl._step

    def recording_step(state):
        state = step(state)
        counts.append(state.num_rep_forces)  # kept on the card: no synchronisation
        return state

    impl._step = recording_step
    wall, launches = continue_run(impl)
    counts = torch.stack(counts).cpu()
    n, k = graph.getNumVertices(), NEGATIVE_SAMPLES
    quality = evaluate_embedding(graph.csr, impl.get_coordinates(), impl.get_weights())
    loss = impl.get_loss()
    row = dict(
        graph="girg100k", n=n, k=k, path=impl.path, iterations=impl.iteration, wall_s=wall,
        step_ms=wall * 1000.0 / impl.iteration, launches=launches,
        count_min=int(counts.min()), count_max=int(counts.max()), att_loss=loss.attractive,
        rep_loss=loss.repulsive, total_loss=loss.total, **quality,
    )
    print("sampled_girg100k " + json.dumps(row))
    check(impl.path == "sampled" and len(counts) == impl.iteration > 0, "sampled run: no sampled steps")
    check_finite(impl.state, "on the sampled path")
    check(0.99 * n * k <= row["count_min"] and row["count_max"] <= n * k,
          f"sampled run: counts {row['count_min']}..{row['count_max']} outside [0.99 n k, n k]")
    return row


def debug_checks_run(graph) -> dict:
    """DEBUG_STEPS steps of girg10k with ``debug_checks``: every step
    validates the state and must pass clean."""
    from wembed_tpu_torch import api
    from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder

    api.setSeed(1)
    impl = WEmbedEmbedder(graph.csr, EmbedderOptions(embedding_dimension=2, debug_checks=True), verbose=False)
    t0 = time.perf_counter()
    for _ in range(DEBUG_STEPS):
        impl.calculate_step()  # raises FloatingPointError on a non-finite state tensor
    row = dict(steps=impl.iteration, wall_s=time.perf_counter() - t0)
    print("debug_checks " + json.dumps(row))
    check(impl.iteration == DEBUG_STEPS, "debug checks: steps missing")
    return row


def map_only(csr, coords, weights) -> float:
    """Reconstruction MAP (NODE_SAMPLES vertices ranked on the card, the
    evaluator's stream for seed 1): the same number ``evaluate_embedding``
    gives, without its host-bound edge detection."""
    import numpy as np

    from wembed_tpu_torch.eval import reconstruction_metrics
    from wembed_tpu_torch.eval.spaces import WeightedGeometric

    space = WeightedGeometric(coords, weights=weights)
    return reconstruction_metrics(csr, space, NODE_SAMPLES, np.random.default_rng(1), device="cuda")["MAP"]


def general_launches() -> dict:
    from wembed_tpu_torch.kernels import edge_pass, fused_dense, span_sweep

    return dict(fused_dense=fused_dense.fused_dense_forces.launches_general,
                span_sweep=span_sweep.span_sweep.launches_general,
                edge_pass=edge_pass.edge_pass.launches_general)


def converge(name: str, impl, graph, kernel: str, ref_total: float | None = None,
             map_floor: float | None = None, cap: int | None = None, below_cap: bool = True) -> dict:
    """``calculate_embedding`` (to ``cap`` iterations when given) with the
    launch counts set to 0 just before and read just after; finite state,
    final overflow 0 and one launch of ``kernel`` a step, then (unless
    ``cap`` is given or ``below_cap`` is False) convergence below 1000
    iterations, the loss limit and the MAP floor where given."""
    import torch

    it0 = impl.iteration
    reset_launches()
    general = general_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    impl.calculate_embedding(max_iterations=cap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    general = {k: v - general[k] for k, v in general_launches().items()}
    loss = impl.get_loss()
    row = dict(
        run=name, n=graph.getNumVertices(), d=impl.embedding_dimension,
        dtype=str(impl.state.positions.dtype).split(".")[1], path=impl.path,
        iterations=impl.iteration, launches=launches, launches_general=general,
        growth_events=impl.growth_events, final_overflow=impl.final_overflow,
        att_loss=loss.attractive, rep_loss=loss.repulsive, total_loss=loss.total,
        reference_total_loss=ref_total, wall_s=wall,
        step_ms=wall * 1000.0 / max(impl.iteration - it0, 1),
    )
    row["MAP"] = map_only(graph.csr, impl.get_coordinates(), impl.get_weights())
    print(f"{name} " + json.dumps(row))
    check_finite(impl.state, f"in {name}")
    check(impl.final_overflow == 0, f"{name}: final overflow {impl.final_overflow}")
    steps = impl.iteration - it0
    check(launches[kernel] == steps > 0, f"{name}: {launches[kernel]} launches for {steps} steps")
    if cap is None and below_cap:
        check(impl.iteration < 1000, f"{name}: {impl.iteration} iterations")
    if ref_total is not None:
        check(loss.total <= LOSS_FACTOR * ref_total, f"{name}: total loss {loss.total} > {LOSS_FACTOR} x {ref_total}")
    if map_floor is not None:
        check(row["MAP"] >= map_floor, f"{name}: MAP {row['MAP']} < {map_floor}")
    return row


def f64_card_against_cpu(steps: int = 3) -> list[dict]:
    """A 3,000-vertex GIRG in f64, ``steps`` steps on the card (the general
    kernels) against the port's CPU run from the same coordinates, on the
    dense and the span path: positions and losses within rtol 1e-9, counts
    equal."""
    import numpy as np
    import torch

    from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder
    from wembed_tpu_torch.graphs import generators
    from wembed_tpu_torch.utils import set_seed

    g = generators.girg(3200, dim=2, avg_degree=12, ple=2.5, rng=np.random.default_rng(3))[0]
    coords = np.random.default_rng(4).uniform(0, g.num_vertices ** 0.5, size=(g.num_vertices, 2))
    rows = []
    for mode in (RepulsionMode.DENSE, RepulsionMode.BUCKET):
        opts = EmbedderOptions(embedding_dimension=2, dtype="float64", repulsion_mode=mode)
        runs = []
        for device in ("cuda", "cpu"):
            set_seed(1)
            emb = WEmbedEmbedder(g, opts, initial_coordinates=coords, verbose=False, device=device)
            for _ in range(steps):
                emb.calculate_step()
            runs.append(emb)
        card, cpu = runs
        err = float(np.max(np.abs(card.get_coordinates() - cpu.get_coordinates())
                           / np.maximum(np.abs(cpu.get_coordinates()), 1e-300)))
        row = dict(n=g.num_vertices, path=card.path, steps=steps, max_rel_err=err,
                   rep_count=[int(card.state.num_rep_forces), int(cpu.state.num_rep_forces)],
                   total_loss=[card.get_loss().total, cpu.get_loss().total],
                   overflow=[card.final_overflow, cpu.final_overflow])
        print("f64_card_cpu " + json.dumps(row))
        np_ok = np.allclose(card.get_coordinates(), cpu.get_coordinates(), rtol=1e-9, atol=1e-9)
        check(np_ok, f"f64 {card.path}: the card's positions differ from the CPU's by {err}")
        check(row["rep_count"][0] == row["rep_count"][1] > 0, f"f64 {card.path}: counts {row['rep_count']}")
        for a, b in ((card.get_loss().attractive, cpu.get_loss().attractive),
                     (card.get_loss().repulsive, cpu.get_loss().repulsive)):
            check(abs(a - b) <= 1e-9 * abs(b), f"f64 {card.path}: losses {a} != {b}")
        check(card.state.positions.dtype == torch.float64 and card.device.type == "cuda", "f64 run not on the card")
        rows.append(row)
    return rows


def presized_case(tensors, idx, opts):
    """``sized_span_case`` after the embedder's presize at these positions:
    every window (or capacity) resized to its need first."""
    s = idx.structures(*tensors, opts)
    return sized_span_case(tensors, idx.resize_to_needs(s.need.cpu().numpy()) or idx, opts)


def cells_sweep_case(impl) -> dict:
    """``presized_case`` of a cell embedder at its current positions, with
    the capacities' live and dead tiles: a block's kept members fill
    ceil(kept / 256) live tiles, the rest of its capacity holds sentinel
    members, which the sweep visits all the same.  The bound counts the
    pairs of the kept members (256 query slots each)."""
    import numpy as np

    from wembed_tpu_torch.kernels import span_sweep

    st = impl.state
    case = presized_case((st.positions, impl._inv_w, impl._weights, impl._dg.colors), impl._index, impl.opts)
    caps = case["args"][4][:, 0].cpu().numpy().astype(np.int64)
    kept = np.minimum(case["need"].cpu().numpy(), caps * span_sweep.ST)
    live = int((-(-kept // span_sweep.ST)).sum())
    layout = dict(capacity_tiles=case["tiles"], live_tiles=live, dead_share=1.0 - live / case["tiles"],
                  kept_members=int(kept.sum()), member_slot_share=float(kept.sum()) / (case["tiles"] * span_sweep.ST),
                  blocks=int(caps.shape[0]))
    print("cells_layout " + json.dumps(layout))
    return dict(case, pairs=int(kept.sum()) * span_sweep.Q, layout=layout)


def layout_profile(name: str, impl) -> dict:
    """A converged span embedder's step by CUDA events: the structures
    build, the sweep, the edge pass (fused forces minus the sweep) and 20
    whole steps of the loop (each ending in its one synchronisation), the
    sweep's share of the step; then ``profile_steps`` over 20 more."""
    import torch

    parts = span_breakdown(impl)

    def one_step():
        impl._state = impl._step(impl._state)
        impl._state.pos_change.item()

    parts["step_ms"] = cuda_ms(one_step, 20)
    parts["sweep_share"] = parts["sweep_ms"] / parts["step_ms"]
    parts["profile"] = profile_steps(impl)
    torch.cuda.synchronize()
    print(f"d4_profile_{name} " + json.dumps(parts))
    return parts


def cells_resume(graph, tmp: Path) -> dict:
    """A cells run of CELLS_RESUME steps, a checkpoint, and a fresh cell
    embedder from another seed that loads it and runs CELLS_RESUME more,
    against 2 x CELLS_RESUME straight steps: every state tensor, the
    capacities and the growth events equal, bit for bit."""
    import numpy as np

    from wembed_tpu_torch import api
    from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder
    from wembed_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint

    opts = EmbedderOptions(embedding_dimension=4, span_layout="cells")

    def make():
        return WEmbedEmbedder(graph.csr, opts, verbose=False)

    api.setSeed(1)
    straight = make()
    straight.calculate_embedding(max_iterations=2 * CELLS_RESUME)
    api.setSeed(1)
    first = make()
    first.calculate_embedding(max_iterations=CELLS_RESUME)
    path = str(tmp / "cells.npz")
    save_checkpoint(path, first)
    open_segment_growth = first._segment_growth  # growths since iteration 50, carried by the file
    del first
    api.setSeed(2)
    resumed = make()
    load_checkpoint(path, resumed)
    wall, launches = continue_run(resumed, 2 * CELLS_RESUME)
    row = dict(
        steps=[CELLS_RESUME, CELLS_RESUME], iterations=[straight.iteration, resumed.iteration],
        launches_after_checkpoint=launches["span_sweep"],
        growth_events=[straight.growth_events, resumed.growth_events],
        open_segment_growth_at_checkpoint=open_segment_growth,
        capacity_tiles=[straight._index.w, resumed._index.w],
        bitwise_equal=same_state(straight.state, resumed.state)
        and bool(np.array_equal(straight._index.cap_t, resumed._index.cap_t)),
        continue_wall_s=wall,
    )
    print("resume_cells_girg100k_d4 " + json.dumps(row))
    check(resumed.span_layout == "cells", "cells resume: not the cell layout")
    check(row["bitwise_equal"], "cells resume: 2 x 60 steps differ from 120 straight steps")
    check(straight.iteration == resumed.iteration == 2 * CELLS_RESUME, f"cells resume: iterations {row['iterations']}")
    check(launches["span_sweep"] == CELLS_RESUME, f"cells resume: {launches} after the checkpoint")
    check(straight.growth_events == resumed.growth_events, "cells resume: growth events differ")
    return row


def girg100k_d4(generators: dict, reference: dict, tmp: Path) -> dict:
    """Phase 13b: girg100k d=4 (the reference's default dimension) under
    both span layouts.  The cells sweep against its plain version at the
    positions after 20 steps of a cells run, and the windows sweep at the
    same positions, each layout presized there; then each layout to convergence from seed 1 through
    ``WEmbedEmbedder`` (the loss and MAP limits, final overflow 0, one
    sweep launch a step, the fast kernel only), scored, and profiled at the
    converged positions; then the cells resume."""
    from wembed_tpu_torch import api
    from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder
    from wembed_tpu_torch.kernels.span_sparse import SpanIndex

    t0 = time.perf_counter()
    seconds = finish_graph(GIRG100K_D4, *generators[GIRG100K_D4])
    md5 = hashlib.md5(GIRG100K_D4.read_bytes()).hexdigest()
    graph = api.graphFromEdgeListFile(str(GIRG100K_D4))
    n, m = graph.getNumVertices(), graph.getNumEdges()
    print("girg100k_d4 " + json.dumps(dict(md5=md5, n=n, m=m, generate_s=seconds)))
    check((n, m) == (reference["n"], reference["m"]), f"girg100k_d4 n={n} m={m}")
    check(GIRG100K_D4_MD5 is None or md5 == GIRG100K_D4_MD5, f"girg100k_d4 md5 {md5}")
    ref_total = reference["att_loss"] + reference["rep_loss"]
    map_floor = MAP_FACTOR * reference["map"]
    layouts = dict(windows=EmbedderOptions(embedding_dimension=4),
                   cells=EmbedderOptions(embedding_dimension=4, span_layout="cells"))

    api.setSeed(1)
    impl = WEmbedEmbedder(graph.csr, layouts["cells"], verbose=False)
    check(impl.span_layout == "cells", f"span_layout='cells' built the {impl.span_layout} layout")
    for _ in range(COMPARE_STEPS):
        impl.calculate_step()
    case = cells_sweep_case(impl)
    sweeps = dict(cells=compare_span("girg100k_d4_cells_step20", case, timed=True))
    sweeps["cells"]["layout"] = case["layout"]
    edge_cells = compare_edge_pass("girg100k_d4_cells_step20", edge_case(impl), modes=("fused", "correction"),
                                   timed=True)
    cell_builds = {"girg100k_d4_cells_step20": compare_cell_build("girg100k_d4_cells_step20", impl)}
    st = impl.state
    windows = SpanIndex.build(impl.get_weights(), layouts["windows"], graph.csr.edge_src, graph.csr.col_idx)
    sweeps["windows"] = compare_span("girg100k_d4_windows_step20", presized_case(
        (st.positions, impl._inv_w, impl._weights, impl._dg.colors), windows, layouts["windows"]), timed=True)
    del impl, st, case

    runs = {}
    for name, opts in layouts.items():
        api.setSeed(1)
        impl = WEmbedEmbedder(graph.csr, opts, verbose=False)
        check(impl.span_layout == name, f"{name}: built the {impl.span_layout} layout")
        row = converge(f"girg100k_d4_{name}", impl, graph, "span_sweep", ref_total=ref_total, map_floor=map_floor)
        check(row["launches_general"]["span_sweep"] == row["launches_general"]["edge_pass"] == 0,
              f"{name}: a general kernel ran: {row['launches_general']}")
        row.update(final_work_tiles=impl._index.w, shrink_events=impl._shrink_events,
                   quality=evaluate_embedding(graph.csr, impl.get_coordinates(), impl.get_weights()))
        print(f"quality_girg100k_d4_{name} " + json.dumps(row["quality"]))
        row["profile"] = layout_profile(name, impl)
        if name == "windows":
            row["edge_pass"] = edge_pass_converged("girg100k_d4_converged", impl, row["launches"]["edge_pass"])
            st = impl.state
            row["build"] = compare_build("girg100k_d4_converged", build_case(
                st.positions, impl._inv_w, impl._weights, impl._dg.colors, impl._index, impl.opts), timed=True)
            row["build_trace"] = build_trace("girg100k_d4_converged", impl)
            row["launch_account"] = step_launch_account("girg100k_d4_converged", impl)
            row["reduce"] = reduce_converged("girg100k_d4_converged", span_case(
                st.positions, impl._inv_w, impl._weights, impl._dg.colors, impl._index, impl.opts),
                row["launches"]["span_reduce"])
            check(row["launches"]["span_reduce"] == row["launches"]["span_sweep"],
                  f"girg100k_d4: {row['launches']} launches")
            del st
        else:
            cell_builds["girg100k_d4_cells_converged"] = compare_cell_build("girg100k_d4_cells_converged", impl)
        runs[name] = row
        del impl
    resume = cells_resume(graph, tmp)
    summary = dict(
        seconds=time.perf_counter() - t0, reference_total_loss=ref_total, reference_iterations=reference["iters_to_converge"],
        **{f"{name}_{k}": runs[name][k] for name in layouts for k in ("iterations", "wall_s", "step_ms", "total_loss", "MAP")},
        **{f"{name}_sweep_share": runs[name]["profile"]["sweep_share"] for name in layouts},
    )
    print("phase13b " + json.dumps(summary))
    return dict(sweeps=sweeps, runs=runs, resume=resume, edge_cells=edge_cells, cell_builds=cell_builds)


def partial_index_run(graph, tmp: Path) -> dict:
    """girg100k d=2 with ``index_size=0.5`` to convergence: every step's
    member sample has each class's exact size (counted on the card, read
    once at the end), final overflow 0, loss and MAP printed with no
    limit; then a checkpoint resume at RESUME_CAP, bitwise."""
    import torch

    from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder
    from wembed_tpu_torch.kernels import span_sparse

    def make():
        return WEmbedEmbedder(graph.csr, EmbedderOptions(embedding_dimension=2, index_size=0.5), verbose=False)

    from wembed_tpu_torch import api

    api.setSeed(1)
    impl = make()
    check(impl.path == "span" and impl._index.partial, "index_size=0.5 is not a partial span index")
    # [steps checked, steps with a class of the wrong size], tallied on the
    # card in place by every step, a replayed one too: a step's draw and its
    # tally are captured together, and nothing is read back until the end
    tally = torch.zeros(2, dtype=torch.int64, device="cuda")
    draw = span_sparse.SpanIndex.draw_members

    def counting_draw(index, generator):
        member = draw(index, generator)
        t = index.tensors(generator.device)
        counts = torch.zeros_like(t.class_take).index_add_(0, t.class_of, member.to(torch.int64))
        tally.add_(torch.stack([torch.ones_like(tally[0]), (counts != t.class_take).any().to(torch.int64)]))
        return member

    span_sparse.SpanIndex.draw_members = counting_draw
    try:
        row = converge("partial_index_girg100k", impl, graph, "span_sweep")
    finally:
        span_sparse.SpanIndex.draw_members = draw
    checked, wrong = tally.tolist()
    exact = wrong == 0
    row.update(steps_checked=checked, class_sizes_exact=exact,
               members=int(impl._index.class_take.sum()), n=impl.num_vertices)
    print("partial_index_samples " + json.dumps(dict(steps_checked=checked, exact=exact,
                                                      members_a_step=row["members"])))
    check(exact and checked >= impl.iteration, "partial index: a step's sample sizes are not exact")
    resume = flat_resume("girg100k_half_index", graph, "span_sweep", tmp, make=make)
    return dict(row, resume=resume)


def adam_by_host_scalars(params, grads, m, v, t: int, hp):
    """The Adam update as the port computed it before its step scalars
    moved to the device: powers of t as host floats in the working dtype
    (so ATen multiplies a CUDA tensor by the reciprocal of each bias
    correction, in the tensor's dtype)."""
    import numpy as np
    import torch

    f = np.float64 if params.dtype == torch.float64 else np.float32
    tf = f(t)
    cooling = np.power(f(hp.cooling_factor), tf)
    m = hp.beta1 * m + (1.0 - hp.beta1) * grads
    v = hp.beta2 * v + (1.0 - hp.beta2) * grads * grads
    m_hat = m / float(f(1.0) - np.power(f(hp.beta1), tf))
    v_hat = v / float(f(1.0) - np.power(f(hp.beta2), tf))
    step = float(cooling * f(hp.learning_rate)) * m_hat / (torch.sqrt(v_hat) + float(f(hp.epsilon)))
    return params + step, m, v


def schedule_against_host_scalars(steps: int = 1000) -> dict:
    """The Adam update with the schedule's device rows against the update
    by host scalars on the card, state carried, t = 1 ... ``steps``, f32
    and f64: bitwise equal at every step."""
    import torch

    from wembed_tpu_torch.core import EmbedderOptions, optim

    out = {}
    for dtype in (torch.float32, torch.float64):
        schedule = optim.Schedule(EmbedderOptions(), dtype, torch.device("cuda"))
        hp = optim.AdamParams(10.0, 0.99)
        gen = torch.Generator(device="cuda").manual_seed(5)
        params = torch.randn((4096, 2), generator=gen, device="cuda", dtype=dtype)
        m = v = torch.zeros_like(params)
        old = (params, m, v)
        first_bad = None
        for t in range(1, steps + 1):
            grads = 3.0 * torch.randn((4096, 2), generator=gen, device="cuda", dtype=dtype)
            params, m, v = optim.adam_update(params, grads, m, v, schedule.at(t), hp)
            old = adam_by_host_scalars(*old[:1], grads, *old[1:], t, hp)
            if first_bad is None and not all(torch.equal(a, b) for a, b in zip((params, m, v), old)):
                first_bad = t
        out[str(dtype).split(".")[1]] = dict(steps=steps, first_step_that_differs=first_bad)
    print("schedule_on_card " + json.dumps(out))
    for name, row in out.items():
        check(row["first_step_that_differs"] is None,
              f"the schedule's {name} update differs from the host-scalar one at t = {row['first_step_that_differs']}")
    return out


def kernels_a_replay(impl, steps: int = 5) -> dict:
    """A ``torch.profiler`` window over ``steps`` replays: each hand kernel
    (and helper) the trace shows, a replay.  The profiler keeps only the
    kernels whose device times, taken onto the host's clock, fall inside
    its window, and loses some near its edges (two dense runs counted 211
    and 206 of 5 x 43).  So the window opens and closes ``EDGE_S`` away
    from the replays, one replay beyond each end is a margin, and the count
    takes the kernels between two marker kernels (``torch.cuda._sleep``'s
    ``spin_kernel``) launched around the ``steps`` replays, in device
    order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = ("fused_dense_kernel", "rows_kernel", "finalize_kernel", "span_sweep_kernel",
             "span_reduce_kernel", "segment_pass_kernel", "segment_pass_general_kernel")

    def step():
        impl._state = impl._step(impl._state)
        impl._state.pos_change.item()

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        step()
        torch.cuda._sleep(1000)
        for _ in range(steps):
            step()
        torch.cuda._sleep(1000)
        step()
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(kernels) if "spin_kernel" in e.name]
    check(len(marks) == 2, f"kernels a replay: {len(marks)} marker kernels in the trace, not 2")
    inside = kernels[marks[0] + 1:marks[1]]
    counts = {name: sum(f"{name}<" in e.name for e in inside) / steps for name in names}
    return dict(counts, all_kernels=len(inside) / steps)


def step_graph_runs(graph10k, graph100k) -> dict:
    """Phase 10b: the captured step (``core/step.py:StepGraph``).  girg10k
    (dense), girg100k (span) and girg100k with ``index_size=0.5`` (the
    registered generator's draws), each GRAPH_STEPS steps from seed 1 with
    the step replayed from CUDA graphs and with it run eagerly: state
    bitwise equal, the same iterations, overflow and window changes, and
    on the span runs at least one window change, which the captured step
    survives (one capture a run); host ms a step of both modes (the whole
    run, and STEPS_TIMED further steps each ending in its
    synchronisation), and from a profiler window each kernel a replay
    (one sweep and one reduction, or one dense kernel)."""
    import torch

    from wembed_tpu_torch import api
    from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder

    rows = {}
    for name, graph, options, kernel in (
        ("girg10k_dense", graph10k, dict(), "fused_dense"),
        ("girg100k_span", graph100k, dict(), "span_sweep"),
        ("girg100k_partial_index", graph100k, dict(index_size=0.5), "span_sweep"),
    ):
        runs = {}
        for mode in ("graphed", "eager"):
            api.setSeed(1)
            impl = WEmbedEmbedder(graph.csr, EmbedderOptions(embedding_dimension=2, **options), verbose=False)
            if mode == "eager":
                impl._replays = lambda: False
            swaps = []
            swap = impl._swap_index
            impl._swap_index = lambda index, swap=swap: (swaps.append(index.w), swap(index))
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            impl.calculate_embedding(max_iterations=GRAPH_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            state = {k: getattr(impl.state, k).clone() for k in STATE_TENSORS + ("num_rep_forces", "overflow")}
            step_ms = []
            for _ in range(STEPS_TIMED):
                t1 = time.perf_counter()
                impl._state = impl._step(impl._state)
                impl._state.pos_change.item()
                step_ms.append((time.perf_counter() - t1) * 1000.0)
            runs[mode] = dict(
                iterations=impl.iteration - STEPS_TIMED, wall_s=wall, run_ms_a_step=wall * 1000.0 / GRAPH_STEPS,
                step_ms=sorted(step_ms)[len(step_ms) // 2], launches=launches[kernel], window_changes=len(swaps),
                captures=impl._step_graph.captures if impl._step_graph is not None else 0,
                state=state, impl=impl,
            )
        graphed, eager = runs["graphed"], runs["eager"]
        same = all(torch.equal(graphed["state"][k], eager["state"][k]) for k in graphed["state"])
        replay = kernels_a_replay(graphed["impl"])
        row = dict(
            steps=GRAPH_STEPS, bitwise_equal=same,
            **{f"{k}_{m}": runs[m][k] for k in ("iterations", "wall_s", "run_ms_a_step", "step_ms", "launches",
                                                "window_changes", "captures") for m in ("graphed", "eager")},
            kernels_a_replay=replay,
        )
        print(f"step_graph_{name} " + json.dumps(row))
        check(same, f"step graph {name}: graphed and eager states differ after {GRAPH_STEPS} steps")
        check(row["iterations_graphed"] == row["iterations_eager"] == GRAPH_STEPS,
              f"step graph {name}: iterations {row['iterations_graphed']} / {row['iterations_eager']}")
        check(row["launches_graphed"] == row["launches_eager"] == GRAPH_STEPS,
              f"step graph {name}: launches {row['launches_graphed']} / {row['launches_eager']}")
        check(row["window_changes_graphed"] == row["window_changes_eager"],
              f"step graph {name}: window changes differ")
        check(row["captures_eager"] == 0 and row["captures_graphed"] == 1, f"step graph {name}: captures")
        if kernel == "span_sweep":
            check(row["window_changes_graphed"] >= 1,
                  f"step graph {name}: no window change in {GRAPH_STEPS} steps")
            check(replay["span_sweep_kernel"] == replay["span_reduce_kernel"] == 1
                  and replay["segment_pass_kernel"] == 1 and replay["segment_pass_general_kernel"] == 0,
                  f"step graph {name}: {replay} a replay")
        else:
            check(replay["fused_dense_kernel"] == 1, f"step graph {name}: {replay} a replay")
        del graphed["impl"], eager["impl"]
        rows[name] = row
    return rows


def replicated_one_rank(graph, kernel: str, single: dict, name: str) -> dict:
    """The API with ``distributedMode="replicated"`` on a one-rank NCCL
    group, seed 1, to convergence: bitwise the single-device run
    ``single`` (positions, losses, iterations, growth events, launches)."""
    import numpy as np
    import torch

    from wembed_tpu_torch import api

    api.setSeed(1)
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2, distributedMode="replicated"))
    impl = embedder.impl
    wall, launches = continue_run(impl)
    loss = embedder.getLoss()
    coords = impl.get_coordinates()
    row = dict(
        graph=name, ranks=impl.mesh.size, backend=impl.mesh.backend, iterations=impl.iteration,
        launches=launches, growth_events=impl.growth_events, total_loss=loss.total, wall_s=wall,
        single_wall_s=single["wall_s"],
        bitwise_equal=bool(np.array_equal(coords, single["coords"]))
        and (loss.attractive, loss.repulsive) == single["losses"],
    )
    print(f"replicated_{name} " + json.dumps(row))
    check(type(impl).__name__ == "MultiChipEmbedder" and impl.mesh.size == 1, f"{name}: not one replicated rank")
    check(row["bitwise_equal"], f"replicated {name}: the run differs from the single-device run")
    check(impl.iteration == single["iterations"] and launches[kernel] == single["launches"],
          f"replicated {name}: {impl.iteration} iterations, {launches[kernel]} launches")
    check(impl.growth_events == single["growth_events"], f"replicated {name}: growth events differ")
    torch.cuda.synchronize()
    return row


def replicated_layered(graph, single: dict) -> dict:
    """The layered API run with ``distributedMode="replicated"`` on one
    rank: the same layers, iterations and launches as the single-device
    layered run, and its MAP."""
    import dataclasses

    from wembed_tpu_torch import api

    api.setSeed(1)
    embedder = api.createEmbedder(
        graph, api.Options(embeddingDimension=2, layeredEmbedding=True, distributedMode="replicated")
    )
    wall, launches = continue_run(embedder.impl)
    impl = embedder.impl
    layers = [(r.n, r.path, r.iterations, r.launches, r.growth_events) for r in impl.layer_records]
    for r in impl.layer_records:
        print("layer_replicated " + json.dumps(dataclasses.asdict(r)))
    row = dict(layers=len(layers), iterations=impl.iteration, launches=launches, wall_s=wall,
               replicated_layer_n=[r.n for r in impl.layer_records if r.n >= 4096],
               MAP=map_only(graph.csr, impl.get_coordinates(), impl.get_weights()),
               single_MAP=single["MAP"])
    print("replicated_layered " + json.dumps(row))
    check(layers == single["layers"], "replicated layered: the layer records differ")
    check(type(impl._current).__name__ == "MultiChipEmbedder", "replicated layered: the finest layer is not replicated")
    check(row["MAP"] == single["MAP"], f"replicated layered: MAP {row['MAP']} != {single['MAP']}")
    return dict(row, launches=launches)


def replicated_cli(single_csv: str, tmp: Path) -> dict:
    """``embed --distributed replicated`` under ``torch.distributed.run``
    with one rank writes the single-device CLI's CSV."""
    out = tmp / "girg10k_replicated.csv"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "wembed_tpu_torch.cli.embed", "-i", str(GIRG10K), "-o", str(out), "--seed", "1",
         "--dim", "2", "--distributed", "replicated"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"replicated CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    same = out.exists() and out.read_text() == single_csv
    row = dict(ranks=1, wall_s=wall, rows=len(out.read_text().splitlines()) if out.exists() else 0, same_csv=same)
    print("replicated_cli " + json.dumps(row))
    check(same, "replicated CLI: the CSV differs from the single-device CLI's")
    return row


def first_step_single(graph) -> list:
    """The reduced force pass of the first step of a single-device API run
    (seed 1, d=2): the whole pass, as a one-rank share that records it."""
    from wembed_tpu_torch import api
    from wembed_tpu_torch.core.step import Share

    recorded = []

    def record(*parts):
        recorded.append([None if t is None else t.detach().cpu() for t in parts])
        return parts

    api.setSeed(1)
    impl = api.createEmbedder(graph, api.Options(embeddingDimension=2)).impl
    impl._share = Share(0, 1, record)
    impl.calculate_step()
    return recorded[0]


def recording_halo():
    """``HaloEmbedder`` keeping its first force pass (this rank's force and
    coincident counts of its rows, its partial losses and count, the
    overflow) on the host."""
    from wembed_tpu_torch.distributed import HaloEmbedder

    class RecordingHalo(HaloEmbedder):
        first = None

        def _force_pass(self, state):
            out = super()._force_pass(state)
            if self.first is None:
                self.first = [t.detach().cpu() for t in out]
            return out

    return RecordingHalo


def two_rank_job(mesh, paths: list[str]) -> list[dict]:
    """One rank of ``two_ranks_one_card``, for each graph: a replicated
    run to convergence (``distributed/launch.py:run_replicated``, seed 1,
    d=2), then REDUCE_STEPS steps from seed 1 again with every reduction
    timed on the host clock between two synchronisations (which slows that
    run, hence a run of its own) and the first reduced force pass kept;
    then a halo run to convergence (``run_halo``) and a halo step from seed
    1 that keeps its first force pass.  Each run's peak device memory is
    this rank's, from a reset just before it."""
    import torch

    from wembed_tpu_torch.core import EmbedderOptions
    from wembed_tpu_torch.distributed import MultiChipEmbedder
    from wembed_tpu_torch.distributed.launch import run_halo, run_replicated
    from wembed_tpu_torch.graphs import io
    from wembed_tpu_torch.utils import set_seed

    class TimedReduce(MultiChipEmbedder):
        def __init__(self, *args, **kw):
            self.reduce_s, self.first = 0.0, None
            super().__init__(*args, **kw)

        def _reduce(self, *parts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._reduce(*parts)
            torch.cuda.synchronize()
            self.reduce_s += time.perf_counter() - t0
            if self.first is None:
                self.first = [None if t is None else t.cpu().numpy() for t in out]
            return out

    def peak_run(run):
        gc.collect()  # the last run's embedder, if a reference cycle holds it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (res,) = run(mesh, [dict(graph_path=path, options=opts, seed=1, steps=None)])
        return dict(res, peak_mem_bytes=torch.cuda.max_memory_allocated())

    opts = EmbedderOptions(embedding_dimension=2)
    costs = collective_costs(mesh)
    results = []
    for path in paths:
        res = peak_run(run_replicated)
        set_seed(1)
        emb = TimedReduce(io.read_edge_list(path), opts, mesh=mesh, verbose=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REDUCE_STEPS):
            emb.calculate_step()
        torch.cuda.synchronize()
        loop = time.perf_counter() - t0
        reduce_share, first = emb.reduce_s / loop, emb.first
        del emb
        t0 = time.perf_counter()
        halo = peak_run(run_halo)
        set_seed(1)
        rec = recording_halo()(io.read_edge_list(path), opts, mesh=mesh, verbose=False)
        rec.calculate_step()
        halo.update(first=[t.numpy() for t in rec.first], rows=rec.plan.R,
                    phase_s=time.perf_counter() - t0, collectives=costs)
        del rec
        results.append(dict(res, reduce_share=reduce_share, first=first,
                            timed_step_ms=loop * 1000.0 / REDUCE_STEPS, halo=halo))
    return results


def two_ranks_one_card(graphs: dict, references: dict) -> dict:
    """girg10k and girg100k d=2 on two ranks sharing the card over gloo,
    to convergence (``two_rank_job``), on the replicated backend: each
    rank's share and launches, the step time of the plain run and the
    all-reduce's share of the timed one, the first step's reduced force
    against the single-device step from the same state, positions
    identical across the ranks, the loss limit, overflow 0 and the MAP
    floors; and on the halo backend: the same limits, the ranks' gathered
    positions identical, the first step's forces of the ranks' rows against
    the single-device step, its counts exact; each rank's peak memory on
    both backends."""
    import numpy as np
    import torch

    from wembed_tpu_torch.distributed import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(two_rank_job, 2, backend="gloo", device="cuda",
                      args=([str(path) for path in graphs.values()],))
    wall = time.perf_counter() - t0
    out = {}
    for j, (name, path) in enumerate(graphs.items()):
        res = [r[j] for r in ranks]
        graph = references[name]["graph"]
        single = first_step_single(graph)
        f_ok, f_err, f_scale = forces_agree(torch.as_tensor(res[0]["first"][0]), single[0])
        counts_equal = (int(res[0]["first"][4]) == int(single[4])
                        and bool(np.array_equal(res[0]["first"][1], single[1].numpy())))
        ref_total = references[name]["ref_total"]
        row = dict(
            graph=name, ranks=2, backend="gloo", wall_s=wall,
            shares=[r["shares"] for r in res], launches=[r["launches"] for r in res],
            iterations=[r["iterations"] for r in res], loop_s=[r["seconds"] for r in res],
            step_ms=res[0]["seconds"] * 1000.0 / res[0]["iterations"],
            timed_step_ms=[r["timed_step_ms"] for r in res],
            all_reduce_share=[r["reduce_share"] for r in res],
            total_loss=res[0]["attract_loss"] + res[0]["repel_loss"], reference_total_loss=ref_total,
            final_overflow=[r["overflow"] for r in res], growth_events=[r["growth_events"] for r in res],
            first_step=dict(max_abs_err=f_err, max_abs_force=f_scale, counts_equal=counts_equal),
            ranks_identical=bool(np.array_equal(res[0]["positions"], res[1]["positions"])),
            peak_mem_bytes=[r["peak_mem_bytes"] for r in res],
        )
        row["MAP"] = map_only(graph.csr, res[0]["positions"], res[0]["weights"])
        print("two_ranks_" + name + " " + json.dumps(row))
        kernel = "fused_dense" if res[0]["path"] == "dense" else "span_sweep"
        for r in res:
            check(r["launches"][kernel] == r["iterations"] > 0, f"two ranks {name}: launches {r['launches']}")
            check(r["overflow"] == 0, f"two ranks {name}: final overflow {r['overflow']}")
            check(r["iterations"] < 1000, f"two ranks {name}: {r['iterations']} iterations")
        check(f_ok and counts_equal, f"two ranks {name}: the first step's reduced force differs by {f_err}")
        check(row["ranks_identical"], f"two ranks {name}: the ranks' positions differ")
        check(row["total_loss"] <= LOSS_FACTOR * ref_total, f"two ranks {name}: total loss {row['total_loss']}")
        check(row["MAP"] >= references[name]["map_floor"], f"two ranks {name}: MAP {row['MAP']}")
        out[name] = row
        out["halo_" + name] = two_halo_ranks(name, [r["halo"] for r in res], single, references[name], wall)
    return out


def two_halo_ranks(name: str, res: list, single: list, reference: dict, wall: float) -> dict:
    """The checks of the halo runs of ``two_ranks_one_card`` on one graph."""
    import numpy as np
    import torch

    graph = reference["graph"]
    n = graph.getNumVertices()
    force = torch.cat([torch.as_tensor(r["first"][0]) for r in res])[:n]
    zero = np.concatenate([r["first"][1] for r in res])[:n]
    f_ok, f_err, f_scale = forces_agree(force, single[0])
    count = sum(int(r["first"][4]) for r in res)
    counts_equal = count == int(single[4]) and bool(np.array_equal(zero, single[1].numpy()))
    row = dict(
        graph=name, ranks=2, backend="gloo", rows=[r["rows"] for r in res],
        held=[r["held"] for r in res], launches=[r["launches"] for r in res],
        iterations=[r["iterations"] for r in res], loop_s=[r["seconds"] for r in res],
        step_ms=res[0]["seconds"] * 1000.0 / res[0]["iterations"],
        total_loss=res[0]["attract_loss"] + res[0]["repel_loss"],
        reference_total_loss=reference["ref_total"],
        final_overflow=[r["overflow"] for r in res], growth_events=[r["growth_events"] for r in res],
        first_step=dict(max_abs_err=f_err, max_abs_force=f_scale, rep_count=[count, int(single[4])],
                        counts_equal=counts_equal),
        ranks_identical=bool(np.array_equal(res[0]["positions"], res[1]["positions"])),
        peak_mem_bytes=[r["peak_mem_bytes"] for r in res],
        halo_s=[r["phase_s"] for r in res], spawn_wall_s=wall,
        collectives=[r["collectives"] for r in res],
    )
    row["MAP"] = map_only(graph.csr, res[0]["positions"], res[0]["weights"])
    print("two_halo_ranks_" + name + " " + json.dumps(row))
    kernel = "fused_dense" if res[0]["path"] == "dense" else "span_sweep"
    for r in res:
        check(r["launches"][kernel] == r["iterations"] > 0, f"two halo ranks {name}: launches {r['launches']}")
        check(r["overflow"] == 0, f"two halo ranks {name}: final overflow {r['overflow']}")
        check(r["iterations"] < 1000, f"two halo ranks {name}: {r['iterations']} iterations")
        check(r["held"]["rows"][0] == -(-n // 2), f"two halo ranks {name}: a rank holds {r['held']['rows']} rows")
    check(counts_equal, f"two halo ranks {name}: first-step counts {count} != {int(single[4])}")
    check(f_ok, f"two halo ranks {name}: the first step's force differs by {f_err}")
    check(row["ranks_identical"], f"two halo ranks {name}: the gathered positions differ")
    check(row["total_loss"] <= LOSS_FACTOR * reference["ref_total"], f"two halo ranks {name}: total loss {row['total_loss']}")
    check(row["MAP"] >= reference["map_floor"], f"two halo ranks {name}: MAP {row['MAP']}")
    return row


def halo_one_rank(graph, kernel: str, name: str, single: dict, reference: dict, **options) -> dict:
    """The API with ``distributedMode="halo"`` on the one-rank NCCL group,
    seed 1, to convergence (``options``: EmbedderOptions fields, which the
    API does not set, build the ``HaloEmbedder`` directly): the flat limits
    (below 1000 iterations, overflow 0, the loss limit, the MAP floor), one
    launch a step, finite state; beside the single-device run ``single``."""
    import dataclasses

    import torch

    from wembed_tpu_torch import api
    from wembed_tpu_torch.distributed import HaloEmbedder

    gc.collect()  # earlier embedders that reference cycles hold
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    api.setSeed(1)
    if options:
        opts = dataclasses.replace(api._translate_options(api.Options(embeddingDimension=2)), **options)
        impl = HaloEmbedder(graph.csr, opts, verbose=False)
    else:
        impl = api.createEmbedder(graph, api.Options(embeddingDimension=2, distributedMode="halo")).impl
    wall, launches = continue_run(impl)
    loss = impl.get_loss()
    coords = impl.get_coordinates()
    row = dict(
        graph=name, options=options, ranks=impl.mesh.size, backend=impl.mesh.backend, path=impl.path,
        iterations=impl.iteration, launches=launches, growth_events=impl.growth_events,
        final_overflow=impl.final_overflow, total_loss=loss.total,
        reference_total_loss=reference["ref_total"], wall_s=wall,
        step_ms=wall * 1000.0 / max(impl.iteration, 1), peak_mem_bytes=torch.cuda.max_memory_allocated(),
        single_wall_s=single["wall_s"], single_iterations=single["iterations"],
        MAP=map_only(graph.csr, coords, impl.get_weights()),
    )
    print(f"halo_{name} " + json.dumps(row))
    check(isinstance(impl, HaloEmbedder) and impl.mesh.size == 1, f"halo {name}: not one halo rank")
    check(0 < impl.iteration < 1000, f"halo {name}: {impl.iteration} iterations")
    check(impl.final_overflow == 0, f"halo {name}: final overflow {impl.final_overflow}")
    check(launches[kernel] == impl.iteration, f"halo {name}: {launches[kernel]} launches for {impl.iteration} steps")
    check_finite(impl.state, f"in halo {name}")
    check(loss.total <= LOSS_FACTOR * reference["ref_total"], f"halo {name}: total loss {loss.total}")
    check(row["MAP"] >= reference["map_floor"], f"halo {name}: MAP {row['MAP']}")
    return dict(row, impl=impl, coords=coords, losses=(loss.attractive, loss.repulsive))


def collective_costs(mesh, rows: int = 99825) -> dict:
    """Milliseconds a call of each collective of the halo step at the sizes
    of girg100k's (host clock, synchronised after every call, mean of 20
    after one warm-up); and the host milliseconds an all-reduce takes to
    return behind ~50 ms of queued device work (``torch.cuda._sleep``),
    beside that work's: equal when the collective waits for the device."""
    import torch

    dev, size = mesh.device, mesh.size
    per = -(-rows // size)
    f64 = dict(dtype=torch.float64, device=dev)
    calls = dict(
        all_to_all=lambda: mesh.all_to_all(torch.zeros((size, 64, 2), device=dev)),
        all_gather=lambda: mesh.all_gather(torch.zeros((per, 2), device=dev)),
        reduce_scatter=lambda: mesh.reduce_scatter(torch.zeros((per * size, 3), **f64)),
        all_reduce=lambda: mesh.all_reduce(torch.zeros(5, **f64)),
    )
    out = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
            torch.cuda.synchronize()
        out[name + "_ms"] = (time.perf_counter() - t0) * 50.0
    x = torch.zeros(5, **f64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(100_000_000)
    mesh.all_reduce(x)
    out["all_reduce_behind_sleep_host_ms"] = (time.perf_counter() - t0) * 1000.0
    torch.cuda.synchronize()
    out["sleep_ms"] = (time.perf_counter() - t0) * 1000.0
    return out


def halo_first_step(graph, name: str) -> dict:
    """The first force pass of a one-rank halo embedder (seed 1, d=2)
    against the single-device step's from the same state: forces within
    f32 tolerance, counts exact."""
    import numpy as np

    from wembed_tpu_torch import api

    single = first_step_single(graph)
    api.setSeed(1)
    rec = recording_halo()(graph.csr, api._translate_options(api.Options(embeddingDimension=2)), verbose=False)
    rec.calculate_step()
    force, zero, att, rep, count, _ = rec.first
    f_ok, f_err, f_scale = forces_agree(force[: graph.getNumVertices()], single[0])
    row = dict(graph=name, max_abs_err=f_err, max_abs_force=f_scale, rep_count=[int(count), int(single[4])],
               zero_counts_equal=bool(np.array_equal(zero.numpy(), single[1].numpy())),
               att_loss=[float(att), float(single[2])], rep_loss=[float(rep), float(single[3])])
    print("halo_first_step " + json.dumps(row))
    check(f_ok, f"halo first step {name}: forces differ by up to {f_err}")
    check(int(count) == int(single[4]) and row["zero_counts_equal"], f"halo first step {name}: counts differ")
    check(losses_agree(float(att), float(single[2]), rec.state.positions.dtype), f"halo first step {name}: att loss")
    return row


def resident_sweeps(impl) -> dict:
    """At a halo embedder's positions, the sweep of each rank's items of
    its query blocks (``Share.cut(nb)``, P = 2, 4, 8; ``block_items``)
    against the whole sweep from the same structures: bitwise on those
    blocks' slots, zero on the others."""
    import torch

    from wembed_tpu_torch.core.step import Share
    from wembed_tpu_torch.kernels import span_sparse, span_sweep

    s = impl._span_structures()
    idx = impl._index
    t = idx.tensors(impl.device)
    kw = dict(dim=idx.d, L=impl.opts.edge_length, rep_scale=impl.opts.repulsion_scale,
              additive=impl.opts.additive_weights)
    whole = span_sweep.span_sweep(s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off,
                                  items=impl._items, **kw)
    q = span_sweep.Q
    # the JAX package's resident layout would gather ceil(W / P) tiles of 256
    # member rows a rank every step; the port keeps the NPA member records
    row = dict(nb=idx.nb, work_tiles=idx.w, items=int(impl._items.shape[0]), npa=idx.npa,
               compact_rows_a_rank={p: -(-idx.w // p) * span_sweep.ST for p in (1, 2, 4, 8)},
               partitions={})
    for ranks in (2, 4, 8):
        equal, tiles = True, []
        for rank in range(ranks):
            b0, b1 = Share(rank, ranks, None).cut(idx.nb)
            lo, hi = span_sparse.block_items(idx, b0, b1)
            items = impl._items[lo:hi]
            part = span_sweep.span_sweep(s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off,
                                         items=items, **kw)
            equal &= all(bool(torch.equal(p[b0 * q : b1 * q], w[b0 * q : b1 * q]))
                         and not p[: b0 * q].any() and not p[b1 * q :].any() for p, w in zip(part, whole))
            tiles.append(int(items[:, 3].sum()))
        row["partitions"][ranks] = dict(bitwise_equal=equal, tiles_a_rank=tiles)
        check(equal, f"resident sweep of {ranks} ranks differs from the whole sweep")
    print("halo_resident_sweeps " + json.dumps(row))
    return row


def halo_layered(graph, single_map: float) -> dict:
    """The layered API run with ``distributedMode="halo"`` on one rank,
    girg100k: every layer below 1000 iterations with overflow 0, the
    finest layer on the halo backend, MAP at least 0.74."""
    import dataclasses

    from wembed_tpu_torch import api

    api.setSeed(1)
    embedder = api.createEmbedder(
        graph, api.Options(embeddingDimension=2, layeredEmbedding=True, distributedMode="halo")
    )
    wall, launches = continue_run(embedder.impl)
    impl = embedder.impl
    for r in impl.layer_records:
        print("layer_halo " + json.dumps(dataclasses.asdict(r)))
    row = dict(layers=len(impl.layer_records), iterations=impl.iteration, launches=launches, wall_s=wall,
               halo_layer_n=[r.n for r in impl.layer_records if r.n >= 4096],
               MAP=map_only(graph.csr, impl.get_coordinates(), impl.get_weights()), single_MAP=single_map)
    print("halo_layered " + json.dumps(row))
    check(type(impl._current).__name__ == "HaloEmbedder", "halo layered: the finest layer is not halo")
    for r in impl.layer_records:
        check(0 < r.iterations < 1000 and r.final_overflow == 0, f"halo layered: layer n={r.n}")
    target = MAP_FACTOR * MAP_LAYERED_TARGET
    check(row["MAP"] >= target, f"halo layered MAP {row['MAP']} < {target}")
    return row


def halo_cli(tmp: Path) -> dict:
    """``embed --distributed halo`` under ``torch.distributed.run`` with one
    rank: 10,000 finite rows and the flat girg10k MAP floor."""
    import numpy as np

    from wembed_tpu_torch import api

    out = tmp / "girg10k_halo.csv"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "wembed_tpu_torch.cli.embed", "-i", str(GIRG10K), "-o", str(out), "--seed", "1",
         "--dim", "2", "--distributed", "halo"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"halo CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    rows = np.loadtxt(out, delimiter=",")
    graph = api.graphFromEdgeListFile(str(GIRG10K))
    row = dict(ranks=1, wall_s=wall, rows=int(rows.shape[0]), finite=bool(np.isfinite(rows).all()),
               MAP=map_only(graph.csr, rows[:, 1:3], rows[:, 3]))
    print("halo_cli " + json.dumps(row))
    check(row["rows"] == 10000 and row["finite"], f"halo CLI: {row['rows']} rows, finite {row['finite']}")
    check(row["MAP"] >= MAP_FLAT_GIRG10K, f"halo CLI: MAP {row['MAP']}")
    return row


def parser_times() -> dict:
    """girg100k's edge list through the native parser and the Python loop:
    equal pairs, both times (host clock, best of 3 for the parser)."""
    import numpy as np

    from wembed_tpu_torch.graphs import io

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        native = io._read_pairs_native(str(GIRG100K), "#")
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    loop = io._read_pairs_python(str(GIRG100K), "#", None)
    loop_s = time.perf_counter() - t0
    row = dict(file_bytes=GIRG100K.stat().st_size, pairs=int(native.shape[0]), native_s=min(times),
               python_s=loop_s, equal=bool(np.array_equal(native, loop)))
    print("parser_girg100k " + json.dumps(row))
    check(row["equal"], "the native parser's pairs differ from the Python loop's")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only", file=sys.stderr)
        return 1

    # ---- phase 1: the card; girg100k starts generating in the background
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(card_line())
    kind = torch.cuda.get_device_name(0)
    generators = {path: start_graph(path, flags, md5) for path, flags, md5 in (
        (GIRG100K, GIRG100K_FLAGS, GIRG100K_MD5), (GIRG100K_D4, GIRG100K_D4_FLAGS, GIRG100K_D4_MD5))}
    try:
        return run_phases(kind, generators)
    finally:
        for proc, _ in generators.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        mesh = sys.modules.get("wembed_tpu_torch.distributed.mesh")
        if mesh is not None:
            mesh.shutdown()  # the one-rank NCCL group of the replicated phases


def run_phases(kind, generators: dict) -> int:
    import numpy as np
    import torch

    from wembed_tpu_torch import api
    from wembed_tpu_torch.kernels import _build, edge_pass, fused_dense, span_sweep

    # ---- phase 2: build, one compiler per source, all started together;
    # compiled even where a library of the same sources exists (a benchmark
    # run before in this checkout), for ptxas's report
    sources = KERNELS + HOST_SOURCES
    with ThreadPoolExecutor(len(sources)) as pool:
        infos = dict(zip(sources, pool.map(_build.compile_library, sources)))
    for name, info in infos.items():
        print(f"build {name}: {info.seconds:.3f} s -> {info.path.name}")
        for line in info.log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print("  " + line.strip())
    check_no_spills("fused_dense", infos["fused_dense"].log, "fused_dense_kernel")
    print("ptxas_span_sweep " + json.dumps(ptxas_usage(infos["span_sweep"].log, "span_sweep_kernel")))
    check_no_spills("span_sweep", infos["span_sweep"].log, "span_sweep_kernel")
    # the reduction: span_reduce_kernel<D> at D = 1 ... 8 and
    # span_reduce_general_kernel<T> in f32 and f64, none may spill
    sweep_log = infos["span_sweep"].log
    reduce_ptxas = {
        **{f"span_reduce_kernel<{d}>": v for d, v in ptxas_usage(sweep_log, "span_reduce_kernel").items()},
        **{f"span_reduce_general_kernel<{t}>": v
           for t, v in ptxas_usage(sweep_log, "span_reduce_general_kernel", "I{}E").items()},
    }
    print("ptxas_span_reduce " + json.dumps(reduce_ptxas))
    check(len(reduce_ptxas) == 10 and all(v["spill_stores"] == v["spill_loads"] == 0 for v in reduce_ptxas.values()),
          f"span_sweep: ptxas reports {reduce_ptxas} for the reduction")
    edge_log = infos["edge_pass"].log
    # segment_pass_kernel<T, D, C>, mangled ...segment_pass_kernelI{f,d}Li<D>ELi<C>E...
    print("ptxas_edge_pass " + json.dumps({
        f"{dtype}_{cover}": ptxas_usage(edge_log, f"segment_pass_kernelI{code}", "Li{}ELi" + str(c) + "E")
        for dtype, code in (("f32", "f"), ("f64", "d")) for c, cover in enumerate(("windows", "cells", "attraction"))
    }))
    # every instantiation spill-free: segment_pass_kernel in f32 and f64 at
    # d = 1 ... 8 under each C (48), segment_pass_general_kernel<T, C> in
    # f32 and f64 under each C (6)
    edge_spills = spills(edge_log)
    fast = {k: v for k, v in edge_spills.items() if "segment_pass_kernel" in k}
    general = {k: v for k, v in ptxas_entries(edge_log).items() if k.startswith("segment_pass_general_kernel<")}
    print("ptxas_edge_pass_general " + json.dumps(general))
    check(len(fast) == 48 and all(v == (0, 0) for v in fast.values()),
          f"edge_pass: ptxas reports {len(fast)} segment_pass_kernel entries, spills "
          f"{ {k: v for k, v in fast.items() if v != (0, 0)} }")
    check(len(general) == 6 and all(v["spill_stores"] == v["spill_loads"] == 0 for v in general.values()),
          f"edge_pass: ptxas reports {general} for the general variant")
    # the general kernels: fused_dense_general_kernel<T, RW> (f32 at RW = 8,
    # 4, 2; f64 at 4, 2) and span_sweep_general_kernel<T>; none may spill
    general_ptxas = {
        k: v for k, v in {**ptxas_entries(infos["fused_dense"].log), **ptxas_entries(sweep_log)}.items()
        if k.startswith(("fused_dense_general_kernel", "span_sweep_general_kernel"))
    }
    print("ptxas_general " + json.dumps(general_ptxas))
    check(len(general_ptxas) == 7 and all(v["spill_stores"] == v["spill_loads"] == 0 for v in general_ptxas.values()),
          f"the general kernels: ptxas reports {general_ptxas}")
    # the build's kernels: frame_mean_kernel, frame_axes_kernel and
    # frame_project_kernel <T, D> at D = 1 ... 8 (48), principal_axes_kernel<T, K>
    # (4), span_records_kernel<T, D> at D = 0 ... 8 (18), span_windows_kernel<T>
    # (2); none may spill
    build_ptxas = ptxas_entries(infos["span_build"].log)
    print("ptxas_span_build " + json.dumps(build_ptxas))
    check(len(build_ptxas) == 72 and all(v["spill_stores"] == v["spill_loads"] == 0 for v in build_ptxas.values()),
          f"span_build: ptxas reports {build_ptxas}")

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

    # ---- phase 3b: the general dense kernel (f32 at d > 8, f64) and row ranges
    f64 = torch.float64
    general_dense = {}
    general_rows = []
    for d, dt in GENERAL_CASES:
        dtype = getattr(torch, dt) if dt else None
        label = f"d{d}_{'f64' if dtype else 'f32'}"
        general_rows.append(compare(
            f"n3000_{label}", synthetic_case(3000, d, seed=40 + d, dtype=dtype, spread=0.3), False))
    for d, dtype in ((16, None), (33, None), (2, f64), (16, f64)):
        label = f"d{d}_{'f64' if dtype else 'f32'}"
        general_rows.append(compare(f"n1000_coincident_{label}", synthetic_case(
            1000, d, coincident=True, seed=50 + d, dtype=dtype, spread=0.3), False))
    general_rows.append(compare("n400_d300_f32_crowded", crowd(synthetic_case(400, 300, seed=7, spread=0.3)), False))
    case16 = crowd(girg10k_case(16))
    print("crowd " + json.dumps(dict(case="girg10k_d16_step20", scale=case16["scale"])))
    general_dense["f32_d16"] = compare("girg10k_d16_step20_crowded", case16, timed=True)
    general_dense["f64_d16"] = compare(
        "girg10k_d16_step20_crowded_f64",
        dict(case16, pos=case16["pos"].double(), invw=case16["invw"].double()), timed=False,
    )
    del case16
    case2 = girg10k_case(2, f64)
    general_dense["f64_d2"] = compare("girg10k_d2_step20_f64", case2, timed=True)
    compare_rows("girg10k_d2_f64_rows", case2, (3000, 7000))
    del case2
    compare_rows("girg10k_d2_rows", girg10k_case(), (3000, 7000))
    for row in [*general_rows, *general_dense.values()]:
        check(row["kernel"] == "general", f"{row['case']}: the general kernel did not run")
        check(row["rep_count"][1] > 0, f"{row['case']}: no candidate pairs")

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
    fused_dense.fused_dense_forces.launches_general = 0
    t0 = time.perf_counter()
    embedder.calculateEmbedding()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_dense.fused_dense_forces.launches
    state = embedder.impl.state
    iterations = state.iteration
    loss = embedder.getLoss()
    single_dense = dict(coords=embedder.impl.get_coordinates(), losses=(loss.attractive, loss.repulsive),
                        iterations=iterations, launches=launches, growth_events=0, wall_s=wall)
    main_general = fused_dense.fused_dense_forces.launches_general
    edges_per_s = graph.getNumEdges() * iterations / wall
    print(
        "main_path " + json.dumps(dict(
            graph="girg10k", n=graph.getNumVertices(), m=graph.getNumEdges(), dim=2, seed=1,
            iterations=iterations, launches=launches, launches_general=main_general,
            att_loss=loss.attractive, rep_loss=loss.repulsive, total_loss=loss.total,
            reference_total_loss=ref_total, wall_s=wall, edges_per_s=edges_per_s,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
        ))
    )
    check(0 < iterations < 1000, f"did not converge before the cap ({iterations} iterations)")
    check(launches == iterations, f"{launches} kernel launches for {iterations} iterations")
    check(main_general == 0, f"the main path launched the general dense kernel {main_general} times")
    check_finite(state, "on the dense path")
    check(loss.total <= LOSS_FACTOR * ref_total, f"total loss {loss.total} > {LOSS_FACTOR} x {ref_total}")
    dense_wall, dense_ref_total = wall, ref_total
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
        single_csv = out.read_text() if out.exists() else ""
        rows = single_csv.splitlines()
        print(f"cli: rc 0, {len(rows)} rows, {cli_wall:.3f} s including start-up")
        check(len(rows) == 10000, f"CLI wrote {len(rows)} rows")

    # ---- phase 6: the layered CLIs and reference expansion, girg10k
    with tempfile.TemporaryDirectory() as tmp:
        print("layered_cli " + json.dumps(layered_clis(Path(tmp))))
    reference_expansion_run(graph)

    # ---- phase 7: girg10k resumed from a checkpoint, profiled, and with debug checks
    with tempfile.TemporaryDirectory() as tmp:
        resume_dense = flat_resume("girg10k", graph, "fused_dense", Path(tmp))
    profiled_dense = profiled_run("girg10k", graph, "fused_dense", dense_wall, dense_ref_total)
    debug_checks_run(graph)

    # ---- phase 7b: girg10k at d=16 and in f64 (the general kernels), f64
    # on the card against the CPU, one replicated rank (NCCL) and its CLI
    from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder

    general_runs = {}
    api.setSeed(1)
    general_runs["girg10k_d16"] = converge(
        "girg10k_d16", api.createEmbedder(graph, api.Options(embeddingDimension=16)).impl, graph,
        "fused_dense", below_cap=False,
    )
    api.setSeed(1)
    bucket16 = WEmbedEmbedder(
        graph.csr, EmbedderOptions(embedding_dimension=16, repulsion_mode=RepulsionMode.BUCKET), verbose=False
    )
    general_runs["girg10k_d16_span"] = converge(
        "girg10k_d16_span_20_steps", bucket16, graph, "span_sweep", cap=COMPARE_STEPS
    )
    from wembed_tpu_torch.core import forces

    pos16 = bucket16.state.positions
    scale = crowd_scale(pos16, bucket16._inv_w, bucket16._dg.colors, forces.build_dense_adjacency(bucket16._dg))
    print("crowd " + json.dumps(dict(case="girg10k_d16_span_step20", scale=scale)))
    general_span = {"f32_d16": compare_span("girg10k_d16_span_step20_crowded", sized_span_case(
        (about_centre(pos16, scale), bucket16._inv_w, bucket16._weights, bucket16._dg.colors),
        bucket16._index, bucket16.opts,
    ), timed=True)}
    del bucket16, pos16
    api.setSeed(1)
    general_runs["girg10k_f64"] = converge(
        "girg10k_f64", WEmbedEmbedder(graph.csr, EmbedderOptions(embedding_dimension=2, dtype="float64"),
                                      verbose=False),
        graph, "fused_dense", ref_total=dense_ref_total, map_floor=MAP_FLAT_GIRG10K,
    )
    f64_card_against_cpu()
    for name, run in general_runs.items():
        kernel = "span_sweep" if "span" in name else "fused_dense"
        check(run["launches_general"][kernel] == run["launches"][kernel], f"{name}: not the general kernel")

    # ---- phase 8: girg100k
    graph10k = graph
    gen_seconds = finish_graph(GIRG100K, *generators[GIRG100K])
    md5 = hashlib.md5(GIRG100K.read_bytes()).hexdigest()
    reference = references["girg100k_d2"]
    graph = api.graphFromEdgeListFile(str(GIRG100K))
    n, m = graph.getNumVertices(), graph.getNumEdges()
    print("girg100k " + json.dumps(dict(md5=md5, n=n, m=m, generate_s=gen_seconds)))
    check(md5 == GIRG100K_MD5, f"girg100k md5 {md5} != {GIRG100K_MD5}")
    check((n, m) == (reference["n"], reference["m"]), f"girg100k n={n} m={m}")

    # ---- phase 9: the span sweep kernel against its plain version (and,
    # phase 9d, the structures build's kernels at the start positions)
    api.setSeed(1)
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
    impl = embedder.impl
    build_rows = build_cases_iteration0(impl)
    for _ in range(COMPARE_STEPS):
        embedder.calculateStep()
    st = impl.state
    at20 = (st.positions, impl._inv_w, impl._weights, impl._dg.colors, impl._index, impl.opts)
    case = span_case(*at20)
    girg_span = compare_span("girg100k_d2_step20", case, timed=True)
    print("span_item_sizes " + json.dumps(span_item_sizes(case["args"], case["kw"])))
    del case
    compare_span("girg100k_d2_step20_k1", span_case(*at20, k=1), False)
    # ---- phase 9c: the edge pass kernel against its plain version (d=2 here, d=4 below)
    edge_d2, edge_hub16 = edge_pass_cases_d2(impl)
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
    edge_d4 = compare_edge_pass("girg100k_d4_step20", edge_case(impl), timed=True)
    del embedder, impl, st
    compare_span("n20000_additive_d3", synthetic_span_case(20000, 3, additive=True, seed=5), False)
    compare_span("n20000_bipartite_d2", synthetic_span_case(20000, 2, bipartite=True, seed=6), False)
    coinc = compare_span("n20000_coincident_d4", synthetic_span_case(20000, 4, coincident=True, seed=7), False)
    check(coinc["zero_sum"][0] > 0, "the coincident span case produced no coincident pairs")
    starved = compare_span("n20000_starved_d2", synthetic_span_case(20000, 2, starved=True, seed=8), False)
    check(starved["overflow"] > 0, "the starved case did not truncate its windows")
    for d in (2, 4, 8):  # the prefilter's radius edge, large coordinates, padding records
        adv = compare_span(f"adversarial_d{d}", adversarial_span_case(d, 40 + d), False)
        check(adv["zero_sum"][0] > 0, f"adversarial_d{d}: no coincident candidates")

    # ---- phase 9d: the structures build's kernels on synthetic graphs
    build_rows.update(build_cases_synthetic())
    windows_cases_synthetic()

    # ---- phase 9b: the general sweep (f32 at d > 8, f64)
    for n, d, dt in [(8000, d, dt) for d, dt in GENERAL_CASES] + [(2000, 300, None)]:
        dtype = getattr(torch, dt) if dt else None
        label = f"d{d}_{'f64' if dtype else 'f32'}"
        row = compare_span(f"n{n}_coincident_{label}", synthetic_span_case(
            n, d, coincident=True, seed=60 + d, dtype=dtype, spread=GENERAL_SPAN_SPREAD.get(d, 0.5)), False)
        check(row["kernel"] == "general", f"{row['case']}: the general sweep did not run")
        check(row["max_abs_force"] > 0, f"{row['case']}: no pair repels")

    # ---- phase 9e: the sweep's reduction alone on synthetic scratches
    reduce_cases_synthetic()

    # ---- phase 10: the span main path
    ref_total = reference["att_loss"] + reference["rep_loss"]
    api.setSeed(1)
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
    impl = embedder.impl
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    span_sweep.span_sweep.launches = 0
    span_sweep.span_sweep.launches_general = 0
    span_sweep.span_reduce.launches = 0
    edge_pass.edge_pass.launches = 0
    edge_pass.edge_pass.launches_general = 0
    for wrapper in build_wrappers().values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    embedder.calculateEmbedding()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    span_launches = span_sweep.span_sweep.launches
    reduce_launches = span_sweep.span_reduce.launches
    edge_launches = edge_pass.edge_pass.launches
    build_launches = {name: w.launches for name, w in build_wrappers().items()}
    state = impl.state
    iterations = state.iteration
    loss = embedder.getLoss()
    overflow = int(state.overflow)
    single_span = dict(coords=impl.get_coordinates(), losses=(loss.attractive, loss.repulsive),
                       iterations=iterations, launches=span_launches, growth_events=impl.growth_events,
                       wall_s=wall)
    span_general = span_sweep.span_sweep.launches_general
    print(
        "main_path_span " + json.dumps(dict(
            graph="girg100k", n=n, m=m, dim=2, seed=1, iterations=iterations,
            launches=span_launches, launches_general=span_general, reduce_launches=reduce_launches,
            edge_pass_launches=edge_launches,
            build_launches=build_launches, growth_events=impl.growth_events,
            shrink_events=impl._shrink_events, final_work_tiles=impl._index.w,
            final_overflow=overflow, att_loss=loss.attractive, rep_loss=loss.repulsive,
            total_loss=loss.total, reference_total_loss=ref_total, wall_s=wall,
            edges_per_s=m * iterations / wall,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
        ))
    )
    check(0 < iterations < 1000, f"span path did not converge before the cap ({iterations} iterations)")
    check(span_launches == iterations, f"{span_launches} sweep launches for {iterations} iterations")
    check(span_general == 0, f"the span main path launched the general sweep {span_general} times")
    check(reduce_launches == iterations, f"{reduce_launches} reduction launches for {iterations} iterations")
    check(edge_launches == iterations, f"{edge_launches} edge pass launches for {iterations} iterations")
    check(edge_pass.edge_pass.launches_general == 0, "the span main path ran the edge pass's general variant")
    check(overflow == 0, f"span path ended with overflow {overflow}")
    # one build a step, and one more at each growth event's measurement
    check(build_launches["span_records"] == build_launches["span_windows"] == build_launches["principal_frame"]
          >= iterations and build_launches["principal_axes"] == 0,
          f"build launches {build_launches} for {iterations} iterations")
    check_finite(state, "on the span path")
    check(loss.total <= LOSS_FACTOR * ref_total, f"span total loss {loss.total} > {LOSS_FACTOR} x {ref_total}")
    span_wall = wall
    flat = evaluate_embedding(graph.csr, impl.get_coordinates(), impl.get_weights())
    print("quality_girg100k " + json.dumps(flat))
    map_floor = MAP_FACTOR * reference["map"]
    check(flat["MAP"] >= map_floor, f"girg100k MAP {flat['MAP']} < {map_floor}")
    print("span_breakdown " + json.dumps(span_breakdown(impl)))
    print("profile_span " + json.dumps(profile_steps(impl)))
    edge_d2_converged = edge_pass_converged("girg100k_d2_converged", impl, edge_launches)
    build_rows["girg100k_d2_converged"] = compare_build("girg100k_d2_converged", build_case(
        state.positions, impl._inv_w, impl._weights, impl._dg.colors, impl._index, impl.opts), timed=True)
    build_traces = {"girg100k_d2_converged": build_trace("girg100k_d2_converged", impl)}
    step_launch_account("girg100k_d2_converged", impl)
    reduce_d2 = reduce_converged("girg100k_d2_converged", span_case(
        state.positions, impl._inv_w, impl._weights, impl._dg.colors, impl._index, impl.opts), reduce_launches)
    del embedder, impl, state

    # ---- phase 10c: the same run through the edge pass's plain version
    plain_edge_pass_run(graph, single_span, flat["MAP"])

    # ---- phase 10b: the captured step against the eager one
    t10b = time.perf_counter()
    schedule_against_host_scalars()
    step_graph = step_graph_runs(graph10k, graph)
    print("phase10b " + json.dumps(dict(seconds=time.perf_counter() - t10b)))

    # ---- phase 11: the layered main path, girg100k
    layered = layered_main_path(graph, flat["MAP"])
    pinned_ranking(graph.csr, *layered["embedding"])
    del layered["embedding"]

    # ---- phase 12: girg100k resumed from checkpoints (flat span, layered) and profiled
    with tempfile.TemporaryDirectory() as tmp:
        resume_span = flat_resume("girg100k", graph, "span_sweep", Path(tmp))
        resume_layered = layered_resume(graph, Path(tmp))
    profiled_span = profiled_run("girg100k", graph, "span_sweep", span_wall, ref_total)

    # ---- phase 13: negative sampling, girg100k
    sampled_run(graph)

    # ---- phase 13b: girg100k d=4 under both span layouts
    with tempfile.TemporaryDirectory() as tmp:
        d4 = girg100k_d4(generators, references["girg100k_d4"], Path(tmp))

    # ---- phase 13c: girg100k at d=16 through the API to convergence: the
    # span path through the general sweep and its reduction, the edge
    # pass's general variant and the frame's general route
    t13c = time.perf_counter()
    api.setSeed(1)
    wide = api.createEmbedder(graph, api.Options(embeddingDimension=16))
    general_runs["girg100k_d16_span"] = converge("girg100k_d16_span", wide.impl, graph, "span_sweep")
    wide_run = general_runs["girg100k_d16_span"]
    check(wide_run["path"] == "span" and wide_run["launches_general"]["span_sweep"] == wide_run["launches"]["span_sweep"],
          f"girg100k_d16: not the general sweep: {wide_run['launches_general']}")
    check(wide_run["launches_general"]["edge_pass"] == wide_run["launches"]["edge_pass"] == wide_run["iterations"],
          f"girg100k_d16: not one general edge pass a step: {wide_run['launches']} {wide_run['launches_general']}")
    print("profile_girg100k_d16 " + json.dumps(profile_steps(wide.impl)))
    wi = wide.impl
    general_span["girg100k_d16"] = compare_span("girg100k_d16_converged", span_case(
        wi.state.positions, wi._inv_w, wi._weights, wi._dg.colors, wi._index, wi.opts), timed=True)
    edge_d16_converged = edge_pass_converged("girg100k_d16_converged", wi, wide_run["launches"]["edge_pass"])
    del wide, wi
    print("phase13c " + json.dumps(dict(seconds=time.perf_counter() - t13c, iterations=wide_run["iterations"],
                                        MAP=wide_run["MAP"], step_ms=wide_run["step_ms"],
                                        edge_pass_ms=edge_d16_converged["ms"])))

    # ---- phase 14: girg100k in f64, with a partial index, replicated on
    # one rank (flat and layered), and on two ranks sharing the card
    api.setSeed(1)
    span64 = WEmbedEmbedder(graph.csr, EmbedderOptions(embedding_dimension=2, dtype="float64"), verbose=False)
    for _ in range(COMPARE_STEPS):
        span64.calculate_step()
    st = span64.state
    general_span["f64_d2"] = compare_span("girg100k_d2_step20_f64", span_case(
        st.positions, span64._inv_w, span64._weights, span64._dg.colors, span64._index, span64.opts,
    ), timed=True)
    del st
    general_runs["girg100k_f64"] = converge(
        "girg100k_f64", span64, graph, "span_sweep", ref_total=ref_total, map_floor=map_floor
    )
    del span64
    with tempfile.TemporaryDirectory() as tmp:
        partial = partial_index_run(graph, Path(tmp))
    # the replicated phases last: the one-rank NCCL group lives until exit
    replicated_dense = replicated_one_rank(graph10k, "fused_dense", single_dense, "girg10k")
    with tempfile.TemporaryDirectory() as tmp:
        replicated_cli(single_csv, Path(tmp))
    replicated_span = replicated_one_rank(graph, "span_sweep", single_span, "girg100k")
    replicated_layers = replicated_layered(
        graph, dict(layers=layered["layer_tuples"], MAP=layered["MAP"])
    )
    two_ranks = two_ranks_one_card(
        dict(girg10k=GIRG10K, girg100k=GIRG100K),
        dict(girg10k=dict(graph=graph10k, ref_total=dense_ref_total, map_floor=MAP_FLAT_GIRG10K),
             girg100k=dict(graph=graph, ref_total=ref_total, map_floor=map_floor)),
    )

    # ---- phase 15: the halo backend on the one-rank NCCL group (the two
    # gloo ranks ran in phase 14's spawn), and the native edge-list parser
    t15 = time.perf_counter()
    from wembed_tpu_torch.distributed import make_mesh

    halo_mesh = make_mesh()
    refs = dict(girg10k=dict(ref_total=dense_ref_total, map_floor=MAP_FLAT_GIRG10K),
                girg100k=dict(ref_total=ref_total, map_floor=map_floor))
    halo_dense = halo_one_rank(graph10k, "fused_dense", "girg10k", single_dense, refs["girg10k"])
    print("profile_halo_girg10k " + json.dumps(profile_steps(halo_dense.pop("impl"))))
    halo_first_step(graph10k, "girg10k")
    halo_span = halo_one_rank(graph, "span_sweep", "girg100k", single_span, refs["girg100k"])
    print("profile_halo_girg100k " + json.dumps(profile_steps(halo_span.pop("impl"))))
    halo_first_step(graph, "girg100k")
    halo_res = halo_one_rank(graph, "span_sweep", "girg100k_resident", single_span, refs["girg100k"],
                             halo_resident_structures=True)
    same = bool(np.array_equal(halo_res["coords"], halo_span["coords"])) and (
        halo_res["losses"] == halo_span["losses"])
    print("halo_resident_one_rank " + json.dumps(dict(bitwise_equal_to_halo_run=same)))
    check(same, "resident girg100k on one rank differs from the halo run (the same blocks and items)")
    resident_sweeps(halo_res["impl"])
    del halo_res["impl"]
    for row in (halo_dense, halo_span, halo_res):
        del row["coords"]
    halo_layers = halo_layered(graph, layered["MAP"])
    with tempfile.TemporaryDirectory() as tmp:
        halo_cli(Path(tmp))
    parser_times()
    print("nccl_one_rank_collectives " + json.dumps(collective_costs(halo_mesh)))
    print("phase15 " + json.dumps(dict(seconds=time.perf_counter() - t15,
                                       two_rank_halo_s=two_ranks["halo_girg10k"]["halo_s"]
                                       + two_ranks["halo_girg100k"]["halo_s"])))

    general_total = {k: sum(r["launches_general"][k] for r in general_runs.values())
                     for k in ("fused_dense", "span_sweep")}

    def general_timing(row):
        return {k: row[k] for k in ("case", "max_abs_err", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                    "share") if k in row}

    def general_entry(name, source, replaces, row, launches, **extra):
        """A general kernel's own entry: its device ms a call (traced) at
        ``row``'s case, the plain version's, the bound and the launches of
        the d = 16 and f64 runs."""
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[0], "launches_f64": launches[1], "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "share": row["share"], "case": row["case"], **extra,
            "library_ms": None,  # no PyTorch call computes the masked pass with its tallies
        }

    print(json.dumps({"kernels": [
        {
            "name": "fused_dense_forces",
            "route": "cuda",
            "source": "wembed_tpu_torch/csrc/fused_dense.cu",
            "replaces": "wembed_tpu/kernels/fused_dense.py:192",
            "launches": launches,
            "launches_layered": layered["launches"]["fused_dense"],
            "launches_profiled": profiled_dense["launches"],
            "launches_resumed": resume_dense["launches_after_checkpoint"][1],
            "launches_resumed_layered": resume_layered["launches"]["fused_dense"],
            "launches_general": general_total["fused_dense"],
            "launches_replicated": replicated_dense["launches"]["fused_dense"],
            "launches_replicated_two_ranks": [r["fused_dense"] for r in two_ranks["girg10k"]["launches"]],
            "launches_partial_index": partial["launches"]["fused_dense"],
            "launches_halo": halo_dense["launches"]["fused_dense"],
            "launches_halo_resident": halo_res["launches"]["fused_dense"],
            "launches_halo_layered": halo_layers["launches"]["fused_dense"],
            "launches_halo_two_ranks": [r["fused_dense"] for r in two_ranks["halo_girg10k"]["launches"]],
            "launches_cells": d4["runs"]["cells"]["launches"]["fused_dense"],
            "general": {k: general_timing(v) for k, v in general_dense.items()},
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
            "launches_profiled": profiled_span["launches"],
            "launches_resumed": resume_span["launches_after_checkpoint"][1],
            "launches_resumed_layered": resume_layered["launches"]["span_sweep"],
            "launches_general": general_total["span_sweep"],
            "launches_replicated": replicated_span["launches"]["span_sweep"],
            "launches_replicated_layered": replicated_layers["launches"]["span_sweep"],
            "launches_replicated_two_ranks": [r["span_sweep"] for r in two_ranks["girg100k"]["launches"]],
            "launches_partial_index": partial["launches"]["span_sweep"],
            "launches_halo": halo_span["launches"]["span_sweep"],
            "launches_halo_resident": halo_res["launches"]["span_sweep"],
            "launches_halo_layered": halo_layers["launches"]["span_sweep"],
            "launches_halo_two_ranks": [r["span_sweep"] for r in two_ranks["halo_girg100k"]["launches"]],
            "launches_cells": d4["runs"]["cells"]["launches"]["span_sweep"],
            "launches_windows_d4": d4["runs"]["windows"]["launches"]["span_sweep"],
            "launches_resumed_cells": d4["resume"]["launches_after_checkpoint"],
            "general": {k: general_timing(v) for k, v in general_span.items()},
            "girg100k_d4": {k: general_timing(v) for k, v in d4["sweeps"].items()},
            "prefilter_pass_rate": girg_span["prefilter_pass_rate"],
            "candidate_share": girg_span["candidate_share"],
            "max_abs_err": girg_span["max_abs_err"],
            "ms": girg_span["ms"],
            "plain_ms": girg_span["plain_ms"],
            "bound_ms": girg_span["bound_ms"],
            "bound_by": girg_span["bound_by"],
            "library_ms": None,  # no PyTorch call computes the windowed sweep with its tallies
        },
        {
            "name": "span_reduce",
            "route": "cuda",
            "source": "wembed_tpu_torch/csrc/span_sweep.cu",
            # the sum across grid steps of the sweep's Pallas kernel (_init, span_sparse.py:1340)
            "replaces": "wembed_tpu/kernels/span_sparse.py:1735",
            "launches": reduce_launches,
            "launches_layered": layered["launches"]["span_reduce"],
            "launches_windows_d4": d4["runs"]["windows"]["launches"]["span_reduce"],
            "girg100k_d4": d4["runs"]["windows"]["reduce"],
            "max_abs_err": reduce_d2["max_abs_err"],
            "ms": reduce_d2["ms"],  # device ms a call in a trace of sweep-then-reduce pairs
            "kernel_ms": reduce_d2["kernel_ms"],
            "plain_ms": reduce_d2["plain_ms"],
            "bound_ms": reduce_d2["bound_ms"],
            "bound_by": reduce_d2["bound_by"],
            "library_ms": reduce_d2["library_ms"],  # torch.segment_reduce on the same scratch
        },
        {
            "name": "edge_pass",
            "route": "cuda",
            "source": "wembed_tpu_torch/csrc/edge_pass.cu",
            # no Pallas kernel: the JAX package's span edge pass is plain jnp
            "replaces": "wembed_tpu/kernels/span_sparse.py:2062",
            "launches": edge_launches,
            "launches_windows_d4": d4["runs"]["windows"]["launches"]["edge_pass"],
            "launches_cells": d4["runs"]["cells"]["launches"]["edge_pass"],
            "converged": {"girg100k_d2": edge_d2_converged, "girg100k_d4": d4["runs"]["windows"]["edge_pass"]},
            "girg100k_d2": {mode: general_timing(row) for mode, row in edge_d2.items()},
            "girg100k_d4": {mode: general_timing(row) for mode, row in edge_d4.items()},
            "girg100k_d4_cells": {mode: general_timing(row) for mode, row in d4["edge_cells"].items()},
            "max_abs_err": edge_d2["fused"]["max_abs_err"],
            "ms": edge_d2["fused"]["ms"],
            "plain_ms": edge_d2["fused"]["plain_ms"],
            "bound_ms": edge_d2["fused"]["bound_ms"],
            "bound_by": edge_d2["fused"]["bound_by"],
            "library_ms": None,  # no PyTorch call computes the masked edge pass with its tallies
        },
        {
            "name": "edge_pass_general",
            "route": "cuda",
            "source": "wembed_tpu_torch/csrc/edge_pass.cu",
            # no Pallas kernel: the JAX package's span edge pass is plain jnp
            "replaces": "wembed_tpu/kernels/span_sparse.py:2062",
            "launches": general_runs["girg100k_d16_span"]["launches"]["edge_pass"],
            "launches_girg10k_d16": general_runs["girg10k_d16_span"]["launches"]["edge_pass"],
            "converged": edge_d16_converged,
            "hub_d16": {name: general_timing(rows["fused"]) for name, rows in edge_hub16.items()},
            "max_abs_err": edge_d16_converged["max_abs_err"],
            "ms": edge_d16_converged["ms"],  # graph replays of the fused pass at girg100k d=16 converged
            "plain_ms": edge_d16_converged["plain_ms"],
            "bound_ms": edge_d16_converged["bound_ms"],
            "bound_by": edge_d16_converged["bound_by"],
            "library_ms": None,  # no PyTorch call computes the masked edge pass with its tallies
        },
        general_entry(
            "fused_dense_general", "wembed_tpu_torch/csrc/fused_dense.cu", "wembed_tpu/kernels/fused_dense.py:192",
            general_dense["f32_d16"],
            (general_runs["girg10k_d16"]["launches"]["fused_dense"], general_runs["girg10k_f64"]["launches"]["fused_dense"]),
            f64_d2=general_timing(general_dense["f64_d2"]),
        ),
        general_entry(
            "span_sweep_general", "wembed_tpu_torch/csrc/span_sweep.cu", "wembed_tpu/kernels/span_sparse.py:1735",
            general_span["girg100k_d16"],
            (general_runs["girg100k_d16_span"]["launches"]["span_sweep"], general_runs["girg100k_f64"]["launches"]["span_sweep"]),
            girg10k_d16_crowded=general_timing(general_span["f32_d16"]), f64_d2=general_timing(general_span["f64_d2"]),
            launches_girg10k_d16=general_runs["girg10k_d16_span"]["launches"]["span_sweep"],
        ),
        *build_kernel_entries(build_rows, build_traces, d4, dict(
            flat=build_launches, layered=layered["launches"], profiled=profiled_span["launches_all"],
            resumed=resume_span["launches_resumed"], resumed_layered=resume_layered["launches"],
            partial_index=partial["launches"], f64=general_runs["girg100k_f64"]["launches"],
            d16=general_runs["girg10k_d16_span"]["launches"], windows_d4=d4["runs"]["windows"]["launches"],
            cells_d4=d4["runs"]["cells"]["launches"], replicated=replicated_span["launches"],
            replicated_layered=replicated_layers["launches"], halo=halo_span["launches"],
            halo_resident=halo_res["launches"], halo_layered=halo_layers["launches"],
        )),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
