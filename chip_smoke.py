#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port, ``wembed_tpu_torch``.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. a CUDA card is present; print torch/CUDA versions, the card's name and
     power limit; start making girg100k (phase 6) in a subprocess;
  2. build the CUDA kernels from ``wembed_tpu_torch/csrc`` (one nvcc per
     source, started together) and print their registers and spills;
  3. hold the fused force kernel against its plain PyTorch version on the
     card: girg10k d=2 with degree weights at positions after 20 steps of
     a seeded run, n = 1100 (a shape whose last columns the TPU kernel's
     grid skips), additive weights, a bipartite colouring and coincident
     points, at d = 2, 3, 4 and 8;
  4. the dense main path: ``wembed_tpu_torch.api``, girg10k, d=2, seed 1,
     ``calculateEmbedding()``, which must converge before 1000 iterations,
     launch the kernel once per iteration, keep every state tensor finite
     and reach a total loss within 1.15x the C++ reference's;
  5. the ``embed`` CLI as a subprocess, which must write a 10,000-row CSV;
  6. girg100k d=2 from the port's ``generate`` CLI (cached in
     ``build/graphs/``), checked by md5 and by n and m against
     ``baselines/reference_measured.json``;
  7. hold the span sweep kernel against its plain version on the card:
     girg100k d=2 at positions after 20 steps of a seeded run (timed), and
     synthetic cases with additive weights at d=3, a bipartite colouring,
     coincident points at d=4 and starved windows;
  8. the span main path: the API on girg100k, d=2, seed 1,
     ``calculateEmbedding()``: below 1000 iterations, one sweep launch per
     iteration, final overflow 0, every state tensor finite, total loss
     within 1.15x the C++ reference's; then a breakdown of a step at the
     converged positions by CUDA events.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
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
REFERENCE = REPO / "baselines" / "reference_measured.json"
KERNELS = ("fused_dense", "span_sweep")
LOSS_FACTOR = 1.15  # total loss may exceed the C++ reference's by at most this
FORCE_RTOL = 1e-5  # summation order differs between the kernel and the plain version
FORCE_ATOL = 1e-5  # times max|force|
LOSS_RTOL = 1e-5
COMPARE_STEPS = 20


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
    adj = np.zeros((n, n), np.uint8)
    if edges:
        src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
        keep = src != dst
        adj[src[keep], dst[keep]] = 1
        adj[dst[keep], src[keep]] = 1
    dev = torch.device("cuda")
    return dict(
        pos=torch.tensor(pos, dtype=torch.float32, device=dev),
        invw=torch.tensor(invw, dtype=torch.float32, device=dev),
        colors=torch.tensor(colors, dtype=torch.int32, device=dev),
        adj=torch.tensor(adj, device=dev),
        additive=additive,
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
        additive=False,
    )


def compare(name: str, case: dict, timed: bool) -> dict:
    """Kernel against the plain version on the same CUDA tensors."""
    import torch

    from wembed_tpu_torch.kernels import fused_dense

    d = case["pos"].shape[1]
    args = (case["pos"], case["invw"], case["colors"], case["adj"])
    kw = dict(dim=d, L=1.0, att_scale=1.0, rep_scale=1.0, additive=case["additive"])
    f_k, z_k, a_k, r_k, c_k = fused_dense.fused_dense_forces(*args, **kw)
    torch.cuda.synchronize()
    f_p, z_p, a_p, r_p, c_p = fused_dense.fused_dense_forces_reference(*args, **kw)
    torch.cuda.synchronize()
    ok_force, err, scale = forces_agree(f_k, f_p)
    row = dict(
        case=name, n=case["pos"].shape[0], d=d,
        rep_count=[int(c_k), int(c_p)], zero_sum=[int(z_k.sum()), int(z_p.sum())],
        att_loss=[float(a_k), float(a_p)], rep_loss=[float(r_k), float(r_p)],
        max_abs_force=scale, max_abs_err=err,
    )
    if timed:
        row["ms"] = cuda_ms(lambda: fused_dense.fused_dense_forces(*args, **kw), 50)
        row["plain_ms"] = cuda_ms(lambda: fused_dense.fused_dense_forces_reference(*args, **kw), 5)
    print("compare " + json.dumps(row))
    check(int(c_k) == int(c_p), f"{name}: rep count {int(c_k)} != {int(c_p)}")
    check(bool(torch.equal(z_k, z_p)), f"{name}: zero counts differ")
    check(ok_force, f"{name}: forces differ by up to {err} (max|force| {scale})")
    for label, k, p in (("att", a_k, a_p), ("rep", r_k, r_p)):
        k, p = float(k), float(p)
        check(abs(k - p) <= LOSS_RTOL * abs(p), f"{name}: {label} loss {k} != {p}")
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


def span_case(positions, inv_w, weights, colors, idx, opts):
    """Inputs of the span sweep at the given CUDA tensors and windows."""
    from wembed_tpu_torch.kernels import span_sparse

    s = span_sparse.build_span_structures(positions, inv_w, weights, colors, idx, opts)
    t = idx.tensors(positions.device)
    return dict(
        args=(s.qrec, s.qcol, s.srec, s.scol, s.blk_t, s.start_tile, t.tile_off),
        kw=dict(dim=idx.d, L=opts.edge_length, rep_scale=opts.repulsion_scale,
                additive=opts.additive_weights),
        n=idx.n, tiles=idx.w, overflow=int(s.overflow),
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
    f_k, l_k, c_k, z_k = span_sweep.span_sweep(*args, **kw)
    torch.cuda.synchronize()
    f_p, l_p, c_p, z_p = span_sweep.span_sweep_reference(*args, **kw)
    torch.cuda.synchronize()
    ok_force, err, scale = forces_agree(f_k, f_p)
    loss_k, loss_p = float(l_k.double().sum()), float(l_p.double().sum())
    row = dict(
        case=name, n=case["n"], d=kw["dim"], work_tiles=case["tiles"], overflow=case["overflow"],
        rep_count=[int(c_k.sum()), int(c_p.sum())], zero_sum=[int(z_k.sum()), int(z_p.sum())],
        rep_loss=[loss_k, loss_p], max_abs_force=scale, max_abs_err=err,
    )
    if timed:
        row["ms"] = cuda_ms(lambda: span_sweep.span_sweep(*args, **kw), 20)
        row["plain_ms"] = cuda_ms(lambda: span_sweep.span_sweep_reference(*args, **kw), 3)
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
        sweep_ms=cuda_ms(lambda: span_sparse._sweep(s, impl._index, impl.opts), 20),
        forces_ms=cuda_ms(lambda: span_sparse.span_fused_forces(*args, gen, structures=s), 20),
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
    parts.update(work_tiles=impl._index.w, blocks=int(block_tiles.shape[0]),
                 max_block_tiles=int(block_tiles.max()), mean_block_tiles=float(block_tiles.mean()))
    return parts


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

    # ---- phase 2: build, one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        infos = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, info in infos.items():
        print(f"build {name}: {info.seconds:.3f} s -> {info.path.name}")
        for line in info.log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print("  " + line.strip())

    # ---- phase 3: the dense kernel against its plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    girg = compare("girg10k_d2_step20", girg10k_case(), timed=True)
    compare("n1100_grid_no_edges", synthetic_case(1100, 2, grid=True, edges=False, seed=1), False)
    compare("n1000_additive_d8", synthetic_case(1000, 8, additive=True, seed=2), False)
    compare("n1000_bipartite_d3", synthetic_case(1000, 3, bipartite=True, seed=3), False)
    coinc = compare("n1000_coincident_d4", synthetic_case(1000, 4, coincident=True, seed=4), False)
    check(coinc["zero_sum"][0] > 0, "the coincident case produced no coincident pairs")

    # ---- phase 4: the dense main path
    references = json.loads(REFERENCE.read_text())["configs"]
    reference = references["girg10k_d2"]
    ref_total = reference["att_loss"] + reference["rep_loss"]
    api.setSeed(1)
    graph = api.graphFromEdgeListFile(str(GIRG10K))
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
    torch.cuda.synchronize()
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
    for name in ("positions", "adam_m", "adam_v", "attract_loss", "repel_loss", "pos_change"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"non-finite {name}")
    check(loss.total <= LOSS_FACTOR * ref_total, f"total loss {loss.total} > {LOSS_FACTOR} x {ref_total}")
    del embedder, state

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

    # ---- phase 6: girg100k
    gen_seconds = finish_girg100k(gen_proc, gen_t0)
    md5 = hashlib.md5(GIRG100K.read_bytes()).hexdigest()
    reference = references["girg100k_d2"]
    graph = api.graphFromEdgeListFile(str(GIRG100K))
    n, m = graph.getNumVertices(), graph.getNumEdges()
    print("girg100k " + json.dumps(dict(md5=md5, n=n, m=m, generate_s=gen_seconds)))
    check(md5 == GIRG100K_MD5, f"girg100k md5 {md5} != {GIRG100K_MD5}")
    check((n, m) == (reference["n"], reference["m"]), f"girg100k n={n} m={m}")

    # ---- phase 7: the span sweep kernel against its plain version
    api.setSeed(1)
    embedder = api.createEmbedder(graph, api.Options(embeddingDimension=2))
    impl = embedder.impl
    for _ in range(COMPARE_STEPS):
        embedder.calculateStep()
    st = impl.state
    girg_span = compare_span(
        "girg100k_d2_step20",
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

    # ---- phase 8: the span main path
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
            launches=span_launches, growth_events=impl._growth_events,
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
    for name in ("positions", "adam_m", "adam_v", "attract_loss", "repel_loss", "pos_change"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"non-finite {name} on the span path")
    check(loss.total <= LOSS_FACTOR * ref_total, f"span total loss {loss.total} > {LOSS_FACTOR} x {ref_total}")
    print("span_breakdown " + json.dumps(span_breakdown(impl)))

    print(json.dumps({"kernels": [
        {
            "name": "fused_dense_forces",
            "route": "cuda",
            "source": "wembed_tpu_torch/csrc/fused_dense.cu",
            "replaces": "wembed_tpu/kernels/fused_dense.py:192",
            "launches": launches,
            "max_abs_err": girg["max_abs_err"],
            "ms": girg["ms"],
            "plain_ms": girg["plain_ms"],
        },
        {
            "name": "span_sweep",
            "route": "cuda",
            "source": "wembed_tpu_torch/csrc/span_sweep.cu",
            "replaces": "wembed_tpu/kernels/span_sparse.py:1735",
            "launches": span_launches,
            "max_abs_err": girg_span["max_abs_err"],
            "ms": girg_span["ms"],
            "plain_ms": girg_span["plain_ms"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
