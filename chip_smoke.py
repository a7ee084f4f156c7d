#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port, ``wembed_tpu_torch``.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. a CUDA card is present; print torch/CUDA versions, the card's name and
     power limit;
  2. build the CUDA kernels from ``wembed_tpu_torch/csrc`` (nvcc);
  3. hold the fused force kernel against its plain PyTorch version on the
     card: girg10k d=2 with degree weights at positions after 20 steps of
     a seeded run, n = 1100 (a shape whose last columns the TPU kernel's
     grid skips), additive weights, a bipartite colouring and coincident
     points, at d = 2, 3, 4 and 8;
  4. the main path: ``wembed_tpu_torch.api``, girg10k, d=2, seed 1,
     ``calculateEmbedding()``, which must converge before 1000 iterations,
     launch the kernel once per iteration, keep every state tensor finite
     and reach a total loss within 1.15x the C++ reference's;
  5. the ``embed`` CLI as a subprocess, which must write a 10,000-row CSV.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
GIRG10K = REPO / "assets" / "girg10k.edg"
REFERENCE = REPO / "baselines" / "reference_measured.json"
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
    scale = float(f_p.abs().max())
    err = float((f_k - f_p).abs().max())
    bound = float((FORCE_ATOL * scale + FORCE_RTOL * f_p.abs()).min())
    ok_force = bool(torch.all((f_k - f_p).abs() <= FORCE_ATOL * scale + FORCE_RTOL * f_p.abs()))
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
    check(ok_force, f"{name}: forces differ by up to {err} (smallest bound {bound})")
    for label, k, p in (("att", a_k, a_p), ("rep", r_k, r_p)):
        k, p = float(k), float(p)
        check(abs(k - p) <= LOSS_RTOL * abs(p), f"{name}: {label} loss {k} != {p}")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only", file=sys.stderr)
        return 1

    # ---- phase 1: the card
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    kind = torch.cuda.get_device_name(0)

    from wembed_tpu_torch import api
    from wembed_tpu_torch.kernels import _build, fused_dense

    # ---- phase 2: build
    info = _build.build("fused_dense")
    print(f"build fused_dense: {info.seconds:.3f} s -> {info.path.name}")
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  " + line.strip())

    # ---- phase 3: the kernel against its plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    girg = compare("girg10k_d2_step20", girg10k_case(), timed=True)
    compare("n1100_grid_no_edges", synthetic_case(1100, 2, grid=True, edges=False, seed=1), False)
    compare("n1000_additive_d8", synthetic_case(1000, 8, additive=True, seed=2), False)
    compare("n1000_bipartite_d3", synthetic_case(1000, 3, bipartite=True, seed=3), False)
    coinc = compare("n1000_coincident_d4", synthetic_case(1000, 4, coincident=True, seed=4), False)
    check(coinc["zero_sum"][0] > 0, "the coincident case produced no coincident pairs")

    # ---- phase 4: the main path
    reference = json.loads(REFERENCE.read_text())["configs"]["girg10k_d2"]
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

    print(json.dumps({"kernels": [{
        "name": "fused_dense_forces",
        "route": "cuda",
        "source": "wembed_tpu_torch/csrc/fused_dense.cu",
        "replaces": "wembed_tpu/kernels/fused_dense.py:192",
        "launches": launches,
        "max_abs_err": girg["max_abs_err"],
        "ms": girg["ms"],
        "plain_ms": girg["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
