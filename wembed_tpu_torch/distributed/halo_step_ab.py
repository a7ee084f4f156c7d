"""Two gloo ranks sharing one card on the halo backend: milliseconds a step
of two trees of the port, alternated in one call (A B B A, ROUNDS times).

    python wembed_tpu_torch/distributed/halo_step_ab.py --trees OLD_TREE NEW_TREE \\
        --graphs assets/girg10k.edg build/graphs/girg100k_d2.edg

Run it by path, not with ``-m``: each run is a process of its own that
runs this file with ``PYTHONPATH`` set to one tree (which need not hold
this file) and imports that tree's ``wembed_tpu_torch``; it
spawns two gloo ranks on the card (``distributed.launch.run_ranks``), and
each rank builds a ``HaloEmbedder`` per graph (seed 1, d=2), takes WARM
steps, then STEPS steps between two synchronisations.  A run prints one JSON
line (rank 0's milliseconds a step per graph); the last line holds each
tree's runs and medians.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

WARM = 20
STEPS = 100
ROUNDS = 2


def _job(mesh, graphs: list[str]) -> dict:
    import torch

    from wembed_tpu_torch.core import EmbedderOptions
    from wembed_tpu_torch.distributed import HaloEmbedder
    from wembed_tpu_torch.graphs import io
    from wembed_tpu_torch.utils import set_seed

    out = {}
    for path in graphs:
        set_seed(1)
        emb = HaloEmbedder(io.read_edge_list(path), EmbedderOptions(embedding_dimension=2),
                           mesh=mesh, verbose=False)
        for _ in range(WARM):
            emb.calculate_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            emb.calculate_step()
        torch.cuda.synchronize()
        out[os.path.basename(path)] = (time.perf_counter() - t0) * 1000.0 / STEPS
        del emb
    return out


def _worker(graphs: list[str]) -> None:
    from wembed_tpu_torch.distributed import run_ranks

    ranks = run_ranks(_job, 2, backend="gloo", device="cuda", args=(graphs,))
    print(json.dumps(ranks[0]))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trees", nargs=2, required=True, help="two directories holding wembed_tpu_torch/")
    p.add_argument("--graphs", nargs="+", required=True, help="edge lists")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    graphs = [os.path.abspath(g) for g in args.graphs]
    if args.worker:
        _worker(graphs)
        return 0
    runs = {tree: [] for tree in args.trees}
    a, b = args.trees
    for tree in [a, b, b, a] * ROUNDS:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--trees", a, b, "--graphs", *graphs]
        line = subprocess.run(cmd, env=env, check=True, capture_output=True, text=True).stdout.splitlines()[-1]
        ms = json.loads(line)
        print(json.dumps(dict(tree=tree, step_ms=ms)), flush=True)
        runs[tree].append(ms)
    summary = {
        tree: {g: dict(runs=[r[g] for r in rs], median=statistics.median(r[g] for r in rs)) for g in rs[0]}
        for tree, rs in runs.items()
    }
    print(json.dumps(dict(warm=WARM, steps=STEPS, summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
