#!/usr/bin/env python3
"""The sampled path of both packages side by side: negative sampling with
k = 10 negatives a vertex on assets/girg10k.edg, d = 2, seeds 1-4, each run
to convergence (the check of ROADMAP Queue 3, fault 3).

    JAX_PLATFORMS=cpu python baselines/sampled_parity.py --package jax
    python baselines/sampled_parity.py --package port --device cpu
    python baselines/sampled_parity.py --package port --device cuda

Prints one JSON line a seed: iterations, losses, wall seconds and the
reconstruction MAP (1,000 ranked vertices, the evaluator's stream for seed
1, ranked in f64 by the port's evaluator on ``--device``, or on the CPU for
the JAX package's coordinates).  The JAX package is imported only with
``--package jax``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GRAPH = REPO / "assets" / "girg10k.edg"


def run_jax(seed: int, k: int):
    from wembed_tpu.core import EmbedderOptions, WEmbedEmbedder
    from wembed_tpu.graphs import io
    from wembed_tpu.utils import set_seed

    set_seed(seed)
    g = io.read_edge_list(str(GRAPH))
    emb = WEmbedEmbedder(g, EmbedderOptions(embedding_dimension=2, num_negative_samples=k), verbose=False)
    t0 = time.perf_counter()
    emb.calculate_embedding()
    wall = time.perf_counter() - t0
    loss = emb.get_loss()
    return emb.get_coordinates(), emb.get_weights(), emb.iteration, loss.attractive, loss.repulsive, wall


def run_port(seed: int, k: int, device: str):
    import torch

    from wembed_tpu_torch.core import EmbedderOptions, WEmbedEmbedder
    from wembed_tpu_torch.graphs import io
    from wembed_tpu_torch.utils import set_seed

    set_seed(seed)
    g = io.read_edge_list(str(GRAPH))
    emb = WEmbedEmbedder(
        g, EmbedderOptions(embedding_dimension=2, num_negative_samples=k), verbose=False, device=device
    )
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb.calculate_embedding()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = emb.get_loss()
    return emb.get_coordinates(), emb.get_weights(), emb.iteration, loss.attractive, loss.repulsive, wall


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--package", choices=["jax", "port"], required=True)
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    p.add_argument("-k", type=int, default=10)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    if args.package == "port" and args.device == "cpu":
        import torch

        torch.set_num_threads(4)

    from wembed_tpu_torch.eval import reconstruction_metrics
    from wembed_tpu_torch.eval.spaces import WeightedGeometric
    from wembed_tpu_torch.graphs import io

    graph = io.read_edge_list(str(GRAPH))
    rank_device = args.device if args.package == "port" else "cpu"
    for seed in args.seeds:
        if args.package == "jax":
            coords, weights, it, att, rep, wall = run_jax(seed, args.k)
        else:
            coords, weights, it, att, rep, wall = run_port(seed, args.k, args.device)
        quality = reconstruction_metrics(
            graph, WeightedGeometric(np.asarray(coords), weights=np.asarray(weights)), 1000,
            np.random.default_rng(1), device=rank_device,
        )
        print(json.dumps(dict(
            package=args.package, device=args.device if args.package == "port" else "cpu", seed=seed,
            k=args.k, n=graph.num_vertices, iterations=int(it), att_loss=float(att), rep_loss=float(rep),
            total_loss=float(att + rep), wall_s=wall, MAP=quality["MAP"],
            constructDeg=quality["constructDeg"],
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
