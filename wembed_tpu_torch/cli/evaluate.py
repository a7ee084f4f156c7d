"""wembed-evaluate CLI for the PyTorch/CUDA port — embedding quality metrics
as a CSV row.

Same flags and columns as ``wembed_tpu/cli/evaluate.py``.  The
reconstruction ranking runs on the CUDA device (``eval/device.py``); the
edge-detection sampling on the host.  Column layout and flag surface mirror
the reference's cli_evaluator (reference: src/cli_evaluator/main.cpp:19-123,
Options.hpp:8-49): a header
row of metric names followed by one row of values —
edge-list-path, embedding-path, emb-type, seed, edge-sample-factor,
node-sample-percent, num_nodes, num_edges, [embedding_time,]
constructDeg, MAP, precision, recall, edgeF1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..eval import (
    EmbeddingType,
    edge_detection_metrics,
    parse_embedding,
    reconstruction_metrics,
)
from ..graphs import io
from ..utils import rng as rng_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="wembed-evaluate", description="CLI Evaluator")
    p.add_argument("--header-only", action="store_true",
                   help="Only prints the names of the metrics")
    p.add_argument("-g", "--edge-list", required=True, help="Path to the edge list file")
    p.add_argument("--edge-list-comment", default="#")
    p.add_argument("--edge-list-delimiter", default=" ")
    p.add_argument("-e", "--embedding", required=True, help="Path to the embedding file")
    p.add_argument("--embedding-comment", default="%")
    p.add_argument("--embedding-delimiter", default=",")
    p.add_argument("--emb-type", type=int, default=0,
                   help="Type of the embedding (0=Weighted, 1=Euclidean, "
                   "2=DotProduct, 3=Cosine, 4=Mercator, 5=WeightedNoDim, "
                   "6=WeightedInf, 7=Poincare, 8=InfNorm, 9=Additive)")
    p.add_argument("--lp-norm", type=int, default=2)
    p.add_argument("-t", "--time", default="", help="Path to the time file")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--edge-samples", type=float, default=10.0,
                   help="Factor for how many more non edges get sampled than edges")
    p.add_argument("--node-samples", type=int, default=1000,
                   help="How many nodes are sampled (each node has linear runtime!)")
    p.add_argument("--node-samples-file", default="",
                   help="File with one vertex id per line: pin the exact "
                   "reconstruction sample set (cross-implementation MAP "
                   "comparisons without 1000-sample variance)")
    return p


def main(argv=None, device: torch.device | str = "cuda") -> int:
    """Print the header and the metrics row; ``device`` runs the ranking."""
    args = build_parser().parse_args(argv)
    if args.seed != -1:
        rng_mod.set_seed(args.seed)
    rng = rng_mod.host_rng()

    delim = None if args.edge_list_delimiter in (" ", "\t") else args.edge_list_delimiter
    g = io.read_edge_list(args.edge_list, args.edge_list_comment, delim)
    coords = io.read_coordinates(
        args.embedding, args.embedding_comment, args.embedding_delimiter
    )
    space = parse_embedding(EmbeddingType(args.emb_type), coords, args.lp_norm)

    names = [
        "edge-list-path", "embedding-path", "emb-type", "seed",
        "edge-sample-factor", "node-sample-percent",
        "num_nodes", "num_edges",
    ]
    values = [
        args.edge_list, args.embedding, str(args.emb_type), str(args.seed),
        f"{args.edge_samples:.6f}", str(args.node_samples),
        str(g.num_vertices), str(g.num_edges),
    ]
    if args.time:
        with open(args.time) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        names.append("embedding_time")
        values.append(lines[0] if lines else "")

    names += ["constructDeg", "MAP", "precision", "recall", "edgeF1"]
    print(",".join(names))
    if args.header_only:
        return 0

    node_ids = None
    if args.node_samples_file:
        node_ids = np.loadtxt(args.node_samples_file, dtype=np.int64, ndmin=1)
    recon = reconstruction_metrics(
        g, space, args.node_samples, rng, node_ids=node_ids, device=device
    )
    det = edge_detection_metrics(g, space, args.edge_samples, rng)
    values += [
        f"{recon['constructDeg']:.6f}", f"{recon['MAP']:.6f}",
        f"{det['precision']:.6f}", f"{det['recall']:.6f}", f"{det['edgeF1']:.6f}",
    ]
    print(",".join(values))
    return 0


if __name__ == "__main__":
    sys.exit(main())
