"""wembed-embed CLI for the PyTorch/CUDA port — embed a graph from an edge list.

Same flags as ``wembed_tpu/cli/embed.py`` (the reference's cli_wembed,
src/cli_wembed/main.cpp:40-84).  Runs on the CUDA device.
``--distributed replicated`` runs the replicated backend and
``--distributed halo`` the vertex-sharded one, one rank a process: under
``python -m torch.distributed.run`` each rank makes its own mesh, and rank
0 alone writes the output (every rank takes part in gathering it) and
prints the timings.  ``--profile-timings`` prints the profiled step's phase
tree (index / attracting_forces / repelling_forces / apply_forces /
gravity / position_change), timed by CUDA events.

    python -m wembed_tpu_torch.cli.embed -i assets/girg10k.edg -o emb.csv --seed 1 --dim 2
    python -m torch.distributed.run --standalone --nproc-per-node 1 -m wembed_tpu_torch.cli.embed \
        -i assets/girg10k.edg -o emb.csv --seed 1 --dim 2 --distributed replicated
    python -m torch.distributed.run --standalone --nproc-per-node 1 -m wembed_tpu_torch.cli.embed \
        -i assets/girg10k.edg -o emb.csv --seed 1 --dim 2 --distributed halo
"""

from __future__ import annotations

import argparse
import sys

from .. import api as wembed
from ..distributed.mesh import process_rank, shutdown
from ..graphs import io


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="wembed-embed", description="Embedder CLI")
    p.add_argument("-i", "--graph", required=True, help="Path to an edge list")
    p.add_argument("-o", "--embedding", default="", help="Path to the output embedding file")
    p.add_argument(
        "--init-coordinates", default="",
        help="Path to a file containing initial coordinates. If empty, "
        "coordinates are initialized randomly.",
    )
    p.add_argument("--timings", action="store_true", help="Print timings after embedding")
    p.add_argument(
        "--profile-timings", action="store_true",
        help="Per-phase timing tree (index/attraction/repulsion/apply/"
        "gravity/position_change, like the reference's --timings), timed "
        "by CUDA events with one synchronisation a step; slower than the "
        "normal loop, for profiling, not production runs.",
    )
    p.add_argument("--seed", type=int, default=-1,
                   help="Seed used during embedding. '-1' uses time as seed")
    p.add_argument("--layered", action="store_true", help="Use layered embedding")
    p.add_argument("--dim", type=int, default=4, help="Embedding dimension")
    p.add_argument("--dim-hint", type=float, default=-1.0,
                   help="Dimension hint. Negative values use dim as dimension hint.")
    p.add_argument("--unit-weights", action="store_true",
                   help="Disable degree-based weights (use unit weights instead)")
    p.add_argument("--index-type", type=int, default=2,
                   help="Type of spatial index (1=SNN, 2=Sprk; accepted for "
                   "compatibility: the dense path uses none, the span path its "
                   "own windows)")
    p.add_argument("--min-change", type=float, default=1e-4,
                   help="Minimum change in position to stop the embedding.")
    p.add_argument("--attraction", type=float, default=1.0,
                   help="Changes magnitude of attracting forces")
    p.add_argument("--repulsion", type=float, default=1.0,
                   help="Changes magnitude of repulsing forces")
    p.add_argument("--centre", "--center", dest="centre", type=float, default=0.0,
                   help="Strength of the centre-pull force (useful for "
                   "unconnected graphs)")
    p.add_argument("--expansion", type=float, default=1.0,
                   help="Stretch applied during layer expansion")
    p.add_argument("--expansion-mode", choices=["sphere", "reference"],
                   default="sphere", help="Layered child placement")
    p.add_argument("--iterations", type=int, default=1000,
                   help="Maximum number of iterations")
    p.add_argument("--cooling", type=float, default=0.99,
                   help="Cooling during gradient descent")
    p.add_argument("--speed", type=float, default=10.0,
                   help="Learning rate of the embedding process")
    p.add_argument("--distributed", choices=["replicated", "halo"], default="",
                   help="Multi-device execution, one rank a process: 'replicated' "
                   "(replicated state, work-partitioned forces) or 'halo' "
                   "(vertex-sharded state, halo exchange)")
    p.add_argument("--num-devices", type=int, default=-1,
                   help="Ranks in the process group (-1: as many as there are)")
    p.add_argument("--multihost", action="store_true",
                   help="Accepted for the JAX package's flag: every rank joins "
                   "the process group from WEMBED_COORDINATOR / "
                   "WEMBED_NUM_PROCESSES / WEMBED_PROCESS_ID (or "
                   "torch.distributed.run's variables) with or without it")
    return p


def main(argv=None, device: str = "cuda") -> int:
    """Embed as the flags say, on ``device``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.seed != -1:
        wembed.setSeed(args.seed)

    graph = wembed.graphFromEdgeListFile(args.graph)
    opts = wembed.Options(
        embeddingDimension=args.dim,
        useUnitWeights=args.unit_weights,
        dimensionHint=args.dim_hint,
        layeredEmbedding=args.layered,
        expansionMode=args.expansion_mode,
        indexType=args.index_type,
        attractionScale=args.attraction,
        repulsionScale=args.repulsion,
        centreScale=args.centre,
        expansionStretch=args.expansion,
        coolingFactor=args.cooling,
        learningRate=args.speed,
        maxIterations=args.iterations,
        positionMinChange=args.min_change,
        distributedMode=args.distributed or "none",
        numDevices=args.num_devices,
        multiHost=args.multihost,
    )
    embedder = wembed.createEmbedder(graph, opts, device=device)
    if args.profile_timings:
        embedder.impl.profile = True

    if args.init_coordinates:
        embedder.setCoordinates(wembed.readCoordinatesFromFile(args.init_coordinates))

    embedder.calculateEmbedding()

    if args.embedding:
        # a collective under halo (each rank holds its rows): every rank
        # gathers, rank 0 writes
        coords = embedder.impl.get_coordinates()
    if process_rank() == 0:
        if args.timings or args.profile_timings:
            print(wembed.timingsToString(embedder.getTimings()))
        if args.embedding:
            io.write_coordinates(args.embedding, coords, embedder.impl.get_weights())
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        shutdown()
    sys.exit(code)
