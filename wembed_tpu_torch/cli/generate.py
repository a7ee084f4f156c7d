"""wembed-generate CLI for the PyTorch/CUDA port — write a GIRG edge list.

Same flags, same host random stream and same output bytes as
``wembed_tpu/cli/generate.py`` (the reference's cli_generator,
src/cli_generator/main.cpp:36-50, Options.hpp:5-19), numpy only.  Makes the
girg100k graph of ``baselines/reference_measured.json``:

    python -m wembed_tpu_torch.cli.generate -o girg100k_d2.edg -n 100000 -d 2 -s 1 --avg-deg 15 --ple 2.5
"""

from __future__ import annotations

import argparse
import sys

from ..graphs import generators, io
from ..utils import rng as rng_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="wembed-generate", description="CLI Generator")
    p.add_argument("-o", "--girg-file", required=True,
                   help="Path to the output file for the edge list")
    p.add_argument("-w", "--girg-coords", default="",
                   help="Path to the output file for the coordinates (incl. weights)")
    p.add_argument("-s", "--seed", type=int, default=-1,
                   help="Seed for the random number generator. -1 uses time as seed")
    p.add_argument("-n", "--nodes", type=int, default=1000, help="Maximum number of nodes")
    p.add_argument("--ple", type=float, default=2.5, help="Power law exponent (>= 2)")
    p.add_argument("--avg-deg", type=float, default=15.0, help="Average degree of the graph")
    p.add_argument("-d", "--gen-dim", type=int, default=2, choices=range(1, 6),
                   help="Dimension of the generated graph")
    p.add_argument("-t", "--temp", type=float, default=0.1, help="Temperature for the girg")
    p.add_argument("--torus", action="store_true", help="Generates the graph on the torus")
    p.add_argument("--unconnected", action="store_true", help="Generates an unconnected graph")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.ple < 2.0:
        raise SystemExit("--ple must be >= 2")
    if not (0.0 <= args.temp <= 1.0):
        raise SystemExit("--temp must be in [0, 1]")
    if args.seed != -1:
        rng_mod.set_seed(args.seed)

    g, positions, weights = generators.girg(
        args.nodes,
        ple=args.ple,
        avg_degree=args.avg_deg,
        dim=args.gen_dim,
        temperature=args.temp,
        torus=args.torus,
        connected=not args.unconnected,
        rng=rng_mod.host_rng(),
    )
    io.write_edge_list(args.girg_file, g)
    if args.girg_coords:
        io.write_coordinates(args.girg_coords, positions, weights)
    print(f"generated n={g.num_vertices} m={g.num_edges}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
