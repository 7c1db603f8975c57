"""Run a cell's control: the reference with one guarantee broken
(``reference/controls.py``) in the program's place, through the rest of
a run, once a seed.

    python3 -m port_bench.control --workload <name> --seeds 11,12,13 [--seconds 0]

Each seed prints the run's line, whose ``checks`` must read over their
limits (``correct`` false): the upper readings the limits are set
below.  The control runs on the host and needs no card.
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", default="0")
    args = ap.parse_args(argv)
    rc = 0
    for seed in args.seeds.split(","):
        rc |= run.main(["--workload", args.workload, "--seed", seed,
                        "--seconds", args.seconds],
                       devices=[torch.device("cpu")], system="control")
    return rc


if __name__ == "__main__":
    sys.exit(main())
