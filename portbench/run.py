#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this machine holds.

    python3 portbench/run.py --workload lz4f-64k.decode --seed 7 --seconds 30 --trace 0

Prints counters and the compared numbers on standard error, and one JSON
result line last on standard output; see portbench/README.md.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# Fixed cache directories inside the checkout, so that only a checkout's first
# run builds (the port's own native and CUDA builds go to <checkout>/build).
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
# One intra-op thread for torch's host ops. Its OpenMP pool of one thread a
# core waits for its slowest thread, and on a card's shared host that made
# the plan upload's pinned copies take 3.7-13 ms a request from process to
# process; the port's native planner keeps its own pool (PERF.md).
os.environ["OMP_NUM_THREADS"] = "1"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
