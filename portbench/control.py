#!/usr/bin/env python3
"""The controls of ``correct``: a cell's check with the reference, one
guarantee broken, in the program's place, at the cell's own size.

    python3 portbench/control.py --workload lz4f-64k.decode --seeds 11 12 13

For each seed it makes the cell's pool, runs the operation's ``control``
over as many requests as a run keeps, and prints the compared numbers as one
JSON line. Each has to exceed its limit on some number for the limit to
stand (PERF.md gives the readings). The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_checks(cell, seed: int, device) -> dict:
    """The compared numbers of the control over one seed's kept requests."""
    import numpy as np

    from portbench import harness

    op = harness.load_module("ops", cell.traffic["operation"])
    ctx = harness.Context(cell.config, cell.traffic, seed, device)
    pool = op.prepare(ctx)
    order = np.random.default_rng([ctx.seed, 2]).permutation(len(pool))
    kept = {int(i): op.control(ctx, pool[int(i)]) for i in order[: cell.traffic["check"]["sample"]]}
    return {k: v for k, (v, _) in op.check(ctx, pool, kept).items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench import harness

    cell = harness.load_cell(harness.load_benchmark(), args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": control_checks(cell, seed, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
