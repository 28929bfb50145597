"""Helpers for the benchmark's CPU tests: its cells at a size a test holds."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ["lz4f-64k.decode", "lz4f-64k.encode", "lz4f-64k.batch_decode"]

# Per mix: the sizes a CPU test runs (the cell's own sizes are on the card).
SMALL_SIZES = {
    "decompress": dict(min=96 * 1024, max=300 * 1024),
    "compress": dict(min=96 * 1024, max=300 * 1024),
    "decode_step": dict(min=2, max=4),
}


def small_cell(name: str):
    """The cell ``name`` with its pool cut to a few small requests."""
    from portbench import harness

    cell = harness.load_cell(harness.load_benchmark(), name)
    t = cell.traffic
    t["sizes"].update(SMALL_SIZES[t["operation"]])
    t["pool"] = 3
    t["text"]["base_bytes"] = 2 << 20
    t["check"]["sample"] = min(t["check"]["sample"], 3)
    t["warmup"] = 0
    t["trace_seconds"] = 0.5
    return cell


@pytest.fixture
def run_small():
    """``run_small(name, seed, trace=False)`` -> the result line of a short
    CPU run of the cell at test size."""
    import time

    from portbench import harness

    def run(name, seed, trace=False, seconds=0.3):
        return harness.execute(small_cell(name), seed, seconds, trace, "cpu", time.perf_counter(),
                               log=lambda msg: None)

    return run
