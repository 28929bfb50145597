"""`enc64.launches`: the all-device encode kernel's launches a device encode
group, read from the port's counters over the window; nothing on a port
without the launch counter."""

import time

from conftest import small_cell
from portbench import harness


def test_encode_launches_read_the_counters_per_group():
    m = harness.load_module("metrics", "enc64.launches")
    w = harness.Window(seconds=1.0, setup_s=0.0, latencies_s=[0.1] * 4,
                       stats={"encode.encode_launches": 6, "encode.match_calls": 6})
    assert m.read(w) == 1.0
    w.stats = {"encode.encode_launches": 0, "encode.match_calls": 5}  # the plain version ran
    assert m.read(w) == 0.0
    w.stats = {"encode.match_calls": 5}  # a port without the counter
    assert m.read(w) is None
    w.stats = {"encode.encode_launches": 0, "encode.match_calls": 0}  # no device encode
    assert m.read(w) is None


def test_encode_launches_report_in_the_encode_cell():
    r = harness.execute(small_cell("lz4f-64k.encode"), 2**31 + 16, 0.3, True, "cpu",
                        time.perf_counter(), log=lambda m: None)
    assert r["correct"]
    # CPU tensors take the plain torch ops: no launch
    assert r["metrics"]["enc64.launches"] == {"value": 0.0, "unit": "launches/group"}
