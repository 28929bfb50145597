"""`bdec.launches`: the resident kernel's launches a `decode_step`, read from
the port's counter over the window; nothing on a port without the counter."""

import time

from conftest import small_cell
from portbench import harness


def test_launches_read_the_counter_per_request():
    m = harness.load_module("metrics", "bdec.launches")
    w = harness.Window(seconds=1.0, setup_s=0.0, latencies_s=[0.1] * 4,
                       stats={"ringdecode.resident_launches": 4})
    assert m.read(w) == 1.0
    w.stats = {"ringdecode.kernel_launches": 3}  # a port without the counter
    assert m.read(w) is None


def test_launches_report_in_the_batch_cell():
    r = harness.execute(small_cell("lz4f-64k.batch_decode"), 2**31 + 14, 0.3, True, "cpu",
                        time.perf_counter(), log=lambda m: None)
    assert r["correct"]
    # CPU tensors take the plain torch ops: no launch
    assert r["metrics"]["bdec.launches"] == {"value": 0.0, "unit": "launches/batch"}
