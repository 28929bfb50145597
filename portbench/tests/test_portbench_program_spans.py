"""The metrics that read the port's own spans and counters: each reports in
its cell, and they add up within what the harness measures around them."""

import time

import pytest

from conftest import small_cell
from portbench import harness
from portbench import program_spans as ps

NEW = {
    "lz4f-64k.decode": ["dec.walk_ms", "dec.plan_builds", "dec.pool_misses", "dec.pin_ms",
                        "dec.upload_ratio", "dec.wait_ms", "dec.out_ms", "dec.overflow_pct",
                        "dec.idle_plan_pct"],
    "lz4f-64k.encode": ["enc64.launch_ms", "enc64.wait_ms", "enc64.host_ms",
                        "enc64.idle_launch_pct"],
    "lz4f-64k.batch_decode": ["bdec.syncs", "bdec.sync_ms"],
}


def _traced(name, seed, monkeypatch):
    """A short traced CPU run of the cell: (result line, its window)."""
    windows, real = [], harness.Window

    def kept(*a, **k):
        windows.append(real(*a, **k))
        return windows[-1]

    monkeypatch.setattr(harness, "Window", kept)
    r = harness.execute(small_cell(name), seed, 0.3, True, "cpu", time.perf_counter(),
                        log=lambda m: None)
    return r, windows[0]


@pytest.mark.parametrize("name", list(NEW))
def test_every_new_metric_reports_in_its_cell(name, monkeypatch):
    r, _ = _traced(name, 2**31 + 5, monkeypatch)
    assert r["correct"]
    assert set(NEW[name]) <= set(r["metrics"]), sorted(r["metrics"])
    assert all(r["metrics"][m]["value"] >= 0 for m in NEW[name])


def test_the_decode_walk_and_ring_spans_lie_within_the_latencies(monkeypatch):
    r, w = _traced("lz4f-64k.decode", 41, monkeypatch)
    recs = ps.records(w)
    ring = ps.total_ms(recs, ("ring.",))
    walk = r["metrics"]["dec.walk_ms"]["value"] * w.n
    assert ring > 0 and walk > 0
    assert walk + ring <= 1e3 * sum(w.latencies_s)
    assert r["metrics"]["dec.plan_builds"]["value"] >= 1
    assert r["metrics"]["dec.upload_ratio"]["value"] > 1  # the literal image alone is the output


def test_the_encode_launches_and_waits_lie_within_the_dispatch(run_small):
    m = run_small("lz4f-64k.encode", 43, trace=True)["metrics"]
    assert m["enc64.launch_ms"]["value"] > 0
    assert m["enc64.launch_ms"]["value"] + m["enc64.wait_ms"]["value"] <= m["enc64.dispatch_ms"]["value"]


def test_a_port_without_spans_reports_none(monkeypatch):
    """Laid over a port that has no ``utils.trace``, the span readers find
    nothing and raise nothing; the counter readers find no key."""
    import builtins

    real = builtins.__import__

    def no_trace(name, *a, **k):
        if name == "lz4_flex_tpu_torch.utils" and "trace" in (a[2] if len(a) > 2 else ()):
            raise ImportError("cannot import name 'trace'")
        return real(name, *a, **k)

    r, w = _traced("lz4f-64k.decode", 47, monkeypatch)
    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert ps.records(w) is None
    w.stats = {k: v for k, v in w.stats.items() if not k.endswith(("plan_builds", "pool_misses",
                                                                   "upload_bytes"))}
    for metric in NEW["lz4f-64k.decode"]:
        value = harness.load_module("metrics", metric).read(w)
        assert value is None or metric == "dec.overflow_pct", (metric, value)
