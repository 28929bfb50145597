"""The port's spans (lz4_flex_tpu_torch/utils/trace.py) and the plan counters
of ops/ringdecode.py: no span without a profiler; under one, spans nested
under one request id a call, stamped on the profiler's clock; the counters
of plan builds, pool misses and uploaded bytes."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lz4_flex_tpu_torch import native
from lz4_flex_tpu_torch.models import LZ4Codec
from lz4_flex_tpu_torch.ops import ringdecode as R
from lz4_flex_tpu_torch.utils import trace
from .torch_inputs import word_soup

DATA = word_soup(150_000, seed=13)
BLOCK = 65536


def _rows(data: bytes, nblocks: int):
    """``nblocks`` 64 KiB blocks of ``data`` as decode_step's payload rows."""
    payloads = [native.compress_block(data[i * BLOCK : (i + 1) * BLOCK]) for i in range(nblocks)]
    rows = np.zeros((nblocks, BLOCK), np.uint8)
    for r, p in zip(rows, payloads):
        r[: len(p)] = np.frombuffer(p, np.uint8)
    return rows, np.array([len(p) for p in payloads], np.int32)


@pytest.fixture(scope="module")
def codec():
    return LZ4Codec(device="cpu")


@pytest.fixture(scope="module")
def frame(codec):
    return codec.compress(DATA)


def _profiled(fn):
    """``fn()`` under a CPU profiler: (its result, the profiler's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def test_no_span_without_a_profiler(codec, frame, monkeypatch):
    opened = []
    real = torch._C._profiler._RecordFunctionFast
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda *a: opened.append(a) or real(*a))
    assert not torch.autograd._profiler_enabled()
    assert trace.span("a") is trace.span("b") is trace.request("c")
    trace.clear()
    codec.decompress(frame)
    codec.compress(DATA)
    codec.decode_step(*_rows(DATA, 2))
    assert trace.records() == [] and opened == []


def test_spans_nest_under_one_request_on_the_profilers_clock(codec):
    small = DATA[:40_000]
    rows, lens = _rows(small, 1)
    calls = [lambda: codec.decompress(codec.compress(small)), lambda: codec.decode_step(rows, lens)]
    for _ in range(3):
        trace.clear()
        _, events = _profiled(lambda: [c() for c in calls])
        recs = trace.records()
        roots = [r for r in recs if r[2] == -1]
        assert [r[0] for r in roots] == ["codec.compress", "codec.decompress", "codec.decode_step"]
        assert len({r[1] for r in roots}) == 3 and all(r[1] > 0 for r in roots)
        for name, rid, parent, tid, t0, t1 in recs:
            assert t0 <= t1
            if parent == -1:
                continue
            p = recs[parent]
            assert p[1] == rid and p[3] == tid and p[4] <= t0 and t1 <= p[5], (name, p[0])
        names = {r[0] for r in recs}
        assert {"frame.decode", "ring.sizes", "ring.plan", "ring.launch", "ring.out", "frame.encode",
                "enc.stage", "enc.launch", "enc.unpack", "enc.verify", "resident.step",
                "resident.sync"} <= names
        # Each record holds its profiler range, read on the same clock; the
        # ranges are host ops, not annotations the profiler mirrors on a device.
        ours = [e for e in events if e.name().startswith(trace.PREFIX)]
        assert {e.activity_type() for e in ours} == {"cpu_op"}
        ranges = sorted((e.start_ns(), e.end_ns(), e.name()) for e in ours)
        by_start = sorted(recs, key=lambda r: r[4])
        assert [n for *_, n in ranges] == [trace.PREFIX + r[0] for r in by_start]
        gaps = []
        for (s, e, _), r in zip(ranges, by_start):
            assert r[4] <= s and e <= r[5]
            gaps += [s - r[4], r[5] - e]
        # A clock offset would move every bound one way; the profiler's own
        # bookkeeping (a profile's first range, a range after many ops)
        # widens a few of them.
        assert np.median(gaps) <= 50_000, sorted(gaps)


def test_records_keep_a_window(codec, frame):
    trace.clear()
    _profiled(lambda: codec.decompress(frame))
    root, walk = trace.records()[:2]
    assert (root[0], walk[0], walk[2]) == ("codec.decompress", "frame.decode", 0)
    inner = trace.records(walk[4], walk[5])
    assert inner[0][0] == "frame.decode" and inner[0][2] == -1
    assert all(r[4] >= walk[4] and r[5] <= walk[5] for r in inner)
    assert trace.records(root[5] + 1) == []
    assert trace._kept.maxlen == trace.CAPACITY


def test_a_small_nfmax_hint_climbs_the_ladder(monkeypatch):
    monkeypatch.setattr(R, "_nfmax_hint", [1])
    comp = native.compress_block(DATA)
    before = R.stats["plan_builds"]
    plan = R.build_ring_plan(comp, len(DATA))
    assert plan is not None and R.stats["plan_builds"] - before > 1
    before = R.stats["plan_builds"]
    R.build_ring_plan(comp, len(DATA))  # the hint now starts at the rung that held it
    assert R.stats["plan_builds"] - before == 1
    out = R.ring_decode(*R.ring_plan_device_tensors(plan, "cpu"), tile_rows=plan.tile_rows)
    assert out.reshape(-1)[: len(DATA)].numpy().tobytes() == DATA


def test_plans_of_another_shape_miss_the_pool():
    big, small = native.compress_block(DATA), native.compress_block(DATA[:40_000])

    def build(comp, n):
        before = R.stats["plan_pool_misses"]
        assert R.build_ring_plan(comp, n, nfmax=R.NFMAX_RETRY) is not None
        return R.stats["plan_pool_misses"] - before

    build(big, len(DATA))
    build(big, len(DATA))  # both generations now hold the big plan's shape
    misses = [build(big, len(DATA)), build(small, 40_000), build(small, 40_000),
              build(small, 40_000)]
    assert misses == [0, 1, 1, 0]


def test_upload_bytes_are_the_plan_arrays():
    plan = R.build_ring_plan(native.compress_block(DATA), len(DATA))
    before = R.stats["upload_bytes"]
    R.ring_plan_device_tensors(plan, "cpu")
    arrays = (plan.lit_init, plan.rec_f0, plan.rec_f1, plan.rec_f2, plan.nf_tot)
    assert R.stats["upload_bytes"] - before == sum(a.nbytes for a in arrays)


def test_resident_reads_repeat_on_one_batch(codec):
    rows, lens = _rows(DATA, 2)
    trace.clear()
    outs, _ = _profiled(lambda: [codec.decode_step(rows, lens) for _ in range(2)])
    syncs = collections.Counter(r[1] for r in trace.records() if r[0] == "resident.sync")
    assert len(syncs) == 2 and len(set(syncs.values())) == 1 and min(syncs.values()) > 0
    for a, b in zip(*outs):
        assert torch.equal(a, b)

