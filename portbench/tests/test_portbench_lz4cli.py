"""The ``lz4cli-4m.decode`` cell (the ``lz4`` CLI's default frame: 4 MiB
blocks and a content checksum): it loads by name, sound runs pass, each
control fails, a broken timed path comes out not correct, its metrics report
in a traced run, and a port without what the cell reads cannot pass."""

import time

import pytest

import test_portbench_layout as layout
from conftest import SMALL_SIZES, small_cell
from portbench import control, harness
from portbench import program_spans as ps

CELL = "lz4cli-4m.decode"


@pytest.fixture(autouse=True)
def _small_checksummed_frames(monkeypatch):
    """The checksummed mix at the CPU size of ``decompress``."""
    monkeypatch.setitem(SMALL_SIZES, "decompress_checksummed", SMALL_SIZES["decompress"])


def _run(seed, trace=False, seconds=0.3):
    return harness.execute(small_cell(CELL), seed, seconds, trace, "cpu", time.perf_counter(),
                           log=lambda m: None)


def test_the_cell_loads_its_mix_operation_and_metrics():
    layout.test_cell_loads_its_mix_operation_and_metrics(CELL)
    cell = harness.load_cell(harness.load_benchmark(), CELL)
    assert cell.config["frame"]["content_checksum"] and cell.config["frame"]["block_size"] == 4 << 20
    assert cell.traffic["operation"] == "decompress_checksummed"


def test_a_sound_run_is_correct():
    r = _run(2**31 + 77)
    assert r["correct"] and r["failed"] == 0 and r["checks"]["compared"]["value"] > 0
    assert all(c["limit"] is None or c["value"] <= c["limit"] for c in r["checks"].values())
    assert r["checks"]["checksum_not_refused"]["value"] == 0
    assert r["checks"]["checksums_unverified"]["value"] == 0


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_fails(seed):
    """The reference decoder that never checks the content checksum."""
    checks = control.control_checks(small_cell(CELL), seed, "cpu")
    assert any(v > 0 for v in checks.values()), checks


def _flip(b: bytes) -> bytes:
    b = bytearray(b)
    b[len(b) // 2] ^= 0x20
    return bytes(b)


def _answer_altered_after_warmup(mp):
    """An answer altered from the window on (the warm-up's call passes): a
    decode that checks the content checksum refuses each such answer."""
    from lz4_flex_tpu_torch.ops import ringdecode

    orig, calls = ringdecode._to_bytes, [0]

    def flipped(t):
        calls[0] += 1
        return _flip(orig(t)) if calls[0] > 1 else orig(t)

    mp.setattr(ringdecode, "_to_bytes", flipped)


def _content_checksum_skipped(mp):
    """A decode that never verifies the content checksum: each frame's
    header loses its content-checksum flag and the frame its stored value
    before the port's frame walk sees it."""
    from lz4_flex_tpu_torch.frame import device
    from portbench.gen import frozen

    orig = device.decompress_frame_device

    def unchecked(data, **k):
        data = bytearray(data)
        data[4] &= ~0x04
        data[6] = (frozen.xxh32(bytes(data[4:6])) >> 8) & 0xFF
        return orig(bytes(data[:-4]), **k)

    mp.setattr(device, "decompress_frame_device", unchecked)


@pytest.mark.parametrize("fault", [_answer_altered_after_warmup, _content_checksum_skipped],
                         ids=["answer altered", "the content checksum not verified"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = _run(2**31 + 99)
    assert not r["correct"], r["checks"]


def test_a_port_without_the_checksum_counter_cannot_run_the_cell(monkeypatch):
    """Laid over a port that does not count the content checksums its check
    reads, the cell stops before its data is made: the run exits with an
    error, soon."""
    from lz4_flex_tpu_torch.ops import ringdecode

    stats = {k: v for k, v in ringdecode.stats.items() if k != "content_checksums"}
    monkeypatch.setattr(ringdecode, "stats", stats)
    with pytest.raises(RuntimeError, match="content checksums"):
        _run(3, seconds=0.2)


DECODE_METRICS = ["dec4m.xxh_ms", "dec.plan_builds", "dec.pool_misses", "dec.pin_ms",
                  "dec.upload_ratio", "dec.wait_ms", "dec.out_ms", "dec.overflow_pct",
                  "dec.idle_plan_pct"]


def test_the_traced_run_reports_its_metrics_and_none_without_the_span(monkeypatch):
    windows, real = [], harness.Window

    def kept(*a, **k):
        windows.append(real(*a, **k))
        return windows[-1]

    monkeypatch.setattr(harness, "Window", kept)
    r = _run(59, trace=True)
    assert r["correct"]
    assert set(DECODE_METRICS) <= set(r["metrics"]), sorted(r["metrics"])
    assert r["metrics"]["dec4m.xxh_ms"]["value"] > 0
    w = windows[0]
    recs = ps.records(w)
    monkeypatch.setattr(ps, "records", lambda w: [x for x in recs if x[0] != "frame.xxh"])
    assert harness.load_module("metrics", "dec4m.xxh_ms").read(w) is None
