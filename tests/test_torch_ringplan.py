"""The port's host planner against the JAX package's: under
TLZ4_DETERMINISTIC=1 both planners emit field-equal plans (records compared
up to nf_tot, the slots the kernel reads); plus the NFMAX retry ladder and
hint, overflow, pool lifetime, tile_rows bounds and the error taxonomy."""

import numpy as np
import pytest

from lz4_flex_tpu import block
from lz4_flex_tpu.ops import ringdecode as JR
from lz4_flex_tpu_torch.block import errors as E
from lz4_flex_tpu_torch.ops import ringdecode as R

from .torch_inputs import block_inputs, deep_chains, word_soup

INPUTS = block_inputs()


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.uint8)


def assert_plans_equal(port, ref):
    assert port.ntiles == ref.ntiles and port.total_out == ref.total_out
    assert port.tile_rows == ref.tile_rows and port.rb == ref.rb
    assert port.rec_f0.shape == ref.rec_f0.shape
    np.testing.assert_array_equal(port.nf_tot, ref.nf_tot)
    np.testing.assert_array_equal(port.fper, ref.fper)
    np.testing.assert_array_equal(port.lit_init, ref.lit_init)
    live = np.arange(port.rec_f0.shape[1])[None, :, None] < port.nf_tot[:, None, None]
    for a, b in ((port.rec_f0, ref.rec_f0), (port.rec_f1, ref.rec_f1),
                 (port.rec_f2, ref.rec_f2)):
        np.testing.assert_array_equal(np.where(live, a, 0), np.where(live, b, 0))


def _linked_parts(data: bytes, bs: int):
    parts, tail = [], b""
    for i in range(0, len(data), bs):
        b = data[i : i + bs]
        c = block.compress_with_dict(b, tail) if tail else block.compress(b)
        parts.append((_u8(c), True))
        tail = (tail + b)[-65536:]
    return parts


@pytest.mark.parametrize("tile_rows", [256, 512])
@pytest.mark.parametrize("name", ["rle", "ab", "incompressible", "deep_chains",
                                  "periodic_ring_boundary", "word_soup"])
def test_block_plans_field_equal(monkeypatch, name, tile_rows):
    monkeypatch.setenv("TLZ4_DETERMINISTIC", "1")
    data = INPUTS[name]
    comp = _u8(block.compress(data))
    R._nfmax_hint[0] = JR._nfmax_hint[0] = R.NFMAX_ALLOC
    port = R.build_ring_plan(comp, len(data), tile_rows=tile_rows)
    ref = JR.build_ring_plan(comp, len(data), tile_rows=tile_rows)
    assert_plans_equal(port, ref)


@pytest.mark.parametrize("tile_rows", [256, 512])
def test_parts_plans_field_equal(monkeypatch, tile_rows):
    monkeypatch.setenv("TLZ4_DETERMINISTIC", "1")
    soup = word_soup(150000, seed=5)
    linked = _linked_parts(soup, 32768)
    blocks = [soup[i : i + 16384] for i in range(0, len(soup), 16384)]
    independent_stored = [
        (_u8(b), False) if i % 3 == 1 else (_u8(block.compress(b)), True)
        for i, b in enumerate(blocks)
    ]
    for parts, independent in ((linked, False), (independent_stored, True)):
        R._nfmax_hint[0] = JR._nfmax_hint[0] = R.NFMAX_ALLOC
        port, pcomp = R.build_ring_plan_parts(parts, len(soup), independent=independent,
                                              tile_rows=tile_rows)
        ref, rcomp = JR.build_ring_plan_parts(parts, len(soup), independent=independent,
                                              tile_rows=tile_rows)
        assert_plans_equal(port, ref)
        np.testing.assert_array_equal(pcomp, rcomp)
        assert JR.simulate_ring_plan(port) == soup


def test_independent_rejects_cross_block_refs():
    parts = _linked_parts(word_soup(40000, seed=6), 8192)
    with pytest.raises(E.OffsetOutOfBounds):
        R.build_ring_plan_parts(parts, 40000, independent=True)


def test_nfmax_ladder_and_hint():
    data = deep_chains(400_000, tail=512, reps=9)
    comp = _u8(block.compress(data))
    R._nfmax_hint[0] = R.NFMAX_ALLOC
    plan = R.build_ring_plan(comp, len(data))
    nfmax = plan.rec_f0.shape[1]
    assert nfmax in R._NFMAX_LADDER
    used = int(plan.nf_tot.max())
    expect = next(s for s in R._NFMAX_LADDER if s >= used)
    assert R._nfmax_hint[0] == expect
    assert JR.simulate_ring_plan(plan) == data
    light = b"abcdefgh" * 4000
    assert R.build_ring_plan(_u8(block.compress(light)), len(light)) is not None
    assert R._nfmax_hint[0] <= expect


def test_ladder_climbs_from_a_small_start():
    data = word_soup(300000, seed=8)
    comp = _u8(block.compress(data))
    plan = R.build_ring_plan(comp, len(data), nfmax=1)
    assert plan.rec_f0.shape[1] >= int(plan.nf_tot.max())
    assert plan.rec_f0.shape[1] in R.NFMAX_STEPS


def test_overflow_returns_none(monkeypatch):
    monkeypatch.setattr(R, "NFMAX_STEPS", (1,))
    monkeypatch.setattr(R, "NFMAX_RETRY", 1)
    monkeypatch.setattr(R, "_nfmax_hint", [1])
    data = word_soup(300000, seed=8)
    assert R.build_ring_plan(_u8(block.compress(data)), len(data)) is None
    assert R.build_ring_plan_parts([(_u8(block.compress(data)), True)], len(data)) == (None, None)


@pytest.mark.parametrize("tile_rows", [32, 100, 1024, 0])
def test_tile_rows_bounds(tile_rows):
    comp = _u8(block.compress(b"abc" * 1000))
    with pytest.raises(ValueError):
        R.build_ring_plan(comp, 3000, tile_rows=tile_rows)


@pytest.mark.parametrize("tile_rows", [64, 128])
def test_small_tiles_decode(tile_rows):
    data = INPUTS["periodic_ring_boundary"][:120000]
    plan = R.build_ring_plan(_u8(block.compress(data)), len(data), tile_rows=tile_rows)
    assert plan.tile_rows == tile_rows
    assert JR.simulate_ring_plan(plan) == data


def test_plan_error_taxonomy():
    with pytest.raises(E.OffsetZero):
        R.build_ring_plan(np.array([0x10, 65, 0, 0], np.uint8), 5)
    with pytest.raises(E.OffsetOutOfBounds):
        R.build_ring_plan(np.array([0x10, 65, 100, 0], np.uint8), 5)
    with pytest.raises(E.ExpectedAnotherByte):
        R.build_ring_plan(np.array([0xF0, 0xFF], np.uint8), 2000)
    with pytest.raises(E.LiteralOutOfBounds):
        R.build_ring_plan(np.array([0x45], np.uint8), 20)
    with pytest.raises(E.OutputTooSmall):
        data = word_soup(1000)
        R.build_ring_plan(_u8(block.compress(data)), len(data) - 1)


def test_pool_lifetime():
    data = word_soup(50000, seed=9)
    comp = _u8(block.compress(data))
    first = R.build_ring_plan(comp, len(data))
    R.build_ring_plan(comp, len(data))
    first.check_live()  # one later build leaves it live
    R.build_ring_plan(comp, len(data))
    with pytest.raises(RuntimeError, match="invalidated"):
        first.check_live()
    with pytest.raises(RuntimeError, match="invalidated"):
        R.ring_plan_device_tensors(first, "cpu")


def test_from_arrays_owns_its_arrays_and_validates():
    data = word_soup(70000, seed=10)
    ref = JR.build_ring_plan(_u8(block.compress(data)), len(data))
    plan = R.RingPlan.from_arrays(ref.rec_f0, ref.rec_f1, ref.rec_f2, ref.nf_tot,
                                  ref.fper, ref.lit_init, ref.total_out, ref.tile_rows)
    assert plan.seq_holder is None and plan.ntiles == ref.ntiles
    assert not np.shares_memory(plan.rec_f0, ref.rec_f0)
    with pytest.raises(ValueError):
        R.RingPlan.from_arrays(ref.rec_f0, ref.rec_f1, ref.rec_f2, ref.nf_tot,
                               ref.fper, ref.lit_init, ref.total_out, 512)
    with pytest.raises(ValueError):
        R.RingPlan.from_arrays(ref.rec_f0[:, :1], ref.rec_f1, ref.rec_f2, ref.nf_tot,
                               ref.fper, ref.lit_init, ref.total_out, ref.tile_rows)


def test_checksum_expected_matches_reference():
    data = word_soup(12345, seed=11)
    assert R.ring_checksum_expected(data) == JR.ring_checksum_expected(data)
