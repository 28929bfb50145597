"""The ring kernel's plain PyTorch version against the JAX package: it equals
the numpy simulator and the Pallas kernel in interpret mode byte for byte,
its checksum lanes equal the Pallas kernel's, and a plan built by the JAX
package decodes identically in the port. Tolerance: byte-exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lz4_flex_tpu import block
from lz4_flex_tpu.ops import ringdecode as JR
from lz4_flex_tpu_torch.ops import ringdecode as R

from .torch_inputs import block_inputs, rle_overlap, wild_plan_fields, word_soup

INPUTS = block_inputs()


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.uint8)


def _port_decode(plan, ntot=None):
    ts = R.ring_plan_device_tensors(plan, "cpu")
    return R.ring_decode(*ts, tile_rows=plan.tile_rows, ntot=ntot)


def _jax_kernel(plan, ntot=None):
    arrs = [jnp.asarray(a) for a in JR.ring_plan_device_arrays(plan)]
    kw = dict(ntiles=JR._bucket(plan.ntiles), nf=arrs[3].shape[1], interpret=True,
              tile_rows=plan.tile_rows)
    if ntot is None:
        return np.asarray(JR.ring_decode_jit(*arrs, **kw), np.uint8), None
    out, acc = JR.ring_decode_jit(*arrs, ntot=jnp.asarray(np.array([ntot], np.int32)), **kw)
    return np.asarray(out, np.uint8), np.asarray(acc)


def _lane_sum(acc) -> int:
    return int(np.asarray(acc).astype(np.uint32).sum(dtype=np.uint64) & 0xFFFFFFFF)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_reference_equals_numpy_sim(name):
    data = INPUTS[name]
    plan = R.build_ring_plan(_u8(block.compress(data)), len(data))
    out = _port_decode(plan)
    assert out.shape == (plan.ntiles * plan.tile_rows, 128) and out.dtype == torch.uint8
    got = out.reshape(-1)[: len(data)].numpy().tobytes()
    assert got == JR.simulate_ring_plan(plan) == data


@pytest.mark.parametrize("name", ["rle_overlap", "deep_chains", "word_soup"])
def test_reference_equals_pallas_interpret(name):
    data = INPUTS[name]
    plan = R.build_ring_plan(_u8(block.compress(data)), len(data))
    out, acc = _port_decode(plan, ntot=len(data))
    jout, jacc = _jax_kernel(plan, ntot=len(data))
    rows = plan.ntiles * plan.tile_rows
    np.testing.assert_array_equal(out.numpy(), jout[:rows])
    assert acc.shape == (1, 128) and acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), jacc)
    assert _lane_sum(acc.numpy()) == R.ring_checksum_expected(data)
    assert JR.decode_block_ring(_u8(block.compress(data)), len(data), interpret=True) == data


def test_checksum_lanes_without_and_with_ntot():
    data = word_soup(100000, seed=12)
    plan = R.build_ring_plan(_u8(block.compress(data)), len(data))
    plain = _port_decode(plan)
    out, acc = _port_decode(plan, ntot=len(data))
    assert torch.equal(plain, out)
    assert _lane_sum(acc.numpy()) == R.ring_checksum_expected(data)
    # a shorter ntot weights only the first ntot bytes
    _, acc2 = _port_decode(plan, ntot=1000)
    assert _lane_sum(acc2.numpy()) == R.ring_checksum_expected(data[:1000])


@pytest.mark.parametrize("tile_rows", [256, 512])
def test_jax_plan_carried_over_decodes_identically(tile_rows):
    data = word_soup(150000, seed=13) + rle_overlap()[:60000]
    ref = JR.build_ring_plan(_u8(block.compress(data)), len(data), tile_rows=tile_rows)
    plan = R.RingPlan.from_arrays(ref.rec_f0, ref.rec_f1, ref.rec_f2, ref.nf_tot,
                                  ref.fper, ref.lit_init, ref.total_out, ref.tile_rows)
    got = _port_decode(plan).reshape(-1)[: len(data)].numpy().tobytes()
    assert got == JR.simulate_ring_plan(ref) == data


@pytest.mark.parametrize("tile_rows,name", [
    (256, "periodic_ring_boundary"),
    (512, "periodic_ring_boundary"),
    (512, "ab_mix"),
    (512, "rle_overlap"),
    (512, "ab"),
])
def test_port_equals_data_where_pallas_trusts_the_packer(tile_rows, name):
    # The Pallas kernel trusts two packer promises the port does not: that
    # a plain (P=128) record's S is row-aligned, and (at 512-row tiles, the
    # dense packer) that a fire's periodic flag is set. On the periodic
    # ring-boundary input at 256-row tiles the native planner emits 233 plain
    # records with unaligned S in tile 9, fire 0, and the Pallas kernel in
    # interpret mode decodes 29,326 bytes wrong there. The port decodes every
    # record from its own S and P and must equal the data.
    data = (b"ab" * 40000 + word_soup(9999) + b"\x00" * 7777) if name == "ab_mix" else INPUTS[name]
    plan = R.build_ring_plan(_u8(block.compress(data)), len(data), tile_rows=tile_rows)
    out, acc = _port_decode(plan, ntot=len(data))
    assert out.reshape(-1)[: len(data)].numpy().tobytes() == data
    assert JR.simulate_ring_plan(plan) == data
    assert _lane_sum(acc.numpy()) == R.ring_checksum_expected(data)


def test_padding_records_with_garbage_fields_are_skipped():
    # Outside TLZ4_DETERMINISTIC only f2's padding sentinel is stamped; the
    # reference must ignore whatever f0/f1 hold in those slots.
    data = INPUTS["periodic_ring_boundary"]
    plan = R.build_ring_plan(_u8(block.compress(data)), len(data))
    f0, f1 = plan.rec_f0.copy(), plan.rec_f1.copy()
    pad = ((plan.rec_f2 >> 7) & (2 * plan.tile_rows - 1)) >= plan.tile_rows
    f0[pad] = -123456789
    f1[pad] = 0x7FFFFFFF
    garbled = R.RingPlan.from_arrays(f0, f1, plan.rec_f2, plan.nf_tot, plan.fper,
                                     plan.lit_init, plan.total_out, plan.tile_rows)
    assert _port_decode(garbled).reshape(-1)[: len(data)].numpy().tobytes() == data


@pytest.mark.parametrize("tile_rows", [64, 256, 512])
def test_wild_record_fields_equal_numpy_sim(tile_rows):
    # Records whose lanes run past the row (lo+len > 128), whose addresses
    # fall off either side of the table and whose fields carry garbage
    # bits: the plain version masks and clamps exactly as the numpy sim.
    plan = R.RingPlan.from_arrays(**wild_plan_fields(tile_rows))
    out, acc = _port_decode(plan, ntot=plan.total_out)
    want = JR.simulate_ring_plan(plan)
    assert out.reshape(-1)[: plan.total_out].numpy().tobytes() == want
    assert _lane_sum(acc.numpy()) == R.ring_checksum_expected(want)


def test_ring_decode_checks_its_inputs():
    data = word_soup(40000, seed=14)
    plan = R.build_ring_plan(_u8(block.compress(data)), len(data))
    init, f0, f1, f2, nft = R.ring_plan_device_tensors(plan, "cpu")
    with pytest.raises(ValueError):
        R.ring_decode(init, f0.long(), f1, f2, nft, tile_rows=plan.tile_rows)
    with pytest.raises(ValueError):
        R.ring_decode(init[:-1], f0, f1, f2, nft, tile_rows=plan.tile_rows)
    with pytest.raises(ValueError):
        R.ring_decode(init, f0, f1, f2, nft, tile_rows=512)
