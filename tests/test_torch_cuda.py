"""The ring kernel on the card against its plain PyTorch version, and the
entry points with their default device. These tests need a CUDA card of
compute capability 9.0+ and skip without one; they import no JAX, so on a
machine without it they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from lz4_flex_tpu_torch import native
from lz4_flex_tpu_torch.frame import decompress_frame_device
from lz4_flex_tpu_torch.ops import ringdecode as R
from lz4_flex_tpu_torch.ops.decode import decode_block_device

from .torch_inputs import block_inputs, wild_plan_fields, word_soup

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not R.ring_engine_available():
        pytest.skip("needs a CUDA card of compute capability 9.0+")
    return torch.device("cuda")


@pytest.mark.parametrize("tile_rows", [64, 256, 512])
def test_kernel_equals_reference(card, tile_rows):
    for name, data in block_inputs().items():
        plan = R.build_ring_plan(native.compress_block(data), len(data), tile_rows=tile_rows)
        ts = R.ring_plan_device_tensors(plan, card)
        before = R.stats["kernel_launches"]
        out, acc = R.ring_decode(*ts, tile_rows=tile_rows, ntot=len(data))
        assert R.stats["kernel_launches"] == before + 1
        ref, ref_acc = R.ring_decode_reference(*ts, tile_rows=tile_rows, ntot=len(data))
        assert torch.equal(out, ref), name
        assert torch.equal(acc, ref_acc), name
        assert out.reshape(-1)[: len(data)].cpu().numpy().tobytes() == data, name


@pytest.mark.parametrize("tile_rows", [64, 256, 512])
def test_kernel_equals_reference_on_wild_records(card, tile_rows):
    # lo+len > 128, addresses off both ends of the table, garbage bits and
    # garbage padding fields: no lane of another row and no byte outside the
    # table may be touched.
    plan = R.RingPlan.from_arrays(**wild_plan_fields(tile_rows))
    ts = R.ring_plan_device_tensors(plan, card)
    out, acc = R.ring_decode(*ts, tile_rows=tile_rows, ntot=plan.total_out)
    ref, ref_acc = R.ring_decode_reference(*ts, tile_rows=tile_rows, ntot=plan.total_out)
    assert torch.equal(out, ref)
    assert torch.equal(acc, ref_acc)
    assert torch.equal(R.ring_decode(*ts, tile_rows=tile_rows), ref)


def test_kernel_rejects_bad_tensors(card):
    data = word_soup(50000)
    plan = R.build_ring_plan(native.compress_block(data), len(data))
    init, f0, f1, f2, nft = R.ring_plan_device_tensors(plan, card)
    with pytest.raises(ValueError):
        R.ring_decode(init, f0.cpu(), f1, f2, nft, tile_rows=plan.tile_rows)
    with pytest.raises(ValueError):
        R.ring_decode(init, f0.transpose(1, 2).contiguous().transpose(1, 2), f1, f2, nft,
                      tile_rows=plan.tile_rows)


def test_entry_points_default_to_the_card(card):
    data = word_soup(400000, seed=3)
    comp = native.compress_block(data)
    before = R.stats["kernel_launches"]
    assert decode_block_device(comp, len(data)) == data
    arr = decode_block_device(comp, len(data), as_array=True)
    assert arr.device.type == "cuda" and arr.cpu().numpy().tobytes() == data
    assert R.stats["kernel_launches"] == before + 2
    assert decompress_frame_device(b"") == b""


def test_kernel_rejects_misaligned_tensors(card):
    data = word_soup(50000)
    plan = R.build_ring_plan(native.compress_block(data), len(data))
    init, f0, f1, f2, nft = R.ring_plan_device_tensors(plan, card)
    shifted = torch.empty(f0.numel() + 1, dtype=torch.int32, device=card)[1:].view(f0.shape)
    shifted.copy_(f0)
    with pytest.raises(ValueError, match="aligned"):
        R.ring_decode(init, shifted, f1, f2, nft, tile_rows=plan.tile_rows)
