"""decode_block_device of the port (on the CPU, through the ring kernel's
plain version) against the JAX package's host block decoder: byte-exact,
with and without a dictionary, the error taxonomy, and the plan-overflow
fallback to the native host decoder."""

import numpy as np
import pytest
import torch

from lz4_flex_tpu import block
from lz4_flex_tpu_torch import native
from lz4_flex_tpu_torch.block import errors as E
from lz4_flex_tpu_torch.models import LZ4Codec
from lz4_flex_tpu_torch.ops import ringdecode as R
from lz4_flex_tpu_torch.ops.decode import decode_block_device

from .torch_inputs import block_inputs, word_soup

INPUTS = block_inputs()


@pytest.mark.parametrize("name", ["rle", "cycle", "incompressible", "deep_chains", "word_soup"])
def test_block_equals_reference(name):
    data = INPUTS[name]
    comp = block.compress(data)
    want = block.decompress(comp, len(data))
    assert decode_block_device(comp, len(data), device="cpu") == want == data
    # a larger capacity is fine: the block's own size is decoded
    assert decode_block_device(comp, len(data) + 100, device="cpu") == data
    arr = decode_block_device(comp, len(data), device="cpu", as_array=True)
    assert isinstance(arr, torch.Tensor) and arr.dtype == torch.uint8
    assert arr.numpy().tobytes() == data


@pytest.mark.parametrize("dict_len", [100, 30000, 100000])
def test_block_with_dict_equals_reference(dict_len):
    dic = word_soup(dict_len, seed=21)
    data = dic[-20000:] + word_soup(60000, seed=22) + dic[:5000]
    comp = block.compress_with_dict(data, dic)
    want = block.decompress_with_dict(comp, len(data), dic)
    assert want == data
    assert decode_block_device(comp, len(data), dic, device="cpu") == data
    arr = decode_block_device(comp, len(data), dic, device="cpu", as_array=True)
    assert arr.numpy().tobytes() == data
    assert LZ4Codec(device="cpu").decompress_block(comp, len(data), dic) == data


def test_error_taxonomy():
    data = word_soup(20000, seed=23)
    comp = bytearray(block.compress(data))
    with pytest.raises(E.OffsetZero):
        decode_block_device(np.array([0x10, 65, 0, 0], np.uint8), 100, device="cpu")
    # zero the first match offset of a real block
    ls, ll, mo, ml, oo, _ = native.parse_sequences(bytes(comp))
    first = int(np.nonzero(ml)[0][0])
    pos = int(ls[first] + ll[first])
    zeroed = comp[:pos] + b"\x00\x00" + comp[pos + 2 :]
    with pytest.raises(E.OffsetZero):
        decode_block_device(bytes(zeroed), len(data), device="cpu")
    with pytest.raises(E.DecompressError):
        decode_block_device(bytes(comp[: len(comp) // 2]), len(data), device="cpu")
    with pytest.raises(E.OutputTooSmall):
        decode_block_device(bytes(comp), len(data) - 1, device="cpu")
    with pytest.raises(E.OffsetOutOfBounds):
        decode_block_device(np.array([0x10, 65, 100, 0, 0x50, 97, 98, 99, 100, 101], np.uint8), 100,
                            device="cpu")


def test_unported_engines_raise():
    comp = block.compress(b"abc" * 100)
    for parse in ("host", "device"):
        with pytest.raises(NotImplementedError):
            decode_block_device(comp, 300, parse=parse, device="cpu")
    with pytest.raises(ValueError):
        decode_block_device(comp, 300, parse="nope", device="cpu")


def _tiny_ladder(monkeypatch):
    monkeypatch.setattr(R, "NFMAX_STEPS", (1,))
    monkeypatch.setattr(R, "NFMAX_RETRY", 1)
    monkeypatch.setattr(R, "_nfmax_hint", [1])


@pytest.mark.parametrize("with_dict", [False, True])
def test_overflow_falls_to_host_decoder(monkeypatch, with_dict):
    _tiny_ladder(monkeypatch)
    dic = word_soup(70000, seed=24) if with_dict else b""
    data = word_soup(300000, seed=8)
    comp = block.compress_with_dict(data, dic) if with_dict else block.compress(data)
    before = dict(R.stats)
    assert decode_block_device(comp, len(data), dic, device="cpu") == data
    assert R.stats["overflow_host_decodes"] == before["overflow_host_decodes"] + 1
    assert R.stats["kernel_launches"] == before["kernel_launches"]
    arr = decode_block_device(comp, len(data), dic, device="cpu", as_array=True)
    assert arr.numpy().tobytes() == data
