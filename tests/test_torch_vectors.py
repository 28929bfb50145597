"""tests/test_vectors.py's frozen known-answer vectors through the port's
engines: the block API (native), ``spec.golden``, the ring decode's plain
version (``decode_block_device(device="cpu")``, default ``parse="ring"``)
and the fallback engines (``parse="host"`` and ``"device"``), the host
frame decoder and ``decompress_frame_device(device="cpu")``; plus the
poisoned-buffer checks on ``decompress_into``. The vectors are
hand-derived from the published LZ4 block and frame specs, their checksums
computed with the independent ``xxhash`` package. Tolerance: exact."""

import io
import struct

import numpy as np
import pytest
import torch
import xxhash

from lz4_flex_tpu_torch import block
from lz4_flex_tpu_torch import frame
from lz4_flex_tpu_torch.block import errors as block_errors
from lz4_flex_tpu_torch.frame import errors as frame_errors
from lz4_flex_tpu_torch.frame.device import decompress_frame_device
from lz4_flex_tpu_torch.ops.decode import decode_block_device
from lz4_flex_tpu_torch.spec import golden

from .test_vectors import BLOCK_ERROR_VECTORS, BLOCK_VECTORS, LEGACY_MAGIC, _descriptor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_error(err: type) -> type:
    """The port's block error class of the JAX vector's class."""
    return getattr(block_errors, err.__name__)


@pytest.mark.parametrize("name,comp,expected", BLOCK_VECTORS, ids=[v[0] for v in BLOCK_VECTORS])
def test_block_vector_port_engines(name, comp, expected):
    n = len(expected)
    assert golden.decompress_block(comp, n) == expected
    assert block.decompress(comp, n) == expected
    for parse in ("ring", "host", "device"):
        assert decode_block_device(comp, n, parse=parse, device="cpu") == expected, parse


@pytest.mark.parametrize("name,comp,err", BLOCK_ERROR_VECTORS,
                         ids=[v[0] for v in BLOCK_ERROR_VECTORS])
def test_block_error_vector_port_engines(name, comp, err):
    err = _port_error(err)
    with pytest.raises(err):
        golden.decompress_block(comp, 1 << 20)
    with pytest.raises(err):
        block.decompress(comp, 1 << 20)
    for parse in ("ring", "host", "device"):
        with pytest.raises(err):
            decode_block_device(comp, 1 << 20, parse=parse, device="cpu")


def test_poisoned_buffer_no_leak():
    # decode into buffers pre-filled with different poisons: the decoded
    # region must be identical, and the bytes past it untouched
    for name, comp, expected in BLOCK_VECTORS:
        out_ff = np.full(len(expected) + 64, 0xFF, np.uint8)
        out_00 = np.zeros(len(expected) + 64, np.uint8)
        n1 = block.decompress_into(comp, out_ff)
        n2 = block.decompress_into(comp, out_00)
        assert n1 == n2 == len(expected), name
        assert out_ff[:n1].tobytes() == expected, name
        assert out_00[:n2].tobytes() == expected, name
        assert (out_ff[n1:] == 0xFF).all() and (out_00[n2:] == 0).all(), name


def test_poisoned_buffer_no_leak_with_dict():
    ext = b"0123456789abcdef" * 8
    data = b"abcdef" + ext[-32:] + b"qrs" * 40
    comp = block.compress_with_dict(data, ext)
    out_ff = np.full(len(data) + 32, 0xFF, np.uint8)
    out_00 = np.zeros(len(data) + 32, np.uint8)
    n1 = block.decompress_into_with_dict(comp, out_ff, ext)
    n2 = block.decompress_into_with_dict(comp, out_00, ext)
    assert n1 == n2 == len(data)
    assert out_ff[:n1].tobytes() == data
    assert out_00[:n2].tobytes() == data


# -- frame vectors (the wires of tests/test_vectors.py) --------------------------------------

MAGIC_SKIPPABLE = 0x184D2A50
_END = struct.pack("<I", 0)
_HELLO = bytes([0x50]) + b"Hello"
_MATCH = bytes([0x40]) + b"abcd" + bytes([0x04, 0x00, 0x50]) + b"XYZWV"
_BLK1 = bytes([0x50]) + b"ABCDE"
_BLK2 = bytes([0x04, 0x05, 0x00, 0x50]) + b"FGHIJ"  # offset 5 reaches into block 1


def _sized(blk: bytes) -> bytes:
    return struct.pack("<I", len(blk)) + blk


def _h(b: bytes) -> bytes:
    return struct.pack("<I", xxhash.xxh32(b, 0).intdigest())


def _one(text: bytes) -> bytes:
    return _descriptor(0x40, 0x40) + _sized(bytes([len(text) << 4]) + text) + _END


FRAME_VECTORS = {
    "minimal": (_descriptor(0x40, 0x40) + _sized(_HELLO) + _END, b"Hello"),
    "all_flags_stored": (
        _descriptor(0x7C, 0x40, content_size=8) + struct.pack("<I", 0x80000008) + b"RAWBYTES"
        + _h(b"RAWBYTES") + _END + _h(b"RAWBYTES"), b"RAWBYTES"),
    "compressed_block_checksum": (
        _descriptor(0x74, 0x40) + _sized(_MATCH) + _h(_MATCH) + _END + _h(b"abcdabcdXYZWV"),
        b"abcdabcdXYZWV"),
    "linked_cross_block": (_descriptor(0x40, 0x40) + _sized(_BLK1) + _sized(_BLK2) + _END,
                           b"ABCDE" + b"ABCDEABC" + b"FGHIJ"),
    "legacy": (struct.pack("<I", LEGACY_MAGIC) + _sized(_MATCH), b"abcdabcdXYZWV"),
    "concatenated": (_one(b"first") + _one(b"second!"), b"firstsecond!"),
}


def _reserved_bit_wire() -> bytes:
    body = bytes([0x42, 0x40])  # FLG bit 1 is reserved and must be zero
    hc = (xxhash.xxh32(body, 0).intdigest() >> 8) & 0xFF
    return struct.pack("<I", 0x184D2204) + body + bytes([hc]) + _END


def _bad_header_checksum_wire() -> bytes:
    good = _descriptor(0x40, 0x40)
    return good[:-1] + bytes([good[-1] ^ 0xFF]) + _END


FRAME_ERROR_VECTORS = {
    "independent_rejects_cross_block": (
        _descriptor(0x60, 0x40) + _sized(_BLK1) + _sized(_BLK2) + _END,
        (frame_errors.FrameError, frame_errors.DecompressionError)),
    "bad_header_checksum": (_bad_header_checksum_wire(), frame_errors.FrameError),
    "reserved_bits": (_reserved_bit_wire(), frame_errors.FrameError),
}


@pytest.mark.parametrize("name", sorted(FRAME_VECTORS))
def test_frame_vector_port_decoders(name):
    wire, expected = FRAME_VECTORS[name]
    assert frame.decompress(wire) == expected
    assert decompress_frame_device(wire, device="cpu") == expected
    assert frame.FrameDecoder(io.BytesIO(wire), engine="device", device="cpu").read_all() == expected


@pytest.mark.parametrize("name", sorted(FRAME_ERROR_VECTORS))
def test_frame_error_vector_port_decoders(name):
    wire, err = FRAME_ERROR_VECTORS[name]
    for decode in (frame.decompress, lambda w: decompress_frame_device(w, device="cpu")):
        with pytest.raises(err):
            decode(wire)


def test_frame_vector_skippable_then_frame():
    # the streaming decoder surfaces a skippable frame to the caller; the
    # one-shot device decoder skips it
    wire = struct.pack("<I", MAGIC_SKIPPABLE) + struct.pack("<I", 7) + b"skipme!" + _one(b"Hello")
    with pytest.raises(frame_errors.SkippableFrame) as exc:
        frame.decompress(wire)
    assert exc.value.size == 7
    assert decompress_frame_device(wire, device="cpu") == b"Hello"
