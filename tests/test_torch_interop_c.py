"""The port's wire bytes against the system C library (liblz4, through
tests/c_oracle.py), both ways: C-compressed blocks and frames decode on
every port decoder, and blocks and frames from the port's encoders (the
block API, the hybrid and the all-device encoder, the host and device frame
encoders) decode with C. Skipped when liblz4 is absent, as
tests/test_interop_c.py is. Tolerance: exact."""

import io
import itertools

import pytest
import torch

from lz4_flex_tpu_torch import block, frame
from lz4_flex_tpu_torch.frame import BlockMode, BlockSize, FrameInfo
from lz4_flex_tpu_torch.frame.device import compress_frame_device, decompress_frame_device
from lz4_flex_tpu_torch.ops.decode import decode_block_device
from lz4_flex_tpu_torch.ops.encode import compress_block_device, compress_block_hybrid
from lz4_flex_tpu_torch.spec import golden

from . import c_oracle
from .torch_inputs import incompressible, word_soup

pytestmark = pytest.mark.skipif(c_oracle.load() is None, reason="system liblz4 not available")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SOUP = word_soup(200_000, seed=71)
CORPORA = [
    b"a",
    b"hello hello hello hello hello hello",
    b"a" * 100000,
    incompressible(5000, seed=72),
    SOUP,
]


def test_c_blocks_decode_on_the_port():
    for data in CORPORA:
        comp = c_oracle.c_compress_block(data)
        assert block.decompress(comp, len(data)) == data
        assert golden.decompress_block(comp, len(data)) == data
        assert block.decompress_size_prepended(
            len(data).to_bytes(4, "little") + comp) == data
    comp = c_oracle.c_compress_block(SOUP)
    assert decode_block_device(comp, len(SOUP), device="cpu") == SOUP


def test_port_blocks_decode_with_c():
    for data in [b"", *CORPORA]:
        assert c_oracle.c_decompress_block(block.compress(data), len(data)) == data
    dic, tail = SOUP[:65536], SOUP[65536:150_000]
    assert c_oracle.c_decompress_block(block.compress_with_dict(tail, dic), len(tail), dic) == tail
    table = block.CompressTable()
    out = bytearray(block.get_maximum_output_size(len(SOUP)))
    n = block.compress_into_with_table(SOUP, out, table)
    assert c_oracle.c_decompress_block(bytes(out[:n]), len(SOUP)) == SOUP


def test_device_encoders_decode_with_c():
    comp_h = compress_block_hybrid(SOUP, device="cpu")
    assert c_oracle.c_decompress_block(comp_h, len(SOUP)) == SOUP
    comp_d = compress_block_device(SOUP[:60_000], device="cpu")
    assert c_oracle.c_decompress_block(comp_d, 60_000) == SOUP[:60_000]


def test_c_frames_decode_on_the_port():
    # every mode combination through the host decoder; one independent and
    # one linked frame through the device decoders as well
    for linked, cc, bc in itertools.product((False, True), repeat=3):
        comp = c_oracle.c_compress_frame(SOUP, linked=linked, content_checksum=cc,
                                         block_checksums=bc, block_size_id=4)  # 64 KiB blocks
        assert frame.decompress(comp) == SOUP, (linked, cc, bc)
        if cc == bc == linked:
            assert decompress_frame_device(comp, device="cpu") == SOUP
            dec = frame.FrameDecoder(io.BytesIO(comp), engine="device", device="cpu")
            assert dec.read_all() == SOUP


@pytest.mark.parametrize("mode", [BlockMode.Independent, BlockMode.Linked])
def test_port_frames_decode_with_c(mode):
    fi = FrameInfo(block_size=BlockSize.Max64KB, block_mode=mode, content_checksum=True,
                   block_checksums=True)
    assert c_oracle.c_decompress_frame(frame.compress(SOUP, fi), len(SOUP)) == SOUP
    assert c_oracle.c_decompress_frame(compress_frame_device(SOUP, fi, device="cpu"),
                                       len(SOUP)) == SOUP
