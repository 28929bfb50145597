"""decompress_frame_device and LZ4Codec.decompress of the port (on the CPU)
against the JAX package's host frame decoder: byte-exact on independent,
linked, checksummed, legacy, skippable, concatenated and stored-block
frames, with the frame error taxonomy."""

import struct

import pytest

from lz4_flex_tpu import frame as ref_frame
from lz4_flex_tpu.frame import BlockMode, BlockSize, FrameInfo
from lz4_flex_tpu_torch import native
from lz4_flex_tpu_torch.frame import BlockInfo, BlockInfoKind, decompress_frame_device
from lz4_flex_tpu_torch.frame import errors as FE
from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec
from lz4_flex_tpu_torch.ops import ringdecode as R

from .torch_inputs import incompressible, periodic_ring_boundary, word_soup

SOUP = word_soup(300000, seed=31)

FRAMES = {
    "independent_64k": FrameInfo(block_size=BlockSize.Max64KB),
    "linked_64k": FrameInfo(block_size=BlockSize.Max64KB, block_mode=BlockMode.Linked),
    "block_checksums": FrameInfo(block_size=BlockSize.Max64KB, block_checksums=True),
    "content_checksum_linked_256k": FrameInfo(
        block_size=BlockSize.Max256KB, block_mode=BlockMode.Linked, content_checksum=True
    ),
    "content_size": FrameInfo(content_size=len(SOUP), block_size=BlockSize.Max1MB),
    "legacy": FrameInfo(legacy_frame=True),
}


def _both(f: bytes) -> bytes:
    got = decompress_frame_device(f, device="cpu")
    assert LZ4Codec(device="cpu").decompress(f) == got
    return got


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_equals_reference(name):
    f = ref_frame.compress(SOUP, FRAMES[name])
    assert _both(f) == ref_frame.decompress(f) == SOUP


def test_stored_blocks_and_mixed_content():
    data = incompressible(100000) + periodic_ring_boundary()[:100000] + incompressible(70000, 3)
    for mode in (BlockMode.Independent, BlockMode.Linked):
        f = ref_frame.compress(data, FrameInfo(block_size=BlockSize.Max64KB, block_mode=mode,
                                               block_checksums=True))
        assert BlockInfo.read(f[7:11]).kind is BlockInfoKind.Uncompressed
        assert _both(f) == ref_frame.decompress(f) == data


def test_concatenated_skippable_and_empty_frames():
    a = ref_frame.compress(SOUP[:50000], FrameInfo(block_size=BlockSize.Max64KB))
    b = ref_frame.compress(SOUP[50000:120000], FrameInfo(block_mode=BlockMode.Linked))
    empty = ref_frame.compress(b"", FrameInfo(block_size=BlockSize.Max64KB))
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    legacy = ref_frame.compress(SOUP[:30000], FrameInfo(legacy_frame=True))
    want = SOUP[:120000] + SOUP[:30000]
    # the host reference reader stops at a skippable frame; the device
    # decoder skips it
    assert ref_frame.decompress(a + b + empty + legacy) == want
    assert _both(a + skip + b + empty + legacy) == want


def test_codec_config_frame_info_roundtrips():
    cfg = CodecConfig(block_size=BlockSize.Max256KB, block_mode=BlockMode.Linked,
                      content_checksum=True)
    f = ref_frame.compress(SOUP, cfg.frame_info())
    assert LZ4Codec(cfg, device="cpu").decompress(f) == SOUP


def test_flipped_payload_byte_fails_block_checksum():
    f = bytearray(ref_frame.compress(SOUP[:100000], FrameInfo(block_size=BlockSize.Max64KB,
                                                              block_checksums=True)))
    f[30] ^= 0xFF
    with pytest.raises(FE.BlockChecksumError):
        decompress_frame_device(bytes(f), device="cpu")


def test_flipped_byte_fails_content_checksum():
    f = bytearray(ref_frame.compress(b"abcd" * 10, FrameInfo(content_checksum=True)))
    f[-5] ^= 0x01  # inside the stored/compressed payload, before the end mark
    with pytest.raises(FE.FrameError):
        decompress_frame_device(bytes(f), device="cpu")


@pytest.mark.parametrize("cut", [3, 6, 12, 1000, -3])
def test_truncation_raises_frame_error(cut):
    f = ref_frame.compress(SOUP[:100000], FrameInfo(block_size=BlockSize.Max64KB,
                                                    content_checksum=True))
    with pytest.raises(FE.FrameError):
        decompress_frame_device(f[:cut], device="cpu")


def test_corrupt_block_raises_decompression_error():
    f = bytearray(ref_frame.compress(SOUP[:100000], FrameInfo(block_size=BlockSize.Max64KB)))
    # the first block's size word says less than its payload holds
    (word,) = struct.unpack_from("<I", f, 7)
    struct.pack_into("<I", f, 7, word // 2)
    with pytest.raises(FE.FrameError):
        decompress_frame_device(bytes(f), device="cpu")


@pytest.mark.parametrize("mode", [BlockMode.Independent, BlockMode.Linked])
def test_overflow_falls_to_host_decoder(monkeypatch, mode):
    """A frame body whose plan overflows decodes through the expansion
    engine on the same device (decode_parts_fused), counted in
    overflow_fused_decodes; nothing decodes on the host."""
    monkeypatch.setattr(R, "NFMAX_STEPS", (1,))
    monkeypatch.setattr(R, "NFMAX_RETRY", 1)
    monkeypatch.setattr(R, "_nfmax_hint", [1])
    monkeypatch.setattr(native, "decompress_block", None)  # any host decode would raise
    f = ref_frame.compress(SOUP, FrameInfo(block_size=BlockSize.Max64KB, block_mode=mode,
                                           content_checksum=True))
    before = dict(R.stats)
    assert decompress_frame_device(f, device="cpu") == SOUP
    assert R.stats["overflow_fused_decodes"] == before["overflow_fused_decodes"] + 1
    assert R.stats["kernel_launches"] == before["kernel_launches"]
