"""The generator, the frozen encoder and the plain reference decoder."""

import numpy as np
import pytest

from portbench.gen import frozen, text
from portbench.reference import lz4_ref


def test_text_is_deterministic_per_seed():
    a = text.zipf_text(2**31 + 12345, 200_000)
    b = text.zipf_text(2**31 + 12345, 200_000)
    c = text.zipf_text(2**31 + 12346, 200_000)
    assert a.dtype == np.uint8 and a.size == 200_000
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    letters = set(np.unique(a).tolist())
    assert letters <= set(range(ord("a"), ord("z") + 1)) | {ord(" ")}
    words = a.tobytes().split(b" ")[1:-1]
    assert min(map(len, words)) >= 2 and max(map(len, words)) <= 10


def test_sizes_are_one_set_for_every_seed():
    s = text.log_uniform_sizes(32, 1 << 20, 16 << 20)
    assert s == sorted(s) and len(s) == 32 and s[0] > 1 << 20 and s[-1] < 16 << 20
    assert text.log_uniform_sizes(32, 1 << 20, 16 << 20) == s


@pytest.mark.parametrize("block_size,checksum", [(65536, False), (4 << 20, True), (65536, True)])
def test_reference_decodes_frozen_frames_exactly(block_size, checksum):
    data = text.zipf_text(7, (5 << 20) + 12345 if block_size > 65536 else 700_000)
    f = frozen.frame(data, block_size=block_size, content_checksum=checksum)
    hdr, content, sizes = lz4_ref.decode_frame(f)
    assert content == data.tobytes()
    assert hdr["block_size"] == block_size and hdr["independent"]
    assert hdr["content_checksum"] == checksum
    assert max(sizes) == block_size and sum(sizes) == data.size
    if checksum:
        assert hdr["content_checksum_value"] == frozen.xxh32(data)
    cfg = dict(block_size=block_size, block_mode="independent", block_checksums=False,
               content_checksum=checksum, content_size=False)
    assert lz4_ref.check_frame(f, data.tobytes(), cfg, frozen.xxh32(data) if checksum else None) == {
        "frames_bad": 0, "header_mismatch": 0, "wrong_bytes": 0}


def test_stored_blocks_and_block_checksums():
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, 200_000, dtype=np.uint8)  # does not compress: stored blocks
    f = frozen.frame(noise, block_size=65536, block_checksums=True)
    assert lz4_ref.decode_frame(f)[1] == noise.tobytes()
    bad = bytearray(f)
    bad[20] ^= 1
    with pytest.raises(lz4_ref.RefError):
        lz4_ref.decode_frame(bytes(bad))


def test_overlapping_matches_and_raw_blocks():
    data = (b"ab" * 5000 + b"xyz" * 3000 + bytes(4000) + b"the end of it")
    block = frozen.compress_block(data)
    out = bytearray()
    lz4_ref.decode_block(block, out, 0)
    assert bytes(out) == data
    wrong = bytearray()
    lz4_ref.decode_block(block, wrong, 0, overlap_as_memmove=True)
    assert lz4_ref.wrong_bytes(bytes(wrong), data) > 0


def test_reference_rejects_what_breaks_the_header():
    data = text.zipf_text(9, 400_000)
    linked = frozen.frame(data, block_size=65536, link_blocks=True)
    with pytest.raises(lz4_ref.RefError, match="window"):
        lz4_ref.decode_frame(linked)
    f = bytearray(frozen.frame(data, block_size=65536))
    f[6] ^= 0xFF  # header checksum
    with pytest.raises(lz4_ref.RefError, match="header checksum"):
        lz4_ref.decode_frame(bytes(f))
    with pytest.raises(lz4_ref.RefError):
        lz4_ref.decode_frame(bytes(f[:-3]))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 15, 16, 17, 100, 1000, 65537])
def test_xxh32_native_matches_plain(n):
    data = text.zipf_text(n + 1, max(n, 1))[:n].tobytes()
    assert frozen.xxh32(data, 0) == lz4_ref.xxh32(data, 0)
    assert frozen.xxh32(data, 2**32 - 7) == lz4_ref.xxh32(data, 2**32 - 7)


def test_xxh32_known_values():
    assert lz4_ref.xxh32(b"") == 0x02CC5D05
    assert frozen.xxh32(b"abc") == 0x32D153FF


def test_threaded_blocks_equal_one_at_a_time():
    data = text.zipf_text(4, 1_000_003)
    assert frozen.compress_blocks(data, 65536) == [
        frozen.compress_block(data[i : i + 65536]) for i in range(0, data.size, 65536)]


def _seq(lit: bytes, off: int = 0, mlen: int = 0) -> bytes:
    """One sequence with fewer than 15 literals and a match under 19 bytes
    (``mlen`` 0: the last sequence, literals only)."""
    tok = (len(lit) << 4) | (mlen - 4 if mlen else 0)
    return bytes([tok]) + lit + (off.to_bytes(2, "little") if mlen else b"")


@pytest.mark.parametrize("block,rule", [
    (_seq(b"abcd", 4, 16) + _seq(b"xyz"), "fewer than 5"),  # ends with 3 literals
    (_seq(b"abcdefgh", 4, 4) + _seq(b"12345"), "fewer than 12"),  # last match 9 bytes from the end
])
def test_reference_enforces_the_end_of_block_rules(block, rule):
    with pytest.raises(lz4_ref.RefError, match=rule):
        lz4_ref.decode_block(block, bytearray(), 0)


def test_blocks_within_the_end_of_block_rules_decode():
    out = bytearray()
    lz4_ref.decode_block(_seq(b"abcdefgh", 8, 8) + _seq(b"0123456789ab"), out, 0)
    assert bytes(out) == b"abcdefgh" * 2 + b"0123456789ab"
    for short in (b"", b"abc"):  # a block of literals alone may be short
        out = bytearray()
        lz4_ref.decode_block(_seq(short), out, 0)
        assert bytes(out) == short
