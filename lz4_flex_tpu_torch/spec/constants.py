"""LZ4 block/frame format constants.

These are the wire-format invariants of the LZ4 spec that every implementation
in this package (native host codec, device kernels) must honor.

Capability parity with lz4_flex: src/block/mod.rs:35-77 (block constants) and
src/frame/header.rs:11-34 (frame constants) in the reference.
"""

# ---------------------------------------------------------------------------
# Block format
# ---------------------------------------------------------------------------

#: Maximum lookback distance of a match (the LZ4 sliding window).
WINDOW_SIZE = 64 * 1024

#: The last match must start at least this many bytes before the end of block.
#: (lz4_Block_format.md end-of-block restrictions.)
MFLIMIT = 12

#: The last sequence of a block is literal-only and contains at least 5 bytes.
LAST_LITERALS = 5

#: Matches are never extended into the final END_OFFSET bytes of the input.
#: One byte more conservative than the spec's LAST_LITERALS, matching the
#: reference encoder's arrangement (src/block/mod.rs:52-55).
END_OFFSET = LAST_LITERALS + 1

#: Inputs shorter than this are emitted as a single literal run.
LZ4_MIN_LENGTH = MFLIMIT + 1

#: log2 of the maximum match offset.
MAXD_LOG = 16

#: Maximum match offset encodable in the 16-bit offset field.
MAX_DISTANCE = (1 << MAXD_LOG) - 1

#: Mask of the match-length nibble of a token.
MATCH_LENGTH_MASK = (1 << 4) - 1

#: Minimum length of a match.
MINMATCH = 4

#: Size threshold for choosing the 16-bit-entry hash table (byU16 mode).
LZ4_64KLIMIT = 64 * 1024 + (MFLIMIT - 1)

#: Number of slots in the standard hash table used by the greedy encoder.
HASHTABLE_SIZE_4K = 4 * 1024
HASHTABLE_BIT_SHIFT_4K = 4

#: Step-size acceleration: skip length doubles every 2**N failed probes.
INCREASE_STEPSIZE_BITSHIFT = 5

#: Knuth multiplicative hash constant for the 4-byte hash.
HASH4_PRIME = 2654435761
#: Multiplier for the 5-byte hash used with 32-bit-entry tables (64-bit arch,
#: little-endian byte order).
HASH5_PRIME_LE = 889523592379


def hash4(seq32: int) -> int:
    """Hash a 4-byte little-endian integer to 16 bits (pre-shift table key)."""
    return ((seq32 * HASH4_PRIME) & 0xFFFFFFFF) >> 16


def hash5(seq64: int) -> int:
    """Hash the low 5 bytes of an 8-byte little-endian integer to 16 bits."""
    return (((seq64 << 24) * HASH5_PRIME_LE) & 0xFFFFFFFFFFFFFFFF) >> 48


def get_maximum_output_size(input_len: int) -> int:
    """Worst-case compressed size bound (matches the reference's bound)."""
    return 16 + 4 + (input_len * 110) // 100


# ---------------------------------------------------------------------------
# Frame format
# ---------------------------------------------------------------------------

LZ4F_MAGIC_NUMBER = 0x184D2204
LZ4F_LEGACY_MAGIC_NUMBER = 0x184C2102
LZ4F_SKIPPABLE_MAGIC_MIN = 0x184D2A50
LZ4F_SKIPPABLE_MAGIC_MAX = 0x184D2A5F

MAGIC_NUMBER_SIZE = 4
MIN_FRAME_INFO_SIZE = 7
MAX_FRAME_INFO_SIZE = 19
BLOCK_INFO_SIZE = 4

#: Maximum block payload of the legacy frame format.
LEGACY_BLOCK_SIZE = 8 * 1024 * 1024

# FLG byte bits.
FLG_RESERVED_MASK = 0b0000_0010
FLG_VERSION_MASK = 0b1100_0000
FLG_SUPPORTED_VERSION_BITS = 0b0100_0000
FLG_INDEPENDENT_BLOCKS = 0b0010_0000
FLG_BLOCK_CHECKSUMS = 0b0001_0000
FLG_CONTENT_SIZE = 0b0000_1000
FLG_CONTENT_CHECKSUM = 0b0000_0100
FLG_DICTIONARY_ID = 0b0000_0001

# BD byte bits.
BD_BLOCK_SIZE_MASK = 0b0111_0000
BD_RESERVED_MASK = 0xFF ^ BD_BLOCK_SIZE_MASK
BD_BLOCK_SIZE_MASK_RSHIFT = 4

#: High bit of a BlockInfo word marks the payload as stored/uncompressed.
BLOCK_UNCOMPRESSED_SIZE_BIT = 0x8000_0000
