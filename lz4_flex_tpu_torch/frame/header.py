"""Frame descriptor and block-info wire structures.

Capability parity with lz4_flex src/frame/header.rs: magic numbers, FLG/BD bit
layout, content-size / dict-id options, the xxHash32 header-checksum byte, and
the 4-byte BlockInfo words (high bit = stored/uncompressed, 0 = EndMark).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field

from ..spec.constants import (
    BD_BLOCK_SIZE_MASK,
    BD_BLOCK_SIZE_MASK_RSHIFT,
    BD_RESERVED_MASK,
    BLOCK_INFO_SIZE,
    BLOCK_UNCOMPRESSED_SIZE_BIT,
    FLG_BLOCK_CHECKSUMS,
    FLG_CONTENT_CHECKSUM,
    FLG_CONTENT_SIZE,
    FLG_DICTIONARY_ID,
    FLG_INDEPENDENT_BLOCKS,
    FLG_RESERVED_MASK,
    FLG_SUPPORTED_VERSION_BITS,
    FLG_VERSION_MASK,
    LZ4F_LEGACY_MAGIC_NUMBER,
    LZ4F_MAGIC_NUMBER,
    LZ4F_SKIPPABLE_MAGIC_MAX,
    LZ4F_SKIPPABLE_MAGIC_MIN,
    MAGIC_NUMBER_SIZE,
    MIN_FRAME_INFO_SIZE,
)
from ..utils.checksum import xxh32
from . import errors


class BlockSize(enum.IntEnum):
    """Maximum uncompressed size of a data block."""

    #: Detect the optimal size from the first write call.
    Auto = 0
    Max64KB = 4
    Max256KB = 5
    Max1MB = 6
    Max4MB = 7
    Max8MB = 8

    def get_size(self) -> int:
        if self is BlockSize.Auto:
            raise ValueError("Auto block size has no fixed size")
        return {
            BlockSize.Max64KB: 64 * 1024,
            BlockSize.Max256KB: 256 * 1024,
            BlockSize.Max1MB: 1024 * 1024,
            BlockSize.Max4MB: 4 * 1024 * 1024,
            BlockSize.Max8MB: 8 * 1024 * 1024,
        }[self]

    @classmethod
    def from_buf_length(cls, buf_len: int) -> "BlockSize":
        """Pick the smallest standard size that holds ``buf_len`` (≤4MB)."""
        if buf_len > BlockSize.Max256KB.get_size():
            return BlockSize.Max4MB
        if buf_len > BlockSize.Max64KB.get_size():
            return BlockSize.Max256KB
        return BlockSize.Max64KB


class BlockMode(enum.Enum):
    #: Every block is compressed independently (the default).
    Independent = "independent"
    #: Blocks can reference the previous 64 KiB of the stream.
    Linked = "linked"


@dataclass
class FrameInfo:
    """The metadata for de/compressing with the LZ4 frame format."""

    content_size: int | None = None
    block_size: BlockSize = BlockSize.Auto
    block_mode: BlockMode = BlockMode.Independent
    block_checksums: bool = False
    content_checksum: bool = False
    legacy_frame: bool = False
    #: Read-only: dictionary-id of a parsed frame (unsupported for decode).
    dict_id: int | None = field(default=None, repr=False)

    # Chained setters for parity with the reference API.
    def with_content_size(self, content_size: int | None) -> "FrameInfo":
        self.content_size = content_size
        return self

    def with_block_size(self, block_size: BlockSize) -> "FrameInfo":
        self.block_size = block_size
        return self

    def with_block_mode(self, block_mode: BlockMode) -> "FrameInfo":
        self.block_mode = block_mode
        return self

    def with_block_checksums(self, block_checksums: bool) -> "FrameInfo":
        self.block_checksums = block_checksums
        return self

    def with_content_checksum(self, content_checksum: bool) -> "FrameInfo":
        self.content_checksum = content_checksum
        return self

    def with_legacy_frame(self, legacy: bool) -> "FrameInfo":
        self.legacy_frame = legacy
        return self

    # -- wire format --------------------------------------------------------

    @staticmethod
    def read_size(buf: bytes) -> int:
        """Total header size given at least the first 7 bytes (4 for legacy)."""
        (magic,) = struct.unpack_from("<I", buf)
        if magic == LZ4F_LEGACY_MAGIC_NUMBER:
            return MAGIC_NUMBER_SIZE
        if len(buf) < MIN_FRAME_INFO_SIZE:
            return MIN_FRAME_INFO_SIZE
        if LZ4F_SKIPPABLE_MAGIC_MIN <= magic <= LZ4F_SKIPPABLE_MAGIC_MAX:
            return 8
        if magic != LZ4F_MAGIC_NUMBER:
            raise errors.WrongMagicNumber()
        required = MIN_FRAME_INFO_SIZE
        if buf[4] & FLG_CONTENT_SIZE:
            required += 8
        if buf[4] & FLG_DICTIONARY_ID:
            required += 4
        return required

    def write_size(self) -> int:
        required = MIN_FRAME_INFO_SIZE
        if self.content_size is not None:
            required += 8
        if self.dict_id is not None:
            required += 4
        return required

    def write(self) -> bytes:
        """Serialize the frame descriptor (including the header checksum)."""
        if self.legacy_frame:
            return struct.pack("<I", LZ4F_LEGACY_MAGIC_NUMBER)
        flg = FLG_SUPPORTED_VERSION_BITS
        if self.block_checksums:
            flg |= FLG_BLOCK_CHECKSUMS
        if self.content_checksum:
            flg |= FLG_CONTENT_CHECKSUM
        if self.block_mode == BlockMode.Independent:
            flg |= FLG_INDEPENDENT_BLOCKS
        if self.content_size is not None:
            flg |= FLG_CONTENT_SIZE
        if self.dict_id is not None:
            flg |= FLG_DICTIONARY_ID
        bd = (int(self.block_size) << BD_BLOCK_SIZE_MASK_RSHIFT) & 0xFF
        body = bytearray()
        body.append(flg)
        body.append(bd)
        if self.content_size is not None:
            body += struct.pack("<Q", self.content_size)
        if self.dict_id is not None:
            body += struct.pack("<I", self.dict_id)
        hc = (xxh32(bytes(body), 0) >> 8) & 0xFF
        return struct.pack("<I", LZ4F_MAGIC_NUMBER) + bytes(body) + bytes([hc])

    @classmethod
    def read(cls, buf: bytes) -> "FrameInfo":
        """Parse a frame descriptor from ``buf`` (sized per ``read_size``)."""
        (magic,) = struct.unpack_from("<I", buf)
        if magic == LZ4F_LEGACY_MAGIC_NUMBER:
            return cls(block_size=BlockSize.Max8MB, legacy_frame=True)
        if LZ4F_SKIPPABLE_MAGIC_MIN <= magic <= LZ4F_SKIPPABLE_MAGIC_MAX:
            (user_len,) = struct.unpack_from("<I", buf, 4)
            raise errors.SkippableFrame(user_len)
        if magic != LZ4F_MAGIC_NUMBER:
            raise errors.WrongMagicNumber()

        flg, bd = buf[4], buf[5]
        if flg & FLG_VERSION_MASK != FLG_SUPPORTED_VERSION_BITS:
            raise errors.UnsupportedVersion(flg & FLG_VERSION_MASK)
        if flg & FLG_RESERVED_MASK or bd & BD_RESERVED_MASK:
            raise errors.ReservedBitsSet()

        block_mode = (
            BlockMode.Independent if flg & FLG_INDEPENDENT_BLOCKS else BlockMode.Linked
        )
        bs_code = (bd & BD_BLOCK_SIZE_MASK) >> BD_BLOCK_SIZE_MASK_RSHIFT
        if bs_code <= 3:
            raise errors.UnsupportedBlocksize(bs_code)
        block_size = BlockSize(bs_code)

        pos = 6
        content_size = None
        if flg & FLG_CONTENT_SIZE:
            (content_size,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
        dict_id = None
        if flg & FLG_DICTIONARY_ID:
            (dict_id,) = struct.unpack_from("<I", buf, pos)
            pos += 4

        expected = buf[pos]
        actual = (xxh32(bytes(buf[4:pos]), 0) >> 8) & 0xFF
        if actual != expected:
            raise errors.HeaderChecksumError()

        return cls(
            content_size=content_size,
            block_size=block_size,
            block_mode=block_mode,
            block_checksums=bool(flg & FLG_BLOCK_CHECKSUMS),
            content_checksum=bool(flg & FLG_CONTENT_CHECKSUM),
            legacy_frame=False,
            dict_id=dict_id,
        )


class BlockInfoKind(enum.Enum):
    Compressed = "compressed"
    Uncompressed = "uncompressed"
    EndMark = "endmark"


@dataclass(frozen=True)
class BlockInfo:
    kind: BlockInfoKind
    size: int = 0

    @classmethod
    def read(cls, buf: bytes) -> "BlockInfo":
        if len(buf) < BLOCK_INFO_SIZE:
            raise errors.InvalidBlockInfo()
        (word,) = struct.unpack_from("<I", buf)
        if word == 0:
            return cls(BlockInfoKind.EndMark)
        if word & BLOCK_UNCOMPRESSED_SIZE_BIT:
            return cls(
                BlockInfoKind.Uncompressed, word & ~BLOCK_UNCOMPRESSED_SIZE_BIT
            )
        return cls(BlockInfoKind.Compressed, word)

    def write(self) -> bytes:
        if self.kind is BlockInfoKind.EndMark:
            return struct.pack("<I", 0)
        if self.size == 0 and self.kind is BlockInfoKind.Compressed:
            raise errors.InvalidBlockInfo()
        if self.size & BLOCK_UNCOMPRESSED_SIZE_BIT:
            raise errors.InvalidBlockInfo()
        word = self.size
        if self.kind is BlockInfoKind.Uncompressed:
            word |= BLOCK_UNCOMPRESSED_SIZE_BIT
        return struct.pack("<I", word)
