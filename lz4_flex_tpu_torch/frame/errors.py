"""Frame format error taxonomy (parity with lz4_flex src/frame/mod.rs:35-103)."""

from __future__ import annotations

from ..block.errors import CompressError, DecompressError

__all__ = [
    "FrameError",
    "WrongMagicNumber",
    "UnsupportedBlocksize",
    "UnsupportedVersion",
    "ReservedBitsSet",
    "InvalidBlockInfo",
    "BlockTooBig",
    "HeaderChecksumError",
    "BlockChecksumError",
    "ContentChecksumError",
    "SkippableFrame",
    "DictionaryNotSupported",
    "ContentLengthError",
    "CompressionError",
    "DecompressionError",
]


class FrameError(Exception):
    """Errors that can occur when de/compressing lz4 frames."""


class WrongMagicNumber(FrameError):
    def __init__(self) -> None:
        super().__init__("wrong magic number for the LZ4 frame format")


class UnsupportedBlocksize(FrameError):
    def __init__(self, code: int) -> None:
        super().__init__(f"unsupported block size code {code}")
        self.code = code


class UnsupportedVersion(FrameError):
    def __init__(self, version_bits: int) -> None:
        super().__init__(f"unsupported frame version bits {version_bits:#04x}")
        self.version_bits = version_bits


class ReservedBitsSet(FrameError):
    def __init__(self) -> None:
        super().__init__("reserved bits set in frame descriptor")


class InvalidBlockInfo(FrameError):
    def __init__(self) -> None:
        super().__init__("block header is malformed")


class BlockTooBig(FrameError):
    def __init__(self) -> None:
        super().__init__("read a block larger than specified in the frame header")


class HeaderChecksumError(FrameError):
    def __init__(self) -> None:
        super().__init__("the frame header checksum doesn't match")


class BlockChecksumError(FrameError):
    def __init__(self) -> None:
        super().__init__("the block checksum doesn't match")


class ContentChecksumError(FrameError):
    def __init__(self) -> None:
        super().__init__("the content checksum doesn't match")


class SkippableFrame(FrameError):
    """Read a skippable frame.

    The caller may read ``size`` bytes from the underlying stream to skip it.
    """

    def __init__(self, size: int) -> None:
        super().__init__(f"skippable frame of {size} bytes")
        self.size = size


class DictionaryNotSupported(FrameError):
    def __init__(self) -> None:
        super().__init__("external dictionaries (dict-id) are not supported")


class ContentLengthError(FrameError):
    def __init__(self, expected: int, actual: int) -> None:
        super().__init__(f"content length differs: expected {expected}, actual {actual}")
        self.expected = expected
        self.actual = actual


class CompressionError(FrameError):
    """A block-level compression error inside the frame layer."""

    def __init__(self, inner: CompressError) -> None:
        super().__init__(str(inner))
        self.inner = inner


class DecompressionError(FrameError):
    """A block-level decompression error inside the frame layer."""

    def __init__(self, inner: DecompressError) -> None:
        super().__init__(str(inner))
        self.inner = inner
