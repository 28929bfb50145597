"""Block codec error taxonomy.

Mirrors the reference's typed error enums (lz4_flex src/block/mod.rs:82-106):
every malformed-input condition raises a typed exception, never a crash.
"""

from __future__ import annotations


class DecompressError(Exception):
    """Invalid compressed data."""


class OutputTooSmall(DecompressError):
    """The provided output buffer is too small."""

    def __init__(self, expected: int, actual: int) -> None:
        super().__init__(
            f"provided output is too small for the decompressed data, "
            f"actual {actual}, expected {expected}"
        )
        self.expected = expected
        self.actual = actual


class LiteralOutOfBounds(DecompressError):
    """A literal run extends past the end of the input."""

    def __init__(self) -> None:
        super().__init__("literal is out of bounds of the input")


class ExpectedAnotherByte(DecompressError):
    """The input ended mid-sequence."""

    def __init__(self) -> None:
        super().__init__("expected another byte, found none")


class OffsetZero(DecompressError):
    """A match offset of 0 is invalid."""

    def __init__(self) -> None:
        super().__init__("0 is not a valid match offset")


class OffsetOutOfBounds(DecompressError):
    """A match offset points before the start of the decodable window."""

    def __init__(self) -> None:
        super().__init__("the offset to copy is not contained in the decompressed buffer")


class CompressError(Exception):
    """Errors that can happen during compression."""


class CompressOutputTooSmall(CompressError):
    """The provided output buffer is too small for the compressed data."""

    def __init__(self) -> None:
        super().__init__(
            "output is too small for the compressed data, "
            "use get_maximum_output_size to reserve enough space"
        )
