"""LZ4 block format: the public API (the JAX package's ``block/__init__.py``).

One-shot and into-buffer compress and decompress, the size-prepended
convenience pair, external dictionaries and a reusable compression table,
with the same names, signatures, return types and errors as the JAX
package's. Everything runs on the port's native library (``native/``),
built at first use; where it cannot build, the call raises (the JAX package
falls back to the pure-Python ``spec/golden.py``, which the port keeps only
as the differential oracle). The device paths live in ``ops/`` and
``models/``.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native as _native
from ..spec.constants import get_maximum_output_size
from . import errors
from .errors import (
    CompressError,
    CompressOutputTooSmall,
    DecompressError,
    ExpectedAnotherByte,
    LiteralOutOfBounds,
    OffsetOutOfBounds,
    OffsetZero,
    OutputTooSmall,
)

__all__ = [
    "compress",
    "compress_prepend_size",
    "compress_with_dict",
    "compress_prepend_size_with_dict",
    "compress_into",
    "compress_into_with_dict",
    "compress_into_with_table",
    "CompressTable",
    "get_maximum_output_size",
    "decompress",
    "decompress_size_prepended",
    "decompress_with_dict",
    "decompress_size_prepended_with_dict",
    "decompress_into",
    "decompress_into_with_dict",
    "uncompressed_size",
    "errors",
    "CompressError",
    "CompressOutputTooSmall",
    "DecompressError",
    "ExpectedAnotherByte",
    "LiteralOutOfBounds",
    "OffsetOutOfBounds",
    "OffsetZero",
    "OutputTooSmall",
]


def _as_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    if isinstance(data, np.ndarray):
        return data.tobytes()
    raise TypeError(f"expected bytes-like, got {type(data)!r}")


def _writable_u8(output) -> np.ndarray:
    """View a writable bytes-like as a uint8 array without copying."""
    if isinstance(output, np.ndarray):
        if output.dtype != np.uint8 or not output.flags.c_contiguous:
            raise TypeError("output array must be contiguous uint8")
        return output
    mv = memoryview(output)
    if mv.readonly:
        raise TypeError("output buffer is read-only")
    return np.frombuffer(mv, dtype=np.uint8)


def _trim_dict(ext_dict) -> bytes:
    """The dictionary an encode may use: its last 64 KiB, or none at all
    when it holds 3 bytes or fewer (too short to hold a match)."""
    d = _as_bytes(ext_dict)
    if len(d) <= 3:
        return b""
    return d[-65536:] if len(d) > 65536 else d


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def _compress_raw(data: bytes, ext_dict: bytes, out: np.ndarray | None = None):
    use_hash5 = len(ext_dict) + len(data) >= 0xFFFF
    table = _native.new_table()
    if ext_dict:
        _native.init_dict_table(table, ext_dict, use_hash5)
    return _native.compress_block(data, ext_dict, table=table, use_hash5=use_hash5, out=out)


def _output_for(data: bytes, output) -> np.ndarray:
    """``output`` as a uint8 array, checked to hold the worst case of
    compressing ``data``."""
    out = _writable_u8(output)
    if out.size < get_maximum_output_size(len(data)):
        raise CompressOutputTooSmall()
    return out


def compress(data) -> bytes:
    """Compress all bytes of ``data`` (raw block, no size header)."""
    return _compress_raw(_as_bytes(data), b"")


def compress_prepend_size(data) -> bytes:
    """Compress with the uncompressed size prepended as little-endian u32."""
    data = _as_bytes(data)
    return struct.pack("<I", len(data)) + _compress_raw(data, b"")


def compress_with_dict(data, ext_dict) -> bytes:
    """Compress with an external dictionary (its last 64 KiB are used)."""
    return _compress_raw(_as_bytes(data), _trim_dict(ext_dict))


def compress_prepend_size_with_dict(data, ext_dict) -> bytes:
    data = _as_bytes(data)
    return struct.pack("<I", len(data)) + _compress_raw(data, _trim_dict(ext_dict))


def compress_into(data, output) -> int:
    """Compress into a preallocated buffer (>= get_maximum_output_size).

    Returns the number of compressed bytes written.
    """
    data = _as_bytes(data)
    return _compress_raw(data, b"", _output_for(data, output))


def compress_into_with_dict(data, output, ext_dict) -> int:
    data = _as_bytes(data)
    return _compress_raw(data, _trim_dict(ext_dict), _output_for(data, output))


class CompressTable:
    """A reusable compression table that avoids re-allocating the internal
    hash table on every call.

    ``small()`` uses the 4-byte hash (inputs < 64 KiB); ``large()`` the 5-byte
    hash. A small table is upgraded when a large input arrives.
    """

    __slots__ = ("_table", "_large")

    def __init__(self, large: bool = False) -> None:
        self._table = _native.new_table()
        self._large = large

    @classmethod
    def small(cls) -> "CompressTable":
        return cls(large=False)

    @classmethod
    def large(cls) -> "CompressTable":
        return cls(large=True)

    @property
    def is_large(self) -> bool:
        return self._large


def compress_into_with_table(data, output, table: CompressTable) -> int:
    """Compress into ``output`` reusing ``table``'s hash table allocation."""
    data = _as_bytes(data)
    out = _output_for(data, output)
    if len(data) >= 0xFFFF and not table._large:
        table._large = True
    table._table[:] = 0
    return _native.compress_block(data, table=table._table, use_hash5=table._large, out=out)


# ---------------------------------------------------------------------------
# Decompression
# ---------------------------------------------------------------------------


def decompress(data, min_uncompressed_size: int) -> bytes:
    """Decompress a raw block into a new buffer of at most
    ``min_uncompressed_size`` bytes (must be >= the real uncompressed size)."""
    return _native.decompress_block(_as_bytes(data), min_uncompressed_size)


def decompress_with_dict(data, min_uncompressed_size: int, ext_dict) -> bytes:
    return _native.decompress_block(_as_bytes(data), min_uncompressed_size, _as_bytes(ext_dict))


def uncompressed_size(data) -> tuple[int, bytes]:
    """Read the little-endian u32 size prefix; returns (size, rest)."""
    data = _as_bytes(data)
    if len(data) < 4:
        raise ExpectedAnotherByte()
    (size,) = struct.unpack_from("<I", data)
    return size, data[4:]


def decompress_size_prepended(data) -> bytes:
    size, rest = uncompressed_size(data)
    return decompress(rest, size)


def decompress_size_prepended_with_dict(data, ext_dict) -> bytes:
    size, rest = uncompressed_size(data)
    return decompress_with_dict(rest, size, ext_dict)


def decompress_into(data, output) -> int:
    """Decompress into a preallocated buffer; returns bytes written."""
    out = _writable_u8(output)
    return _native.decompress_block(_as_bytes(data), out.size, out=out)


def decompress_into_with_dict(data, output, ext_dict) -> int:
    out = _writable_u8(output)
    return _native.decompress_block(_as_bytes(data), out.size, _as_bytes(ext_dict), out=out)
