"""Block format: the decompress error taxonomy and the host block encoder
that the device encoder's guard falls back to (the JAX package's
``block/__init__.py`` compress half, on the native library only)."""

from __future__ import annotations

import numpy as np

from .. import native as _native
from . import errors

__all__ = ["compress", "compress_with_dict", "errors"]


def _as_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    if isinstance(data, np.ndarray):
        return data.tobytes()
    raise TypeError(f"expected bytes-like, got {type(data)!r}")


def _trim_dict(ext_dict) -> bytes:
    """The dictionary an encode may use: its last 64 KiB, or none at all
    when it holds 3 bytes or fewer (too short to hold a match)."""
    d = _as_bytes(ext_dict)
    if len(d) <= 3:
        return b""
    return d[-65536:] if len(d) > 65536 else d


def _compress_raw(data: bytes, ext_dict: bytes) -> bytes:
    use_hash5 = len(ext_dict) + len(data) >= 0xFFFF
    table = _native.new_table()
    if ext_dict:
        _native.init_dict_table(table, ext_dict, use_hash5)
    return _native.compress_block(data, ext_dict, table=table, use_hash5=use_hash5)


def compress(data) -> bytes:
    """Compress all bytes of ``data`` on the host (raw block, no size header)."""
    return _compress_raw(_as_bytes(data), b"")


def compress_with_dict(data, ext_dict) -> bytes:
    """Compress on the host with an external dictionary (its last 64 KiB)."""
    return _compress_raw(_as_bytes(data), _trim_dict(ext_dict))
