"""xxHash32 through the port's native library (built at first use)."""

from __future__ import annotations

from .. import native as _native

XxHash32 = _native.NativeXxHash32


def xxh32(data, seed: int = 0) -> int:
    return _native.xxh32(data, seed)
