"""Bit-exact xxHash32.

The LZ4 frame format uses xxHash32 (seed 0) for the header-checksum byte, the
optional per-block checksums and the optional whole-content checksum
(capability parity with the reference's use of twox-hash,
src/frame/header.rs:266-269 and src/frame/compress.rs:313-321).

This module provides a dependency-free pure-Python implementation (oneshot and
streaming): the reference semantics. The frame layer hashes through the
native library (utils/checksum.py).
"""

from __future__ import annotations

import struct

PRIME32_1 = 2654435761
PRIME32_2 = 2246822519
PRIME32_3 = 3266489917
PRIME32_4 = 668265263
PRIME32_5 = 374761393

_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * PRIME32_2) & _M32
    return (_rotl32(acc, 13) * PRIME32_1) & _M32


def _finalize(h: int, tail: bytes) -> int:
    i = 0
    n = len(tail)
    while n - i >= 4:
        (lane,) = struct.unpack_from("<I", tail, i)
        h = (h + lane * PRIME32_3) & _M32
        h = (_rotl32(h, 17) * PRIME32_4) & _M32
        i += 4
    while i < n:
        h = (h + tail[i] * PRIME32_5) & _M32
        h = (_rotl32(h, 11) * PRIME32_1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * PRIME32_2) & _M32
    h ^= h >> 13
    h = (h * PRIME32_3) & _M32
    h ^= h >> 16
    return h


def xxh32(data: bytes, seed: int = 0) -> int:
    """One-shot xxHash32 of ``data`` with ``seed``."""
    n = len(data)
    if n >= 16:
        v1 = (seed + PRIME32_1 + PRIME32_2) & _M32
        v2 = (seed + PRIME32_2) & _M32
        v3 = seed & _M32
        v4 = (seed - PRIME32_1) & _M32
        nstripes = n // 16
        lanes = struct.unpack_from("<%dI" % (nstripes * 4), data)
        for s in range(nstripes):
            b = s * 4
            v1 = _round(v1, lanes[b])
            v2 = _round(v2, lanes[b + 1])
            v3 = _round(v3, lanes[b + 2])
            v4 = _round(v4, lanes[b + 3])
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & _M32
        tail = data[nstripes * 16 :]
    else:
        h = (seed + PRIME32_5) & _M32
        tail = data
    h = (h + n) & _M32
    return _finalize(h, tail)


class XxHash32:
    """Streaming xxHash32 with the same semantics as twox_hash::XxHash32.

    ``write()`` absorbs bytes, ``digest()`` returns the current 32-bit hash
    without disturbing the stream state.
    """

    __slots__ = ("_seed", "_v", "_mem", "_total")

    def __init__(self, seed: int = 0) -> None:
        self._seed = seed & _M32
        self._v = [
            (seed + PRIME32_1 + PRIME32_2) & _M32,
            (seed + PRIME32_2) & _M32,
            seed & _M32,
            (seed - PRIME32_1) & _M32,
        ]
        self._mem = b""
        self._total = 0

    def write(self, data: bytes) -> None:
        self._total += len(data)
        data = self._mem + bytes(data)
        nstripes = len(data) // 16
        if nstripes:
            v1, v2, v3, v4 = self._v
            lanes = struct.unpack_from("<%dI" % (nstripes * 4), data)
            for s in range(nstripes):
                b = s * 4
                v1 = _round(v1, lanes[b])
                v2 = _round(v2, lanes[b + 1])
                v3 = _round(v3, lanes[b + 2])
                v4 = _round(v4, lanes[b + 3])
            self._v = [v1, v2, v3, v4]
        self._mem = data[nstripes * 16 :]

    def digest(self) -> int:
        if self._total >= 16:
            v1, v2, v3, v4 = self._v
            h = (
                _rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)
            ) & _M32
        else:
            h = (self._seed + PRIME32_5) & _M32
        h = (h + self._total) & _M32
        return _finalize(h, self._mem)
