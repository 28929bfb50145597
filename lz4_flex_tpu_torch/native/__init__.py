"""ctypes bindings for the port's copy of the native host runtime
(lz4_native.cpp): the ring-plan builder, the token-walk decoder, the
size-only measure walk, the sequence parser, xxHash32 and the block encoder.

The shared library is compiled with g++ at first use into the checkout's
``build/`` directory, keyed by a hash of the source, so a fresh checkout
builds itself. Nothing is compiled or loaded at import time.
All entry points take and return numpy buffers.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "lz4_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

# Error codes (keep in sync with lz4_native.cpp).
ERR_OUTPUT_TOO_SMALL = -1
ERR_LITERAL_OOB = -2
ERR_EXPECTED_ANOTHER_BYTE = -3
ERR_OFFSET_ZERO = -4
ERR_OFFSET_OOB = -5

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def build_cached(src: str, stem: str, cmd_for) -> str:
    """Compile ``src`` into ``BUILD_DIR/<stem>_<hash>.so`` unless that file
    exists already; return its path.

    ``cmd_for(out_path)`` gives the compiler command line. A file lock in the
    build directory keeps concurrent processes (test workers) from compiling
    the same source at once; the output is renamed into place atomically.
    Raises RuntimeError with the compiler's stderr when the build fails.
    """
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"{stem}_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    with open(os.path.join(BUILD_DIR, f"{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so_path):
            tmp = f"{so_path}.tmp.{os.getpid()}"
            r = subprocess.run(cmd_for(tmp), capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"building {os.path.basename(src)} failed "
                    f"(exit {r.returncode}):\n{r.stderr}"
                )
            with open(so_path + ".log", "w") as log:
                log.write(r.stdout + r.stderr)
            os.replace(tmp, so_path)
    return so_path


def _build() -> str:
    return build_cached(
        _SRC, "lz4_native",
        lambda out: [
            "g++", "-O3", "-march=native", "-funroll-loops", "-shared",
            "-fPIC", "-fvisibility=hidden", "-std=c++17", "-pthread",
            _SRC, "-o", out,
        ],
    )


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(_build())
                lib.tlz4_compress_block.restype = ctypes.c_int64
                lib.tlz4_compress_block.argtypes = [
                    _u8p, ctypes.c_size_t, ctypes.c_size_t,
                    _u8p, ctypes.c_size_t,
                    _u8p, ctypes.c_size_t,
                    ctypes.c_uint64, _u64p, ctypes.c_int,
                ]
                lib.tlz4_decompress_block.restype = ctypes.c_int64
                lib.tlz4_decompress_block.argtypes = [
                    _u8p, ctypes.c_size_t,
                    _u8p, ctypes.c_size_t, ctypes.c_size_t,
                    _u8p, ctypes.c_size_t, _u64p,
                ]
                lib.tlz4_measure_block.restype = ctypes.c_int64
                lib.tlz4_measure_block.argtypes = [_u8p, ctypes.c_size_t]
                lib.tlz4_parse_sequences.restype = ctypes.c_int64
                lib.tlz4_parse_sequences.argtypes = [
                    _u8p, ctypes.c_size_t,
                    _i32p, _i32p, _i32p, _i32p, _i32p,
                    ctypes.c_int64, _i64p,
                ]
                lib.tlz4_xxh32.restype = ctypes.c_uint32
                lib.tlz4_xxh32.argtypes = [_u8p, ctypes.c_size_t, ctypes.c_uint32]
                lib.tlz4_xxh32_reset.restype = None
                lib.tlz4_xxh32_reset.argtypes = [_u32p, ctypes.c_uint32]
                lib.tlz4_xxh32_update.restype = None
                lib.tlz4_xxh32_update.argtypes = [_u32p, _u8p, ctypes.c_size_t]
                lib.tlz4_xxh32_digest.restype = ctypes.c_uint32
                lib.tlz4_xxh32_digest.argtypes = [_u32p]
                lib.tlz4_build_ring_plan2.restype = ctypes.c_int64
                lib.tlz4_build_ring_plan2.argtypes = [
                    _u8p, ctypes.c_size_t,
                    _i64p, _i64p, _u8p, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32,
                    _i32p, _i32p, _i32p, _i32p, _i32p, _u8p,
                    _i64p,
                ]
                _LIB = lib
    return _LIB


def as_u8(buf) -> np.ndarray:
    """View a bytes-like or ndarray as a contiguous uint8 array (no copy when
    possible)."""
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf, dtype=np.uint8)
    return np.frombuffer(buf, dtype=np.uint8) if len(buf) else np.empty(0, np.uint8)


_EMPTY = np.zeros(1, dtype=np.uint8)  # non-null pointer for zero-length buffers


def _ptr(arr: np.ndarray):
    if arr.size == 0:
        return _EMPTY.ctypes.data_as(_u8p)
    return arr.ctypes.data_as(_u8p)


def compress_bound(n: int) -> int:
    return 16 + 4 + (n * 110) // 100


def compress_block(data, ext_dict=b"") -> bytes:
    """Greedy block encode of ``data`` against an optional dictionary (the
    previous 64 KiB of a linked frame)."""
    src = as_u8(data)
    dic = as_u8(ext_dict)
    out = np.empty(compress_bound(src.size), dtype=np.uint8)
    table = np.zeros(4096, dtype=np.uint64)
    n = _lib().tlz4_compress_block(
        _ptr(src), src.size, 0,
        _ptr(out), out.size,
        _ptr(dic), dic.size,
        dic.size,
        table.ctypes.data_as(_u64p), int(dic.size + src.size >= 0xFFFF),
    )
    if n < 0:
        from ..block.errors import CompressOutputTooSmall

        raise CompressOutputTooSmall()
    return out[:n].tobytes()


def decompress_block(data, max_output_size: int, ext_dict=b"") -> bytes:
    """Token-walk block decode into at most ``max_output_size`` bytes."""
    src = as_u8(data)
    dic = as_u8(ext_dict)
    out = np.empty(max_output_size, dtype=np.uint8)
    expected = ctypes.c_uint64(0)
    n = _lib().tlz4_decompress_block(
        _ptr(src), src.size,
        _ptr(out), 0, max_output_size,
        _ptr(dic), dic.size,
        ctypes.byref(expected),
    )
    if n < 0:
        _raise_decompress_error(int(n), int(expected.value), max_output_size)
    return out[:n].tobytes()


def measure_block(data) -> int:
    """Decoded size of one block via the size-only token walk. Raises the
    block error taxonomy on structural errors."""
    src = as_u8(data)
    n = _lib().tlz4_measure_block(_ptr(src), src.size)
    if n < 0:
        _raise_decompress_error(int(n), 0, 0)
    return int(n)


def _raise_decompress_error(code: int, expected: int, actual: int):
    from ..block import errors as E

    if code == ERR_OUTPUT_TOO_SMALL:
        raise E.OutputTooSmall(expected, actual)
    if code == ERR_LITERAL_OOB:
        raise E.LiteralOutOfBounds()
    if code == ERR_EXPECTED_ANOTHER_BYTE:
        raise E.ExpectedAnotherByte()
    if code == ERR_OFFSET_ZERO:
        raise E.OffsetZero()
    if code == ERR_OFFSET_OOB:
        raise E.OffsetOutOfBounds()
    raise E.DecompressError(f"unknown native error {code}")


def parse_sequences(data, max_seqs: int | None = None):
    """Parse a block into parallel sequence arrays.

    Returns (lit_start, lit_len, match_off, match_len, out_off, total_out),
    each an int32 array of length nseq.
    """
    src = as_u8(data)
    if max_seqs is None:
        # A sequence is at least 3 bytes (token + offset), +1 final record.
        max_seqs = src.size // 3 + 2
    arrs = [np.empty(max_seqs, dtype=np.int32) for _ in range(5)]
    total = ctypes.c_int64(0)
    n = _lib().tlz4_parse_sequences(
        _ptr(src), src.size,
        *(a.ctypes.data_as(_i32p) for a in arrs),
        max_seqs, ctypes.byref(total),
    )
    if n < 0:
        _raise_decompress_error(int(n), 0, 0)
    n = int(n)
    return (*(a[:n] for a in arrs), int(total.value))


def xxh32(data, seed: int = 0) -> int:
    src = as_u8(data)
    return int(_lib().tlz4_xxh32(_ptr(src), src.size, seed))


class NativeXxHash32:
    """Streaming xxHash32 backed by the native library."""

    __slots__ = ("_state",)

    def __init__(self, seed: int = 0) -> None:
        self._state = np.zeros(11, dtype=np.uint32)
        _lib().tlz4_xxh32_reset(self._state.ctypes.data_as(_u32p), seed)

    def write(self, data) -> None:
        src = as_u8(data)
        _lib().tlz4_xxh32_update(self._state.ctypes.data_as(_u32p), _ptr(src), src.size)

    def digest(self) -> int:
        return int(_lib().tlz4_xxh32_digest(self._state.ctypes.data_as(_u32p)))
