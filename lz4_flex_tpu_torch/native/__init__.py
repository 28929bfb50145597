"""ctypes bindings for the port's copy of the native host runtime
(lz4_native.cpp): the ring-plan builder, the token-walk decoder, the
size-only measure walk and verify walk, the sequence parser, xxHash32, the
block encoder with its carried (or dictionary-seeded) match table, and the
hybrid encoder's host walks over device candidate planes.

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
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def build_cached(src: str, stem: str, cmd_for, deps=()) -> str:
    """Compile ``src`` into ``BUILD_DIR/<stem>_<hash>.so`` unless that file
    exists already; return its path. The hash covers ``src`` and the files
    it includes, listed in ``deps``.

    ``cmd_for(out_path)`` gives the compiler command line. A file lock in the
    build directory keeps concurrent processes (test workers) from compiling
    the same source at once; the output is renamed into place atomically.
    Raises RuntimeError with the compiler's stderr when the build fails.
    """
    h = hashlib.sha256()
    for path in (src, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
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
                lib.tlz4_init_dict_table.restype = None
                lib.tlz4_init_dict_table.argtypes = [_u64p, _u8p, ctypes.c_size_t, ctypes.c_int]
                lib.tlz4_compress_block.restype = ctypes.c_int64
                lib.tlz4_compress_block.argtypes = [
                    _u8p, ctypes.c_size_t, ctypes.c_size_t,
                    _u8p, ctypes.c_size_t,
                    _u8p, ctypes.c_size_t,
                    ctypes.c_uint64, _u64p, ctypes.c_int,
                ]
                lib.tlz4_compress_with_candidates.restype = ctypes.c_int64
                lib.tlz4_compress_with_candidates.argtypes = [
                    _u8p, ctypes.c_int64, ctypes.c_int64,
                    _u32p, _u32p,
                    _i64p, _i32p, ctypes.c_int32, ctypes.c_int64,
                    _u8p, ctypes.c_int64,
                ]
                lib.tlz4_hybrid_walk_chunk.restype = ctypes.c_int64
                lib.tlz4_hybrid_walk_chunk.argtypes = [
                    _u8p, ctypes.c_int64,
                    _u16p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int32,
                    _u8p, ctypes.c_int64, ctypes.c_int32, _i64p,
                ]
                lib.tlz4_hybrid_stitch.restype = ctypes.c_int64
                lib.tlz4_hybrid_stitch.argtypes = [
                    _u8p, ctypes.c_int64,
                    _u8p, _i64p, _i64p, _i64p, _i64p, ctypes.c_int32,
                    _u8p, ctypes.c_int64,
                ]
                lib.tlz4_decompress_block.restype = ctypes.c_int64
                lib.tlz4_decompress_block.argtypes = [
                    _u8p, ctypes.c_size_t,
                    _u8p, ctypes.c_size_t, ctypes.c_size_t,
                    _u8p, ctypes.c_size_t, _u64p,
                ]
                lib.tlz4_measure_block.restype = ctypes.c_int64
                lib.tlz4_measure_block.argtypes = [_u8p, ctypes.c_size_t]
                lib.tlz4_verify_block.restype = ctypes.c_int64
                lib.tlz4_verify_block.argtypes = [
                    _u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t,
                ]
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


def new_table() -> np.ndarray:
    """A fresh (zeroed) 4096-entry match table."""
    return np.zeros(4096, dtype=np.uint64)


def _check_table(table: np.ndarray) -> None:
    if table.dtype != np.uint64 or table.shape != (4096,) or not table.flags.c_contiguous:
        raise ValueError("table must be a contiguous (4096,) uint64 array (see new_table)")


def _compress_too_small():
    from ..block.errors import CompressOutputTooSmall

    return CompressOutputTooSmall()


def init_dict_table(table: np.ndarray, ext_dict, use_hash5: bool) -> None:
    """Seed a match table with the positions of a dictionary, for an encode
    that reaches into it (``compress_block(..., ext_dict=..., table=...)``)."""
    _check_table(table)
    d = as_u8(ext_dict)
    _lib().tlz4_init_dict_table(table.ctypes.data_as(_u64p), _ptr(d), d.size, int(use_hash5))


def compress_block(
    data,
    ext_dict=b"",
    input_pos: int = 0,
    input_stream_offset: int | None = None,
    table: np.ndarray | None = None,
    use_hash5: bool | None = None,
    out: np.ndarray | None = None,
) -> bytes | int:
    """Greedy block encode of ``data[input_pos:]`` against an optional
    dictionary (the previous 64 KiB of a linked frame).

    The parameters are the JAX package's ``native.compress_block``, with
    ``ext_dict`` second so that ``compress_block(data, dic)`` reads as
    before. A streaming encoder keeps the window in ``data[:input_pos]``
    and carries ``table`` (see :func:`new_table`) across blocks, with
    ``input_stream_offset`` the stream position of ``data[0]``. Returns the
    bytes, or, given a contiguous uint8 ``out`` buffer, writes them there
    and returns their count."""
    src = as_u8(data)
    dic = as_u8(ext_dict)
    if not 0 <= input_pos <= src.size:
        raise ValueError(f"input_pos {input_pos} outside the input (size {src.size})")
    if input_stream_offset is None:
        input_stream_offset = dic.size
    if use_hash5 is None:
        use_hash5 = dic.size + src.size >= 0xFFFF
    if table is None:
        table = new_table()
    _check_table(table)
    return_bytes = out is None
    if return_bytes:
        out = np.empty(compress_bound(src.size - input_pos), dtype=np.uint8)
    out = _c_array(out, np.uint8, "out")
    n = _lib().tlz4_compress_block(
        _ptr(src), src.size, input_pos,
        _ptr(out), out.size,
        _ptr(dic), dic.size,
        input_stream_offset,
        table.ctypes.data_as(_u64p), int(use_hash5),
    )
    if n < 0:
        raise _compress_too_small()
    return out[:n].tobytes() if return_bytes else int(n)


def _c_array(arr: np.ndarray, dtype, name: str) -> np.ndarray:
    if arr.dtype != dtype or not arr.flags.c_contiguous:
        raise ValueError(f"{name} must be a contiguous {np.dtype(dtype).name} array")
    return arr


def compress_with_candidates(G: np.ndarray, dict_len: int, d12: np.ndarray, d34: np.ndarray,
                             gstart: np.ndarray, dvec: np.ndarray) -> bytes:
    """The hybrid encoder's host walk over whole candidate rows: ``G`` is the
    dictionary (its first ``dict_len`` bytes) followed by the data, ``d12``
    and ``d34`` the (nrows, pad) uint32 candidate planes of ``candidates_core``
    whose row r starts at ``G[gstart[r]]`` with ``dvec[r]`` bytes of
    dictionary. Every candidate is re-extended with exact byte compares."""
    G = _c_array(G, np.uint8, "G")
    d12, d34 = _c_array(d12, np.uint32, "d12"), _c_array(d34, np.uint32, "d34")
    gstart, dvec = _c_array(gstart, np.int64, "gstart"), _c_array(dvec, np.int32, "dvec")
    nrows, pad = d12.shape
    if d34.shape != d12.shape or gstart.shape != (nrows,) or dvec.shape != (nrows,):
        raise ValueError("d12, d34, gstart and dvec must agree on the row count")
    if nrows * pad < G.size - int(gstart[0]):
        raise ValueError("the candidate rows do not cover the input")
    cap = compress_bound(G.size - dict_len)
    out = np.empty(cap, np.uint8)
    n = _lib().tlz4_compress_with_candidates(
        _ptr(G), G.size, dict_len,
        d12.ctypes.data_as(_u32p), d34.ctypes.data_as(_u32p),
        gstart.ctypes.data_as(_i64p), dvec.ctypes.data_as(_i32p), nrows, pad,
        _ptr(out), cap,
    )
    if n < 0:
        raise _compress_too_small()
    return out[:n].tobytes()


def hybrid_walk_chunk(G: np.ndarray, plane: np.ndarray, row_gstart: int, chunk_start: int,
                      chunk_limit: int, pool_shift: int, out: np.ndarray,
                      final_chunk: bool) -> tuple[int, int]:
    """One self-contained chunk walk of the streaming hybrid encoder: the
    sequences whose cursor starts in ``[chunk_start, chunk_limit)`` of
    ``G``, probing the pooled uint16 best-delta ``plane`` of the chunk row
    that starts at ``G[row_gstart]``. Writes the wire into ``out`` and
    returns (length, start of the pending literal tail); the tail of a
    non-final chunk is left for :func:`hybrid_stitch`. Releases the GIL, so
    walks run concurrently on threads."""
    G = _c_array(G, np.uint8, "G")
    plane = _c_array(plane, np.uint16, "plane")
    out = _c_array(out, np.uint8, "out")
    if not 0 <= row_gstart <= chunk_start <= chunk_limit <= G.size:
        raise ValueError("chunk bounds outside the input")
    tail = np.zeros(1, np.int64)
    n = _lib().tlz4_hybrid_walk_chunk(
        _ptr(G), G.size,
        plane.ctypes.data_as(_u16p), row_gstart, chunk_start, chunk_limit,
        plane.size, pool_shift,
        _ptr(out), out.size, int(final_chunk), tail.ctypes.data_as(_i64p),
    )
    if n < 0:
        raise _compress_too_small()
    return int(n), int(tail[0])


def hybrid_stitch(G: np.ndarray, wires: np.ndarray, wire_off: np.ndarray, wire_len: np.ndarray,
                  chunk_start: np.ndarray, tails: np.ndarray, cap: int) -> bytes:
    """Assemble the chunk walks' wires (``wires[wire_off[i]:][:wire_len[i]]``)
    into one block: each pending literal tail merges into the next chunk's
    first sequence."""
    G, wires = _c_array(G, np.uint8, "G"), _c_array(wires, np.uint8, "wires")
    arrs = [_c_array(a, np.int64, name) for a, name in (
        (wire_off, "wire_off"), (wire_len, "wire_len"), (chunk_start, "chunk_start"),
        (tails, "tails"))]
    nchunks = wire_off.shape[0]
    if any(a.shape != (nchunks,) for a in arrs):
        raise ValueError("the per-chunk arrays must have one length")
    if nchunks and int((wire_off + wire_len).max()) > wires.size:
        raise ValueError("a chunk wire lies outside the wire buffer")
    out = np.empty(cap, np.uint8)
    n = _lib().tlz4_hybrid_stitch(
        _ptr(G), G.size, _ptr(wires), *(a.ctypes.data_as(_i64p) for a in arrs), nchunks,
        _ptr(out), cap,
    )
    if n < 0:
        raise _compress_too_small()
    return out[:n].tobytes()


def decompress_block(data, max_output_size: int, ext_dict=b"",
                     out: np.ndarray | None = None, out_pos: int = 0) -> bytes | int:
    """Token-walk block decode into at most ``max_output_size`` bytes.

    Returns the bytes, or, given a contiguous uint8 ``out`` buffer, writes
    them at ``out[out_pos:]`` (never past ``out.size``) and returns their
    count."""
    src = as_u8(data)
    dic = as_u8(ext_dict)
    return_bytes = out is None
    if return_bytes:
        out = np.empty(max_output_size, dtype=np.uint8)
        cap = max_output_size
    else:
        out = _c_array(out, np.uint8, "out")
        if not 0 <= out_pos <= out.size:
            raise ValueError(f"out_pos {out_pos} outside the output (size {out.size})")
        cap = min(out_pos + max_output_size, out.size)
    expected = ctypes.c_uint64(0)
    n = _lib().tlz4_decompress_block(
        _ptr(src), src.size,
        _ptr(out), out_pos, cap,
        _ptr(dic), dic.size,
        ctypes.byref(expected),
    )
    if n < 0:
        _raise_decompress_error(int(n), int(expected.value), max_output_size)
    return out[out_pos : out_pos + n].tobytes() if return_bytes else int(n)


def measure_block(data) -> int:
    """Decoded size of one block via the size-only token walk. Raises the
    block error taxonomy on structural errors."""
    src = as_u8(data)
    n = _lib().tlz4_measure_block(_ptr(src), src.size)
    if n < 0:
        _raise_decompress_error(int(n), 0, 0)
    return int(n)


def verify_block(comp, ref, ext_dict=b"") -> bool:
    """True when ``comp`` decodes (against ``ext_dict``) to exactly ``ref``,
    checked in one token walk that writes nothing: the guard of the device
    encoder, whose fingerprinted match lengths may, on a collision, claim a
    match that is not there."""
    src, refa, dic = as_u8(comp), as_u8(ref), as_u8(ext_dict)
    return _lib().tlz4_verify_block(
        _ptr(src), src.size, _ptr(refa), refa.size, _ptr(dic), dic.size) >= 0


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
