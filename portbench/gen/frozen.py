"""The benchmark's frozen LZ4 encoder: raw blocks and frames.

``lz4_frozen.cpp`` (a plain greedy block compressor and xxHash32) is built
with g++ at first use into ``portbench/.cache/``, a fixed directory inside
the checkout keyed by a hash of the source, and bound with ctypes. It makes
the decode cells' inputs, so those stay the same bytes whatever the port's
encoder does, and the xxHash32 of inputs that the frame checks compare
content checksums with. It imports nothing of the port.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import struct
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "lz4_frozen.cpp")
CACHE_DIR = os.path.join(os.path.dirname(_HERE), ".cache")
_LOCK = threading.Lock()
_LIB = None

MAGIC = 0x184D2204
BLOCK_SIZE_IDS = {64 * 1024: 4, 256 * 1024: 5, 1024 * 1024: 6, 4 * 1024 * 1024: 7}


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            with open(_SRC, "rb") as f:
                tag = hashlib.sha256(f.read()).hexdigest()[:16]
            os.makedirs(CACHE_DIR, exist_ok=True)
            so = os.path.join(CACHE_DIR, f"lz4_frozen_{tag}.so")
            if not os.path.exists(so):
                with open(os.path.join(CACHE_DIR, "lz4_frozen.lock"), "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not os.path.exists(so):
                        tmp = f"{so}.tmp.{os.getpid()}"
                        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", _SRC,
                                        "-o", tmp], check=True, capture_output=True)
                        os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.pb_compress_block.restype = ctypes.c_int64
            lib.pb_compress_block.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u8p]
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.pb_compress_blocks.restype = None
            lib.pb_compress_blocks.argtypes = [u8p, i64p, i64p, ctypes.c_int64, u8p, i64p, i64p,
                                               ctypes.c_int]
            lib.pb_xxh32.restype = ctypes.c_uint32
            lib.pb_xxh32.argtypes = [u8p, ctypes.c_int64, ctypes.c_uint32]
            _LIB = lib
    return _LIB


def _u8(buf) -> np.ndarray:
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
    return np.ascontiguousarray(arr, dtype=np.uint8)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def compress_block(data, dictionary=b"") -> bytes:
    """One raw LZ4 block of ``data``; matches may reach into the last 64 KiB
    of ``dictionary`` (a linked block) when it is given."""
    dic = _u8(dictionary)[-65536:]
    src = np.concatenate([dic, _u8(data)]) if dic.size else _u8(data)
    dst = np.empty(_bound(src.size - dic.size), np.uint8)
    k = _lib().pb_compress_block(_ptr(src), dic.size, src.size, _ptr(dst))
    return dst[:k].tobytes()


def _bound(n: int) -> int:
    return n + n // 255 + 16


def compress_blocks(data, block_size: int) -> list[bytes]:
    """Every ``block_size`` block of ``data`` as an independent raw LZ4 block,
    compressed on a few threads inside the library."""
    src = _u8(data)
    start = np.arange(0, src.size, block_size, dtype=np.int64)
    lens = np.minimum(block_size, src.size - start).astype(np.int64)
    caps = np.array([_bound(int(n)) for n in lens], np.int64)
    off = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
    dst = np.empty(int(caps.sum()), np.uint8)
    out = np.zeros(start.size, np.int64)
    p64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    _lib().pb_compress_blocks(_ptr(src), p64(start), p64(lens), start.size, _ptr(dst), p64(off),
                              p64(out), min(8, os.cpu_count() or 1))
    return [dst[o : o + k].tobytes() for o, k in zip(off, out)]


def xxh32(data, seed: int = 0) -> int:
    arr = _u8(data)
    return int(_lib().pb_xxh32(_ptr(arr), arr.size, seed))


def frame(data, *, block_size: int, block_checksums: bool = False,
          content_checksum: bool = False, link_blocks: bool = False) -> bytes:
    """One LZ4 frame of ``data``: independent blocks of ``block_size`` (the
    header always says independent), stored raw where compression does not
    shrink them. ``link_blocks`` lets each block's matches reach into the
    64 KiB before it, which breaks the header's promise: it is the encode
    cells' control, never an input."""
    src = _u8(data)
    flg = (1 << 6) | (1 << 5) | (int(block_checksums) << 4) | (int(content_checksum) << 2)
    desc = bytes([flg, BLOCK_SIZE_IDS[block_size] << 4])
    out = [struct.pack("<I", MAGIC), desc, bytes([(xxh32(desc) >> 8) & 0xFF])]
    if link_blocks:
        comps = [compress_block(src[pos : pos + block_size], src[max(0, pos - 65536) : pos])
                 for pos in range(0, src.size, block_size)]
    else:
        comps = compress_blocks(src, block_size)
    for pos, comp in zip(range(0, src.size, block_size), comps):
        raw = src[pos : pos + block_size]
        if len(comp) < raw.size:
            out += [struct.pack("<I", len(comp)), comp]
            payload = comp
        else:
            payload = raw.tobytes()
            out += [struct.pack("<I", len(payload) | 0x80000000), payload]
        if block_checksums:
            out.append(struct.pack("<I", xxh32(payload)))
    out.append(struct.pack("<I", 0))
    if content_checksum:
        out.append(struct.pack("<I", xxh32(src)))
    return b"".join(out)
