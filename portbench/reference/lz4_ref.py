"""Plain LZ4 block and frame decoding, and the checks that decide ``correct``.

Written from the LZ4 block and frame format descriptions
(github.com/lz4/lz4/blob/dev/doc/), in plain Python: one sequence at a time,
a match copied byte for byte where it overlaps its own output. It imports
nothing of the port, of ``jax`` or of the JAX package.

``overlap_as_memmove=True`` is the decode cells' control: it copies every
match as one memmove of the output so far, the tempting fast copy that is
wrong where a match overlaps the bytes it produces.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x184D2204
BLOCK_SIZES = {4: 64 * 1024, 5: 256 * 1024, 6: 1024 * 1024, 7: 4 * 1024 * 1024}
WINDOW = 65535


class RefError(ValueError):
    """The bytes are not a valid LZ4 frame or block under its header."""


#: The block format's end-of-block rules: the last 5 bytes are literals, and
#: the last match starts at least 12 bytes before the block's end.
LAST_LITERALS, MATCH_LIMIT = 5, 12


def decode_block(src, out: bytearray, low: int, *, overlap_as_memmove: bool = False) -> None:
    """Decode one LZ4 block ``src`` onto the end of ``out``. A match may
    reach back to ``out[low]`` (the block's start for an independent block)
    and at most 65535 bytes. Raises RefError on a malformed block, and on
    one that breaks the end-of-block rules, which strict readers enforce."""
    i, n = 0, len(src)
    if n == 0:
        raise RefError("empty block")
    last_match = None  # where the latest match starts in out
    while True:
        tok = src[i]
        i += 1
        nlit = tok >> 4
        if nlit == 15:
            while True:
                if i >= n:
                    raise RefError("truncated literal length")
                b = src[i]
                i += 1
                nlit += b
                if b != 255:
                    break
        if i + nlit > n:
            raise RefError("literals past the block's end")
        out += src[i : i + nlit]
        i += nlit
        if i == n:  # the last sequence holds literals only
            if last_match is not None:
                if nlit < LAST_LITERALS:
                    raise RefError(f"the block ends with {nlit} literals, fewer than {LAST_LITERALS}")
                if len(out) - last_match < MATCH_LIMIT:
                    raise RefError(f"the last match starts {len(out) - last_match} bytes before "
                                   f"the block's end, fewer than {MATCH_LIMIT}")
            return
        if i + 2 > n:
            raise RefError("truncated offset")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = tok & 15
        if mlen == 15:
            while True:
                if i >= n:
                    raise RefError("truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        pos = last_match = len(out)
        start = pos - off
        if off == 0 or start < low:
            raise RefError(f"offset {off} reaches before the window")
        if off >= mlen:
            out += out[start : start + mlen]
        elif overlap_as_memmove:
            seg = out[start:pos]  # the bytes that exist before the copy
            out += seg + bytes(mlen - len(seg))
        else:
            out += (out[start:pos] * (mlen // off + 1))[:mlen]


def decode_frame(frame, *, overlap_as_memmove: bool = False):
    """Decode one LZ4 frame. Returns (header, content, block_sizes): the
    header's fields, the decoded bytes and each block's decoded size; the
    stored content checksum is ``header["content_checksum_value"]``.
    Raises RefError where the bytes break the format or the header's
    promises (block size, independence, header and block checksums)."""
    data = memoryview(frame).cast("B") if not isinstance(frame, bytes) else frame
    if len(data) < 7 or struct.unpack_from("<I", data, 0)[0] != MAGIC:
        raise RefError("not an LZ4 frame")
    flg, bd = data[4], data[5]
    hdr = {
        "version": flg >> 6,
        "independent": bool(flg & 0x20),
        "block_checksums": bool(flg & 0x10),
        "content_size": bool(flg & 0x08),
        "content_checksum": bool(flg & 0x04),
        "dict_id": bool(flg & 0x01),
        "block_size": BLOCK_SIZES.get((bd >> 4) & 7),
    }
    if hdr["version"] != 1 or flg & 0x02 or bd & 0x8F or hdr["block_size"] is None:
        raise RefError("bad frame descriptor")
    pos = 6 + 8 * hdr["content_size"] + 4 * hdr["dict_id"]
    if len(data) < pos + 1:
        raise RefError("truncated header")
    if data[pos] != (xxh32(bytes(data[4:pos])) >> 8) & 0xFF:
        raise RefError("header checksum")
    pos += 1
    out = bytearray()
    sizes = []
    while True:
        if pos + 4 > len(data):
            raise RefError("truncated block size")
        (word,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if word == 0:
            break
        size, stored = word & 0x7FFFFFFF, bool(word >> 31)
        if size > hdr["block_size"] or pos + size > len(data):
            raise RefError("block larger than the header allows, or truncated")
        payload = bytes(data[pos : pos + size])
        pos += size
        if hdr["block_checksums"]:
            if pos + 4 > len(data) or struct.unpack_from("<I", data, pos)[0] != xxh32(payload):
                raise RefError("block checksum")
            pos += 4
        before = len(out)
        if stored:
            out += payload
        else:
            low = before if hdr["independent"] else max(0, before - WINDOW)
            decode_block(payload, out, low, overlap_as_memmove=overlap_as_memmove)
        if len(out) - before > hdr["block_size"]:
            raise RefError("block decodes past the block size")
        sizes.append(len(out) - before)
    if hdr["content_checksum"]:
        if pos + 4 > len(data):
            raise RefError("truncated content checksum")
        hdr["content_checksum_value"] = struct.unpack_from("<I", data, pos)[0]
        pos += 4
    if pos != len(data):
        raise RefError("bytes after the frame")
    return hdr, bytes(out), sizes


def wrong_bytes(got, expected) -> int:
    """Bytes of ``got`` that differ from ``expected``, plus the difference
    in length."""
    a = np.frombuffer(got, np.uint8)
    b = np.frombuffer(expected, np.uint8)
    n = min(a.size, b.size)
    return int(np.count_nonzero(a[:n] != b[:n])) + abs(a.size - b.size)


def check_frame(frame, expected, frame_config: dict, expected_checksum: int | None) -> dict:
    """Judge one encoded frame against the input it was made from and the
    configuration's frame settings: ``frames_bad`` (1 when the reference
    cannot decode it or its content checksum is wrong), ``header_mismatch``
    (1 when a header flag differs from the configuration) and
    ``wrong_bytes``. ``expected_checksum`` is the input's xxHash32 where the
    configuration asks for a content checksum."""
    try:
        hdr, content, _ = decode_frame(frame)
    except RefError:
        return {"frames_bad": 1, "header_mismatch": 0, "wrong_bytes": len(expected)}
    want = {
        "independent": frame_config["block_mode"] == "independent",
        "block_checksums": frame_config["block_checksums"],
        "content_checksum": frame_config["content_checksum"],
        "content_size": frame_config["content_size"],
        "dict_id": False,
        "block_size": frame_config["block_size"],
    }
    mismatch = int(any(hdr[k] != v for k, v in want.items()))
    bad = int(hdr["content_checksum"] and hdr.get("content_checksum_value") != expected_checksum)
    return {"frames_bad": bad, "header_mismatch": mismatch,
            "wrong_bytes": wrong_bytes(content, expected)}


_P1, _P2, _P3, _P4, _P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 in plain Python (for headers and tests: slow on large data)."""
    n = len(data)
    p = 0
    if n >= 16:
        v = [(seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed, (seed - _P1) & _M]
        while p + 16 <= n:
            for j in range(4):
                w = int.from_bytes(data[p + 4 * j : p + 4 * j + 4], "little")
                v[j] = (_rotl((v[j] + w * _P2) & _M, 13) * _P1) & _M
            p += 16
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while p + 4 <= n:
        h = (_rotl((h + int.from_bytes(data[p : p + 4], "little") * _P3) & _M, 17) * _P4) & _M
        p += 4
    while p < n:
        h = (_rotl((h + data[p] * _P5) & _M, 11) * _P1) & _M
        p += 1
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    h ^= h >> 16
    return h
