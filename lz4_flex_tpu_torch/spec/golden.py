"""Pure-Python golden model of the LZ4 block codec.

A slow, obviously-correct implementation used as the differential oracle for
the native host codec and the device kernels. The encoder mirrors the greedy
hash-table match search of the reference (lz4_flex src/block/compress.rs:318-489)
closely enough to reproduce its compression ratios; the decoder implements the
spec token walk (src/block/decompress_safe.rs:93-247 in the reference).

Never used on hot paths: the port's block API runs on the native library
only, and raises where that library cannot build.
"""

from __future__ import annotations

import struct

from .constants import (
    END_OFFSET,
    HASHTABLE_BIT_SHIFT_4K,
    HASHTABLE_SIZE_4K,
    INCREASE_STEPSIZE_BITSHIFT,
    LZ4_MIN_LENGTH,
    MAX_DISTANCE,
    MFLIMIT,
    MINMATCH,
    WINDOW_SIZE,
    hash4,
    hash5,
)
from ..block.errors import (
    ExpectedAnotherByte,
    LiteralOutOfBounds,
    OffsetOutOfBounds,
    OffsetZero,
    OutputTooSmall,
)

# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _hash_at_4(data: bytes, pos: int) -> int:
    (seq,) = struct.unpack_from("<I", data, pos)
    return hash4(seq) >> HASHTABLE_BIT_SHIFT_4K


def _hash_at_5(data: bytes, pos: int) -> int:
    (seq,) = struct.unpack_from("<Q", data, pos)
    return hash5(seq) >> HASHTABLE_BIT_SHIFT_4K


def _write_integer(out: bytearray, n: int) -> None:
    while n >= 0xFF:
        n -= 0xFF
        out.append(0xFF)
    out.append(n)


def _emit_last_literals(out: bytearray, data: bytes, start: int) -> None:
    lit_len = len(data) - start
    out.append(0xF0 if lit_len >= 0xF else lit_len << 4)
    if lit_len >= 0xF:
        _write_integer(out, lit_len - 0xF)
    out += data[start:]


def _count_same_bytes(data: bytes, cur: int, source: bytes, candidate: int) -> int:
    """Length of the common run between data[cur:] and source[candidate:],
    bounded by END_OFFSET from the input end and by the source end."""
    limit = min(len(data) - END_OFFSET - cur, len(source) - candidate)
    if limit <= 0:
        return 0
    n = 0
    # Chunked comparison keeps the golden model usable on multi-KB corpora.
    while n + 64 <= limit and data[cur + n : cur + n + 64] == source[candidate + n : candidate + n + 64]:
        n += 64
    while n < limit and data[cur + n] == source[candidate + n]:
        n += 1
    return n


def compress_block(
    data: bytes,
    input_pos: int = 0,
    ext_dict: bytes = b"",
    input_stream_offset: int | None = None,
    table: list[int] | None = None,
    use_hash5: bool | None = None,
) -> bytes:
    """Greedy LZ4 block encode of ``data[input_pos:]``.

    ``data[:input_pos]`` is a same-buffer prefix available for lookback;
    ``ext_dict`` logically precedes ``data``. ``input_stream_offset`` is the
    logical stream position of ``data[0]`` (defaults to ``len(ext_dict)``).
    """
    if input_stream_offset is None:
        input_stream_offset = len(ext_dict)
    assert len(ext_dict) <= input_stream_offset
    if use_hash5 is None:
        use_hash5 = len(ext_dict) + len(data) >= 0xFFFF
    hash_at = _hash_at_5 if use_hash5 else _hash_at_4
    if table is None:
        table = [0] * HASHTABLE_SIZE_4K

    out = bytearray()
    n = len(data)
    if n - input_pos < LZ4_MIN_LENGTH:
        _emit_last_literals(out, data, input_pos)
        return bytes(out)

    use_dict = len(ext_dict) > 0
    ext_dict_stream_offset = input_stream_offset - len(ext_dict)
    end_pos_check = n - MFLIMIT
    literal_start = input_pos
    cur = input_pos

    if cur == 0 and input_stream_offset == 0:
        # A block with no history cannot start with a match.
        table[hash_at(data, 0)] = 0
        cur = 1

    while True:
        non_match_count = 1 << INCREASE_STEPSIZE_BITSHIFT
        next_cur = cur
        while True:
            step_size = non_match_count >> INCREASE_STEPSIZE_BITSHIFT
            non_match_count += 1
            cur = next_cur
            next_cur += step_size
            if cur > end_pos_check:
                _emit_last_literals(out, data, literal_start)
                return bytes(out)
            h = hash_at(data, cur)
            candidate = table[h]
            table[h] = cur + input_stream_offset
            if input_stream_offset + cur - candidate > MAX_DISTANCE:
                continue
            if candidate >= input_stream_offset:
                offset = input_stream_offset + cur - candidate
                cand = candidate - input_stream_offset
                source = data
            elif use_dict:
                offset = input_stream_offset + cur - candidate
                cand = candidate - ext_dict_stream_offset
                source = ext_dict
                if cand < 0:
                    continue
            else:
                continue
            if source[cand : cand + 4] == data[cur : cur + 4]:
                break

        # Extend the match backwards over pending literals.
        while cand > 0 and cur > literal_start and data[cur - 1] == source[cand - 1]:
            cur -= 1
            cand -= 1

        lit_len = cur - literal_start
        cur += MINMATCH
        cand += MINMATCH
        dup_len = _count_same_bytes(data, cur, source, cand)
        cur += dup_len
        table[hash_at(data, cur - 2)] = cur - 2 + input_stream_offset

        token = (0xF0 if lit_len >= 0xF else lit_len << 4) | (
            0xF if dup_len >= 0xF else dup_len
        )
        out.append(token)
        if lit_len >= 0xF:
            _write_integer(out, lit_len - 0xF)
        out += data[literal_start : literal_start + lit_len]
        out += struct.pack("<H", offset)
        if dup_len >= 0xF:
            _write_integer(out, dup_len - 0xF)
        literal_start = cur


def compress(data: bytes) -> bytes:
    return compress_block(data)


def compress_with_dict(data: bytes, ext_dict: bytes) -> bytes:
    if len(ext_dict) <= 3:
        ext_dict = b""
    if len(ext_dict) > WINDOW_SIZE:
        ext_dict = ext_dict[-WINDOW_SIZE:]
    use_hash5 = len(ext_dict) + len(data) >= 0xFFFF
    table = [0] * HASHTABLE_SIZE_4K
    hash_at = _hash_at_5 if use_hash5 else _hash_at_4
    i = 0
    # Seed the table from the dictionary with a 3-byte stride.
    while i + 8 <= len(ext_dict):
        table[hash_at(ext_dict, i)] = i
        i += 3
    return compress_block(
        data,
        ext_dict=ext_dict,
        input_stream_offset=len(ext_dict),
        table=table,
        use_hash5=use_hash5,
    )


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _read_integer(data: bytes, pos: int) -> tuple[int, int]:
    n = 0
    while True:
        if pos >= len(data):
            raise ExpectedAnotherByte()
        extra = data[pos]
        pos += 1
        n += extra
        if extra != 0xFF:
            return n, pos


def decompress_block(
    data: bytes,
    max_output_size: int,
    ext_dict: bytes = b"",
    prefix: bytes = b"",
) -> bytes:
    """Spec token-walk decode. ``prefix`` is already-produced output that
    matches may reference (linked blocks); ``ext_dict`` logically precedes it."""
    out = bytearray(prefix)
    base = len(prefix)
    pos = 0
    n = len(data)
    while True:
        if pos >= n:
            raise ExpectedAnotherByte()
        token = data[pos]
        pos += 1

        lit_len = token >> 4
        if lit_len == 0xF:
            extra, pos = _read_integer(data, pos)
            lit_len += extra
        if lit_len > n - pos:
            raise LiteralOutOfBounds()
        if len(out) - base + lit_len > max_output_size:
            raise OutputTooSmall(len(out) - base + lit_len, max_output_size)
        out += data[pos : pos + lit_len]
        pos += lit_len

        if pos >= n:
            break

        if pos + 2 > n:
            raise ExpectedAnotherByte()
        (offset,) = struct.unpack_from("<H", data, pos)
        pos += 2
        if offset == 0:
            raise OffsetZero()

        match_len = MINMATCH + (token & 0xF)
        if match_len == MINMATCH + 0xF:
            extra, pos = _read_integer(data, pos)
            match_len += extra
        if len(out) - base + match_len > max_output_size:
            raise OutputTooSmall(len(out) - base + match_len, max_output_size)

        if offset > len(out):
            # Match starts in the external dictionary.
            dict_offset = len(ext_dict) - (offset - len(out))
            if dict_offset < 0:
                raise OffsetOutOfBounds()
            take = min(match_len, len(ext_dict) - dict_offset)
            out += ext_dict[dict_offset : dict_offset + take]
            match_len -= take
            if match_len == 0:
                continue
            # The remainder continues from the start of `out`.
        start = len(out) - offset
        if start < 0:
            raise OffsetOutOfBounds()
        for _ in range(match_len):  # byte-wise: handles overlap naturally
            out.append(out[start])
            start += 1
    return bytes(out[base:])
