"""The fixed-width sequence-table interchange format.

A parsed LZ4 block is a list of sequences {literal run, match}; the device
programs exchange them as five parallel int32 arrays, padded to a bucket
size with the true counts alongside:

  lit_start  position of the literal run in the *compressed* stream
  lit_len    literal run length
  match_off  match back-offset (0 for the final, literal-only sequence)
  match_len  match length in bytes (0 for the final sequence)
  out_off    output position where this sequence's literals begin

This mirrors what the reference decoder extracts per token (lz4_flex
src/block/decompress.rs:244-444), laid out as arrays so that the expansion
is a data-parallel program instead of a token walk.

Parsing comes from the native host runtime (:func:`parse_sequences_host`),
the pure-Python oracle (:func:`_parse_sequences_py`) and the on-device
parsers of ops/parse.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native as _native
from ..block import errors as block_errors


@dataclass
class SeqTable:
    """A parsed block as parallel numpy arrays (host-side staging form)."""

    lit_start: np.ndarray
    lit_len: np.ndarray
    match_off: np.ndarray
    match_len: np.ndarray
    out_off: np.ndarray
    total_out: int

    @property
    def nseq(self) -> int:
        return int(self.lit_start.shape[0])


def parse_sequences_host(data) -> SeqTable:
    """Parse a compressed block into a SeqTable with the native parser.
    Raises the block error taxonomy on malformed input (lz4_flex
    src/block/mod.rs:82-98)."""
    ls, ll, mo, ml, oo, total = _native.parse_sequences(data)
    return SeqTable(ls, ll, mo, ml, oo, total)


def _parse_sequences_py(data: bytes) -> SeqTable:
    """Pure-Python sequential parse: the oracle the native and device
    parsers are held against."""
    n = len(data)
    ip = 0
    opos = 0
    ls, ll_, mo, ml_, oo = [], [], [], [], []
    while True:
        if ip >= n:
            raise block_errors.ExpectedAnotherByte()
        token = data[ip]
        ip += 1
        ll = token >> 4
        if ll == 0xF:
            while True:
                if ip >= n:
                    raise block_errors.ExpectedAnotherByte()
                b = data[ip]
                ip += 1
                ll += b
                if b != 0xFF:
                    break
        if ll > n - ip:
            raise block_errors.LiteralOutOfBounds()
        ls.append(ip)
        ll_.append(ll)
        oo.append(opos)
        ip += ll
        opos += ll
        if ip >= n:
            mo.append(0)
            ml_.append(0)
            break
        if n - ip < 2:
            raise block_errors.ExpectedAnotherByte()
        offset = data[ip] | (data[ip + 1] << 8)
        ip += 2
        if offset == 0:
            raise block_errors.OffsetZero()
        ml = token & 0xF
        if ml == 0xF:
            while True:
                if ip >= n:
                    raise block_errors.ExpectedAnotherByte()
                b = data[ip]
                ip += 1
                ml += b
                if b != 0xFF:
                    break
        ml += 4
        mo.append(offset)
        ml_.append(ml)
        opos += ml
    i32 = lambda xs: np.asarray(xs, dtype=np.int32)  # noqa: E731
    return SeqTable(i32(ls), i32(ll_), i32(mo), i32(ml_), i32(oo), opos)
