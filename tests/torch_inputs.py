"""Inputs for the port's tests, made in the repo from fixed seeds.

None of them reads a file: the corpora of ``tests/conftest.py`` live outside
the repo. The patterns follow tests/test_ring.py (RLE and short-period
overlap, incompressible bytes, deep match chains, periodic matches around
the ring boundary) plus a word soup in the manner of bench.py's
self-contained corpus.
"""

from __future__ import annotations

import random

import numpy as np


def word_soup(n: int, seed: int = 1, vocab: int = 2000) -> bytes:
    rng = random.Random(seed)
    words = [
        "".join(chr(rng.randrange(97, 123)) for _ in range(rng.randrange(2, 11)))
        for _ in range(vocab)
    ]
    rng = random.Random(seed ^ 0xD1C8E25)
    out, size = [], 0
    while size < n:
        w = words[rng.randrange(len(words))]
        out.append(w)
        size += len(w) + 1
    return " ".join(out).encode()[:n]


def incompressible(n: int, seed: int = 7) -> bytes:
    return bytes(np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8))


def deep_chains(n: int, tail: int = 1024, reps: int = 3) -> bytes:
    data = b"01"
    while len(data) < n:
        data = data + data[-tail:] * reps
    return data[:n]


def periodic_ring_boundary() -> bytes:
    """Periodic matches of several periods around the 32 KiB tile edges."""
    rng = np.random.default_rng(13)
    chunks = []
    for period in (1, 2, 3, 5, 31, 64, 127, 128):
        pat = bytes(rng.integers(97, 123, period, dtype=np.uint8))
        chunks.append(pat * (40000 // period))
        chunks.append(bytes(rng.integers(0, 256, 700, dtype=np.uint8)))
    return b"".join(chunks)


def rle_overlap() -> bytes:
    return b"z" * 40000 + b"yx" * 3000 + b"abcdefg" * 2000


def wild_plan_fields(tile_rows: int, seed: int = 5) -> dict:
    """The fields of a ring plan (keyword arguments of ``RingPlan.from_arrays``)
    whose records claim what no planner emits: lanes past the row's end
    (lo+len > 128), table addresses on both sides of the table, garbage bits
    above every field, and padding records with arbitrary f0/f1. Within one
    fire the live records target distinct rows, so its writes stay disjoint."""
    rng = np.random.default_rng(seed)
    tr, rb, ntiles, nf = tile_rows, 256, 3, 2
    flat = (512 + tr) * 128
    nlive = min(tr, rb)
    f0 = rng.integers(-(2**31), 2**31 - 1, (ntiles, nf, rb), dtype=np.int64)
    f1 = rng.integers(-(2**31), 2**31 - 1, (ntiles, nf, rb), dtype=np.int64)
    f2 = (rng.integers(0, 128, (ntiles, nf, rb)) | rng.integers(tr, 2 * tr, (ntiles, nf, rb)) << 7)
    for t in range(ntiles):
        for j in range(nf):
            rows = rng.permutation(tr)[:nlive]
            lo = rng.integers(0, 128, nlive)
            ln = np.where(rng.random(nlive) < 0.5, rng.integers(129, 257, nlive) - lo, rng.integers(1, 129, nlive))
            ln = np.clip(ln, 1, 128)
            ph, per = rng.integers(0, 128, nlive), rng.integers(1, 129, nlive)
            high = rng.integers(0, 2**9, nlive) << 21
            f0[t, j, :nlive] = rng.integers(-2000, flat + 2000, nlive)
            f1[t, j, :nlive] = ph | (per - 1) << 7 | lo << 14 | high
            f2[t, j, :nlive] = (ln - 1) | rows << 7
    return dict(
        rec_f0=f0.astype(np.int32), rec_f1=f1.astype(np.int32), rec_f2=f2.astype(np.int32),
        nf_tot=np.array([2, 1, 2], np.int32), fper=np.zeros((ntiles, 1), np.int32),
        lit_init=rng.integers(0, 256, (ntiles * tr, 128), dtype=np.uint8),
        total_out=ntiles * tr * 128 - 5, tile_rows=tr,
    )


def block_inputs() -> dict:
    """Named single-block inputs of at most ~330 KB."""
    return {
        "rle": b"a" * 70000,
        "ab": b"ab" * 35000,
        "abcdefg": b"abcdefg" * 11000,
        "nulls": bytes(30000),
        "cycle": bytes(i % 256 for i in range(70000)),
        "incompressible": incompressible(150000),
        "runs_and_noise": (b"x" * 200 + incompressible(64, 9)) * 400,
        "deep_chains": deep_chains(300000),
        "periodic_ring_boundary": periodic_ring_boundary(),
        "rle_overlap": rle_overlap(),
        "word_soup": word_soup(200000),
    }
