"""Seeded Zipf text, the stand-in for Silesia's ``dickens``.

Words of ``word_len`` lowercase letters (uniform over the range), a
vocabulary of ``vocab`` words whose letters are drawn from the seed, each word chosen with
probability proportional to ``1 / rank ** exponent``, joined by single
spaces. Vectorised: one base text a run, requests are slices of it.
"""

from __future__ import annotations

import numpy as np

_GRID = 1 << 22
_LENGTHS_SEED = 0x4C5A34  # fixed: see zipf_text


def zipf_text(seed: int, nbytes: int, *, vocab: int = 50_000, exponent: float = 1.0,
              word_len=(2, 10)) -> np.ndarray:
    """``nbytes`` bytes of Zipf text (uint8) from ``seed``."""
    lo, hi = int(word_len[0]), int(word_len[1])
    # The words' lengths by rank are the same for every seed, so every seed
    # gets text of the same statistics (the same compression work); the
    # letters, and so the words themselves, and the draws come from the seed.
    lens = np.random.default_rng(_LENGTHS_SEED).integers(lo, hi + 1, size=vocab)
    rng = np.random.default_rng(seed)
    width = hi + 1
    letters = rng.integers(ord("a"), ord("z") + 1, size=(vocab, width), dtype=np.uint8)
    col = np.arange(width)
    letters[col[None, :] == lens[:, None]] = ord(" ")
    keep = col[None, :] <= lens[:, None]  # the word and its space

    # Inverse CDF on a grid of 2**22 cells (the rarest word of 50,000 still
    # has ~7 cells), so a draw is one table read, not a search.
    weights = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** exponent
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    table = np.minimum(np.searchsorted(cdf, (np.arange(_GRID) + 0.5) / _GRID, side="right"),
                       vocab - 1).astype(np.int32)
    mean_len = float(np.dot(weights / weights.sum(), lens + 1))
    nwords = int(nbytes / mean_len * 1.05) + 64
    out = np.empty(0, np.uint8)
    while out.size < nbytes:
        words = table[rng.integers(0, _GRID, size=nwords)]
        out = np.concatenate([out, letters[words][keep[words]]])
    return out[:nbytes].copy()


def log_uniform_sizes(n: int, lo: int, hi: int) -> list[int]:
    """``n`` sizes at the midpoints of ``n`` equal steps of log size between
    ``lo`` and ``hi``: every seed gets the same set, in its own order."""
    q = (np.arange(n) + 0.5) / n
    return [int(round(v)) for v in np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))]
