"""Decompressed bytes of every request completed in the window, over the
window's seconds (host clock)."""

UNIT = "MiB/s"


def read(w):
    return sum(w.out_bytes) / 2**20 / w.seconds if w.n else None
