"""Compressed frame bytes over input bytes of every request in the window,
x 100: an encode that gets faster by finding fewer matches shows here."""

UNIT = "%"


def read(w):
    return 100.0 * sum(w.out_bytes) / sum(w.in_bytes) if w.n else None
