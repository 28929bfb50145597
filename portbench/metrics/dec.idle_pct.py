"""The device's idle share of the traced window in the decode cells: 100 less
the share in which any device operation ran (the profiler's trace)."""

UNIT = "%"


def read(w):
    return w.idle_pct()
