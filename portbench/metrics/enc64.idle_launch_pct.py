"""The share of the device's idle time in the traced window during which
the host was launching the encode (the port's `enc.launch` spans), x 100."""

from portbench import program_spans as ps

UNIT = "%"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.idle_share_pct(w, recs, ("enc.launch",)) if recs else None
