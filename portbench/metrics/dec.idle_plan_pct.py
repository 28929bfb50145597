"""The share of the device's idle time in the traced window during which
the host was inside the size walk or the plan build (the port's
`ring.sizes` and `ring.plan` spans), x 100."""

from portbench import program_spans as ps

UNIT = "%"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.idle_share_pct(w, recs, ("ring.sizes", "ring.plan")) if recs else None
