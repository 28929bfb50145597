"""The content checksum in a decode a request: the port's `frame.xxh` spans
(frame/device.py: the xxHash32 of the decoded content, checked against the
stored value)."""

from portbench import program_spans as ps

UNIT = "ms"
SPANS = ()


def read(w):
    recs = ps.records(w)
    if not recs or not ps.count(recs, "frame.xxh"):
        return None  # a port without the span
    return ps.per_request(ps.total_ms(recs, ("frame.xxh",)), w)
