"""The upload's copies into pinned host memory a request (the port's
`ring.pin` spans in `ringdecode.ring_plan_device_tensors`)."""

from portbench import program_spans as ps

UNIT = "ms"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.per_request(recs and ps.total_ms(recs, ("ring.pin",)), w)
