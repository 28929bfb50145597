"""Host time in those reads a `decode_step` (the port's `resident.sync`
spans): the wait for the device's queue to drain and the copy of one
scalar."""

from portbench import program_spans as ps

UNIT = "ms"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.per_request(recs and ps.total_ms(recs, ("resident.sync",)), w)
