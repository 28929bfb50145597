"""The host blocked on the all-device encode a request: the port's
`enc.wait` spans in `pipeline._encode_staged` (a group's event
synchronize before its payloads are read)."""

from portbench import program_spans as ps

UNIT = "ms"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.per_request(recs and ps.total_ms(recs, ("enc.wait",)), w)
