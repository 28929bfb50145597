"""The copy-out a request once K1 has ended: the port's `ring.out` span in
`ringdecode._to_bytes` (device to host copy and `tobytes`)."""

from portbench import program_spans as ps

UNIT = "ms"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.per_request(recs and ps.total_ms(recs, ("ring.out",)), w)
