"""The host blocked on K1 a request: the port's `ring.wait` span in
`ringdecode._to_bytes` (the stream's synchronize before the copy-out)."""

from portbench import program_spans as ps

UNIT = "ms"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.per_request(recs and ps.total_ms(recs, ("ring.wait",)), w)
