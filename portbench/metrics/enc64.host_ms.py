"""The encode's host side a request: the request (`codec.compress`) less
the port's `enc.launch`, `enc.wait` and `enc.verify` spans: staging, unpacking
payloads to bytes, the frame writer and the copies around them."""

from portbench import program_spans as ps

UNIT = "ms"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.per_request(
        recs and ps.self_ms(recs, "codec.compress", ("enc.launch", "enc.wait", "enc.verify")), w)
