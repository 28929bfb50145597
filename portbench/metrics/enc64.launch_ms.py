"""Launching the all-device encode a request: the port's `enc.launch` spans
in `pipeline._encode_staged` (a group's upload, `encode_chunk_core`'s
launches, the read-back's enqueue and its event)."""

from portbench import program_spans as ps

UNIT = "ms"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.per_request(recs and ps.total_ms(recs, ("enc.launch",)), w)
