"""Host reads of device state a `decode_step`: the port's `resident.sync`
spans (each loop round's `bool(...)` or `int(...)` in ops/decode.py,
ops/parse.py and ops/expand2.py)."""

from portbench import program_spans as ps

UNIT = "reads/batch"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.per_request(recs and ps.count(recs, "resident.sync"), w)
