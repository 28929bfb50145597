"""The frame walk a request, read from the port's own spans: the request
(`codec.decompress`) less every `ring.*` span inside it (size walk, plan
build, upload, K1's launch, the wait for K1 and the copy-out): header and
BlockInfo words, slicing, joins."""

from portbench import program_spans as ps

UNIT = "ms"
SPANS = ()


def read(w):
    recs = ps.records(w)
    return ps.per_request(recs and ps.self_ms(recs, "codec.decompress", ("ring.",)), w)
