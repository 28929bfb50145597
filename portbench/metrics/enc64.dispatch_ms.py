"""The all-device encode a request: host wall time of
`parallel/pipeline.py:_encode_staged` (32-row groups through
`ops/encode.py:encode_chunk_core` = `match_core` + `emit_core`, uploads
and read-backs)."""

UNIT = "ms"
SPANS = ("lz4_flex_tpu_torch.parallel.pipeline:_encode_staged",)


def read(w):
    return w.host_ms(SPANS) / w.n if w.n else None
