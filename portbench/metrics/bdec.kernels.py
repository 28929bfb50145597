"""Device kernels a `decode_step` launches in the resident decode
(`parallel/pipeline.py:_decode_batch` -> `ops/decode.py:decode_resident_rows`,
`ops/parse.py:parse_rows`, `ops/expand2.py`): the profiler's count."""

UNIT = "kernels/batch"
SPANS = ("lz4_flex_tpu_torch.parallel.pipeline:_decode_batch",)


def read(w):
    k = w.kernels(SPANS)
    return k / w.n if w.n and k else None
