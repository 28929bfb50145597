"""The verify guard a request: the native verify walks
(`native.verify_block`) over every device payload. The count of payloads
it refused, `encode.verify_fallbacks`, is on the counters line."""

UNIT = "ms"
SPANS = ("lz4_flex_tpu_torch.native:verify_block",)


def read(w):
    return w.host_ms(SPANS) / w.n if w.n else None
