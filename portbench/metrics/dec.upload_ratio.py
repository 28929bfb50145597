"""Plan bytes handed to the card (`ringdecode.stats["upload_bytes"]`: literal
image, record fields and fire counts) over the decompressed bytes of the
window's requests."""

UNIT = "x"
SPANS = ()


def read(w):
    n = w.stats.get("ringdecode.upload_bytes")
    return n / sum(w.out_bytes) if n is not None and sum(w.out_bytes) else None
