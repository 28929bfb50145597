"""The resident decode's device operations against the work's bytes: the
rows' compressed bytes read once and the blocks' bytes written once, over
the card's peak bandwidth."""

UNIT = "%"
SPANS = ("lz4_flex_tpu_torch.parallel.pipeline:_decode_batch",)


def read(w):
    return w.roofline_pct(sum(w.in_bytes) + sum(w.out_bytes), SPANS)
