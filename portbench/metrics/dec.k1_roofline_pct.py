"""K1 (`ringdecode.ring_decode`, csrc/ring_decode.cuh) against the work's
bytes: compressed bytes read once and decompressed bytes written once, over
the card's peak bandwidth, as a share of the device time of every operation
launched inside the span."""

UNIT = "%"
SPANS = ("lz4_flex_tpu_torch.ops.ringdecode:ring_decode",)


def read(w):
    return w.roofline_pct(sum(w.in_bytes) + sum(w.out_bytes), SPANS)
