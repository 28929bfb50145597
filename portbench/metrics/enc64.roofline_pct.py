"""The all-device encode's device operations against the work's bytes:
input bytes read once and frame bytes written once, over the card's peak
bandwidth."""

UNIT = "%"
SPANS = ("lz4_flex_tpu_torch.parallel.pipeline:_encode_staged",)


def read(w):
    return w.roofline_pct(sum(w.in_bytes) + sum(w.out_bytes), SPANS)
