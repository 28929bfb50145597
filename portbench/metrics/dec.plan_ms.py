"""Host plan build a request: the size walk (`ringdecode.part_sizes`) and
`ringdecode.build_ring_plan_parts` (native `tlz4_build_ring_plan2`)."""

UNIT = "ms"
SPANS = ("lz4_flex_tpu_torch.ops.ringdecode:part_sizes", "lz4_flex_tpu_torch.ops.ringdecode:build_ring_plan_parts")


def read(w):
    return w.host_ms(SPANS) / w.n if w.n else None
