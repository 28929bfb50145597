"""The frame walk a request (`frame/device.py:decompress_frame_device`):
request wall time less the plan, upload, K1 launch and copy-out spans."""

UNIT = "ms"
SPANS = ("lz4_flex_tpu_torch.ops.ringdecode:part_sizes", "lz4_flex_tpu_torch.ops.ringdecode:build_ring_plan_parts", "lz4_flex_tpu_torch.ops.ringdecode:ring_plan_device_tensors",
         "lz4_flex_tpu_torch.ops.ringdecode:ring_decode", "lz4_flex_tpu_torch.ops.ringdecode:_to_bytes")


def read(w):
    return (1e3 * sum(w.latencies_s) - w.host_ms(SPANS)) / w.n if w.n else None
