"""Host around K1 a request: the plan's upload (`ring_plan_device_tensors`)
and the copy-out (`_to_bytes`, which waits for K1), less K1's device time."""

UNIT = "ms"
UPLOAD_AND_OUT = ("lz4_flex_tpu_torch.ops.ringdecode:ring_plan_device_tensors", "lz4_flex_tpu_torch.ops.ringdecode:_to_bytes")
K1 = ("lz4_flex_tpu_torch.ops.ringdecode:ring_decode",)
SPANS = UPLOAD_AND_OUT + K1


def read(w):
    if not w.n or not w.device_ms(K1):
        return None
    return (w.host_ms(UPLOAD_AND_OUT) - w.device_ms(K1)) / w.n
