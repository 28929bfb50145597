"""Shape buckets and padding for the device programs (the JAX package's
``ops/packing.py:size_bucket`` and ``pad_to``; its word-packing kernels come
with the fallback decode engines)."""

from __future__ import annotations

import numpy as np

# Shape buckets: pad array lengths to the next bucket so that the number of
# distinct shapes, and the plans of buffers of each, stay small.
_BUCKET_MIN = 4096


def size_bucket(n: int, minimum: int = _BUCKET_MIN) -> int:
    """Round ``n`` up to the next power-of-two (or 1.5×power-of-two) bucket."""
    b = minimum
    while b < n:
        if (b + b // 2) >= n:
            return b + b // 2
        b *= 2
    return b


def pad_to(arr: np.ndarray, size: int, fill: int = 0) -> np.ndarray:
    """Pad a 1-D numpy array up to ``size`` with ``fill``."""
    if arr.shape[0] == size:
        return arr
    out = np.full(size, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out
