"""lz4_flex_tpu_torch — the LZ4 codec on PyTorch and CUDA (NVIDIA Hopper).

A port of ``lz4_flex_tpu`` that imports nothing of it and no JAX. The
production decode runs a host-built pull plan through a hand-written CUDA
ring kernel (ops/ringdecode.py, csrc/ring_decode.cu). Every device entry
point takes ``device=None``, which means the CUDA card; ``device="cpu"``
runs the kernel's plain PyTorch version instead.

Block-format convenience functions (on the native host library) are
re-exported at the top level, as the JAX package does.
"""

from . import block, frame
from .block import (
    compress,
    compress_into,
    compress_prepend_size,
    compress_prepend_size_with_dict,
    compress_with_dict,
    decompress,
    decompress_into,
    decompress_size_prepended,
    decompress_size_prepended_with_dict,
    decompress_with_dict,
    get_maximum_output_size,
)

__version__ = "0.1.0"

__all__ = [
    "block",
    "frame",
    "compress",
    "compress_into",
    "compress_prepend_size",
    "compress_prepend_size_with_dict",
    "compress_with_dict",
    "decompress",
    "decompress_into",
    "decompress_size_prepended",
    "decompress_size_prepended_with_dict",
    "decompress_with_dict",
    "get_maximum_output_size",
    "__version__",
]
