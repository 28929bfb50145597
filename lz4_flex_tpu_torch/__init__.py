"""lz4_flex_tpu_torch — the LZ4 codec on PyTorch and CUDA (NVIDIA Hopper).

A port of ``lz4_flex_tpu`` that imports nothing of it and no JAX. The
production decode runs a host-built pull plan through a hand-written CUDA
ring kernel (ops/ringdecode.py, csrc/ring_decode.cu). Every entry point
takes ``device=None``, which means the CUDA card; ``device="cpu"`` runs the
kernel's plain PyTorch version instead.
"""

from . import block, frame

__version__ = "0.1.0"

__all__ = ["block", "frame", "__version__"]
