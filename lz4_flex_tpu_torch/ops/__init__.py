"""Device codec for LZ4 on PyTorch and CUDA.

Modules:
  ringdecode — host pull planner, plan upload, and the ring kernel's
               wrapper with its plain PyTorch version
  _kernels   — build and ctypes binding of the CUDA sources in csrc/
  decode     — block decode entry point (``parse="ring"``)
  encode     — the hybrid block encoder: device candidate planes (torch
               ops) and the native host walk
  packing    — shape buckets and padding
"""

from .decode import decode_block_device
from .encode import compress_block_hybrid

__all__ = ["compress_block_hybrid", "decode_block_device"]
