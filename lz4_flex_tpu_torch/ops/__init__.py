"""Device decode for the LZ4 codec on PyTorch and CUDA.

Modules:
  ringdecode — host pull planner, plan upload, and the ring kernel's
               wrapper with its plain PyTorch version
  _kernels   — build and ctypes binding of the CUDA sources in csrc/
  decode     — block decode entry point (``parse="ring"``)
"""

from .decode import decode_block_device

__all__ = ["decode_block_device"]
