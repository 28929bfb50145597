"""Device codec for LZ4 on PyTorch and CUDA.

Modules:
  ringdecode — host pull planner, plan upload, and the ring kernel's
               wrapper with its plain PyTorch version
  _kernels   — build and ctypes binding of the CUDA sources in csrc/
  decode     — block decode entry point (``parse="ring"``, "host",
               "device"), the v1 expansion, the frame-body and resident
               decodes
  expand2    — the v2 (fragment-cell) expansion engine
  parse      — the on-device speculative parse
  sequences  — the sequence-table interchange format and host parsers
  encode     — the block encoders: the hybrid one (device candidate
               planes and the native host walk) and the all-device one
               (match, emission and the resident chunked encode; torch ops)
  packing    — shape buckets, padding, byte/scan/scatter helpers
"""

from . import packing, sequences
from .decode import decode_block_device
from .encode import compress_block_device, compress_block_hybrid
from .parse import parse_sequences_device

__all__ = [
    "packing",
    "sequences",
    "compress_block_device",
    "compress_block_hybrid",
    "decode_block_device",
    "parse_sequences_device",
]
