"""LZ4 frame format: descriptor, error taxonomy and the one-shot device
decoder."""

from . import errors
from .device import decompress_frame_device
from .errors import FrameError
from .header import BlockInfo, BlockInfoKind, BlockMode, BlockSize, FrameInfo

__all__ = [
    "BlockInfo",
    "BlockInfoKind",
    "BlockMode",
    "BlockSize",
    "FrameError",
    "FrameInfo",
    "decompress_frame_device",
    "errors",
]
