"""LZ4 frame format: the streaming encoder and decoder, the one-shot device
codec, the descriptor and the error taxonomy."""

from . import errors
from .decoder import FrameDecoder
from .device import compress_frame_device, decompress_frame_device
from .encoder import AutoFinishEncoder, FrameEncoder
from .errors import FrameError
from .header import BlockInfo, BlockInfoKind, BlockMode, BlockSize, FrameInfo

__all__ = [
    "AutoFinishEncoder",
    "BlockInfo",
    "BlockInfoKind",
    "BlockMode",
    "BlockSize",
    "FrameDecoder",
    "FrameEncoder",
    "FrameError",
    "FrameInfo",
    "compress",
    "compress_frame_device",
    "decompress",
    "decompress_frame_device",
    "errors",
]


def compress(data: bytes, frame_info: FrameInfo | None = None) -> bytes:
    """One-shot frame compression on the host engine."""
    import io

    buf = io.BytesIO()
    enc = FrameEncoder(buf, frame_info)
    enc.write(data)
    enc.finish()
    return buf.getvalue()


def decompress(data: bytes) -> bytes:
    """One-shot decompression of all concatenated frames in ``data`` on the
    host engine."""
    import io

    return FrameDecoder(io.BytesIO(data)).read_all()
