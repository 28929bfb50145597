"""The flagship model: a configured LZ4 codec on the device.

Bundles the frame wire format (frame/) and the device decode (ops/) behind
one object: a configuration (block size and mode, checksums — the
reference's FrameInfo setters, src/frame/header.rs:130-192) and the
byte-level decode methods. Encode comes with the encode slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..frame.header import BlockMode, BlockSize, FrameInfo


@dataclass
class CodecConfig:
    """Runtime configuration (FrameInfo analog for the device pipeline)."""

    block_size: BlockSize = BlockSize.Max64KB
    block_mode: BlockMode = BlockMode.Independent
    block_checksums: bool = False
    content_checksum: bool = False

    def frame_info(self) -> FrameInfo:
        return FrameInfo(
            block_size=self.block_size,
            block_mode=self.block_mode,
            block_checksums=self.block_checksums,
            content_checksum=self.content_checksum,
        )


class LZ4Codec:
    """End-to-end device codec. ``device=None`` means the CUDA card;
    ``device="cpu"`` runs the ring kernel's plain PyTorch version."""

    def __init__(self, config: CodecConfig | None = None, *, device=None) -> None:
        self.config = config or CodecConfig()
        self.device = device

    def decompress(self, data) -> bytes:
        """Decompress every concatenated LZ4 frame in ``data``."""
        from ..frame.device import decompress_frame_device

        return decompress_frame_device(data, device=self.device)

    def decompress_block(self, data, max_output_size: int, ext_dict=b"") -> bytes:
        """Decompress one raw LZ4 block."""
        from ..ops.decode import decode_block_device

        return decode_block_device(data, max_output_size, ext_dict, device=self.device)
