"""The flagship model: a configured LZ4 codec on the device.

Bundles the frame wire format (frame/) and the device codec (ops/) behind
one object: a configuration (block size and mode, checksums — the
reference's FrameInfo setters, src/frame/header.rs:130-192 — and the
verify guard of the device encoder), the byte-level methods (``compress``,
``decompress``, ``compress_block``, ``decompress_block``) and the batched
array steps ``encode_step`` and ``decode_step`` (device-resident encode and
decode of independent blocks: tensors in, tensors out, for embedding in a
larger device pipeline).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..frame.header import BlockMode, BlockSize, FrameInfo
from ..ops import packing
from ..utils import trace


@dataclass
class CodecConfig:
    """Runtime configuration (FrameInfo analog for the device pipeline)."""

    block_size: BlockSize = BlockSize.Max64KB
    block_mode: BlockMode = BlockMode.Independent
    block_checksums: bool = False
    content_checksum: bool = False
    verify: bool = True  # check device encodes with the host verify walk (collision guard)

    def frame_info(self) -> FrameInfo:
        return FrameInfo(
            block_size=self.block_size,
            block_mode=self.block_mode,
            block_checksums=self.block_checksums,
            content_checksum=self.content_checksum,
        )


class LZ4Codec:
    """End-to-end device codec over an optional mesh (a list of devices,
    parallel/mesh.py), which ``compress`` and ``decompress`` shard frame
    blocks over. ``device=None`` means the CUDA card; ``device="cpu"`` runs
    the device programs' plain PyTorch versions."""

    def __init__(self, config: CodecConfig | None = None, mesh=None, *, device=None) -> None:
        self.config = config or CodecConfig()
        self.mesh = mesh
        self.device = device

    def compress(self, data) -> bytes:
        """Compress ``data`` into one LZ4 frame on the device (64 and 256 KiB
        blocks through the all-device encoder, larger ones through the
        hybrid encoder)."""
        from ..frame.device import compress_frame_device

        with trace.request("codec.compress"):
            return compress_frame_device(data, self.config.frame_info(), mesh=self.mesh,
                                         device=self.device, verify=self.config.verify)

    def decompress(self, data) -> bytes:
        """Decompress every concatenated LZ4 frame in ``data``."""
        from ..frame.device import decompress_frame_device

        with trace.request("codec.decompress"):
            return decompress_frame_device(data, mesh=self.mesh, device=self.device)

    def compress_block(self, data, ext_dict=b"") -> bytes:
        """Compress one raw LZ4 block with the all-device encoder."""
        from ..ops.encode import compress_block_device

        return compress_block_device(data, ext_dict, verify=self.config.verify, device=self.device)

    def decompress_block(self, data, max_output_size: int, ext_dict=b"") -> bytes:
        """Decompress one raw LZ4 block."""
        from ..ops.decode import decode_block_device

        return decode_block_device(data, max_output_size, ext_dict, device=self.device)

    def encode_step(self, block_bytes, dict_lens, total_lens):
        """Batched block encode on the codec's device: (B, S) uint8 rows
        (dict ++ data, zero padded; S a multiple of 4) and their (B,)
        dictionary and dictionary + data lengths -> ((B, C) uint8 payloads,
        zero past each end, and (B,) int32 lengths), C the size bucket of the
        worst-case payload of S bytes. Tensors (or arrays) go to the device;
        the outputs stay there. No verify walk runs here: the payloads are
        the device encoder's own."""
        import torch

        from ..ops.ringdecode import resolve_device
        from ..parallel.pipeline import _encode_batch, encode_geometry

        dev = resolve_device(self.device)
        rows = torch.as_tensor(block_bytes, dtype=torch.uint8).to(dev)
        width = rows.shape[1]
        words = packing.bytes_to_words(rows).reshape(rows.shape[0], width // 4)
        return _encode_batch(rows, words, torch.as_tensor(dict_lens).to(dev),
                             torch.as_tensor(total_lens).to(dev),
                             **encode_geometry(width, width))

    def decode_step(self, comp_bytes, comp_lens):
        """Batched independent-block decode on the codec's device: (B, C)
        uint8 payload rows and (B,) lengths -> ((B, S) uint8 outputs, (B,)
        int32 lengths, (B, 5) bool error flags [literal_oob, truncated,
        offset_zero, offset_oob, output_too_small]), S the size bucket of the
        configured block size. Tensors (or arrays) go to the device; the
        outputs stay there.

        Contract: C must exceed every comp_len by at least one zero byte
        (truncation detection for blocks ending mid-LSIC run)."""
        import torch

        from ..ops.ringdecode import resolve_device
        from ..parallel.pipeline import _decode_batch

        with trace.request("codec.decode_step"):
            dev = resolve_device(self.device)
            rows = torch.as_tensor(comp_bytes, dtype=torch.uint8).to(dev)
            lens = torch.as_tensor(comp_lens, dtype=torch.int32).to(dev)
            width = rows.shape[1]
            out_pad = packing.size_bucket(self.config.block_size.get_size())
            nseq_pad = packing.size_bucket(max(8, width // 3 + 2), minimum=256)
            return _decode_batch(rows, lens, out_pad=out_pad, nseq_pad=nseq_pad)
