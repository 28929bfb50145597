"""One-shot frame decode on the device engine.

Every frame body in ``data`` goes through the ring decoder as one plan
(ops/ringdecode.py: decode_parts_ring), linked or independent; the frame
walk, header and checksum handling match the reference's wire format:
descriptor, BlockInfo words with stored blocks, optional xxHash32 block and
content checksums, end mark, legacy and skippable frames, and concatenated
frames.
"""

from __future__ import annotations

import struct

from ..block.errors import DecompressError
from ..spec.constants import (
    LZ4F_LEGACY_MAGIC_NUMBER,
    LZ4F_MAGIC_NUMBER,
    LZ4F_SKIPPABLE_MAGIC_MAX,
    LZ4F_SKIPPABLE_MAGIC_MIN,
    MAGIC_NUMBER_SIZE,
    MIN_FRAME_INFO_SIZE,
)
from ..utils.checksum import xxh32
from . import errors
from .header import BlockInfo, BlockInfoKind, BlockMode, FrameInfo


def _is_any_magic(word: int) -> bool:
    return (
        word == LZ4F_MAGIC_NUMBER
        or word == LZ4F_LEGACY_MAGIC_NUMBER
        or LZ4F_SKIPPABLE_MAGIC_MIN <= word <= LZ4F_SKIPPABLE_MAGIC_MAX
    )


def decompress_frame_device(data, *, device=None) -> bytes:
    """Decompress every concatenated frame in ``data`` on the device.

    ``device=None`` means the CUDA card; ``device="cpu"`` runs the ring
    kernel's plain PyTorch version."""
    from ..ops.ringdecode import decode_parts_ring, resolve_device

    dev = resolve_device(device)
    data = bytes(data)
    pos = 0
    chunks = []
    while pos < len(data):
        # ---- header -------------------------------------------------------
        head = data[pos : pos + MIN_FRAME_INFO_SIZE]
        if len(head) < MAGIC_NUMBER_SIZE:
            raise errors.FrameError("truncated frame header")
        required = FrameInfo.read_size(head)
        head = data[pos : pos + required]
        if len(head) < required:
            raise errors.FrameError("truncated frame header")
        try:
            fi = FrameInfo.read(head)
        except errors.SkippableFrame as sf:
            pos += MAGIC_NUMBER_SIZE + 4 + sf.size
            continue
        if fi.dict_id is not None:
            raise errors.DictionaryNotSupported()
        pos += required
        max_block_size = fi.block_size.get_size()

        # ---- block walk ---------------------------------------------------
        parts = []
        while True:
            if fi.legacy_frame:
                if pos + 4 > len(data):
                    break  # legacy frames end at EOF / next magic
                (word,) = struct.unpack_from("<I", data, pos)
                if _is_any_magic(word):
                    break
                pos += 4
                if word > 16 + 4 + (8 * 1024 * 1024 * 110) // 100:
                    raise errors.BlockTooBig()
                payload = data[pos : pos + word]
                if len(payload) < word:
                    raise errors.FrameError("truncated block")
                pos += word
                parts.append((payload, True))
                continue
            if pos + 4 > len(data):
                raise errors.FrameError("truncated block info")
            info = BlockInfo.read(data[pos : pos + 4])
            pos += 4
            if info.kind is BlockInfoKind.EndMark:
                break
            if info.size > max_block_size:
                raise errors.BlockTooBig()
            payload = data[pos : pos + info.size]
            if len(payload) < info.size:
                raise errors.FrameError("truncated block payload")
            pos += info.size
            if fi.block_checksums:
                if pos + 4 > len(data):
                    raise errors.FrameError("truncated block checksum")
                (expected,) = struct.unpack_from("<I", data, pos)
                pos += 4
                if xxh32(payload, 0) != expected:
                    raise errors.BlockChecksumError()
            parts.append((payload, info.kind is BlockInfoKind.Compressed))

        # ---- device decode ------------------------------------------------
        independent = fi.legacy_frame or fi.block_mode == BlockMode.Independent
        try:
            out = decode_parts_ring(
                parts, independent=independent, max_block_size=max_block_size, device=dev
            )
        except DecompressError as e:
            raise errors.DecompressionError(e) from e

        if not fi.legacy_frame:
            if fi.content_size is not None and len(out) != fi.content_size:
                raise errors.ContentLengthError(fi.content_size, len(out))
            if fi.content_checksum:
                if pos + 4 > len(data):
                    raise errors.FrameError("truncated content checksum")
                (expected,) = struct.unpack_from("<I", data, pos)
                pos += 4
                if xxh32(out, 0) != expected:
                    raise errors.ContentChecksumError()
        chunks.append(out)
    return b"".join(chunks)
