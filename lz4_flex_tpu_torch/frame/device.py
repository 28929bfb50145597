"""One-shot frame codec on the device engine.

Encode: all blocks of the input staged at once and encoded on the card in
batched dispatches (parallel/pipeline.py: encode_blocks_sharded; a linked
block's dictionary is the 64 KiB of input before it), framed by a
FrameEncoder on the device engine (frame/encoder.py).

Decode: every frame body in ``data`` goes through the ring decoder as one
plan (ops/ringdecode.py: decode_parts_ring), linked or independent; a body
whose plan overflows its static shape goes through the expansion engine on
the same device instead (ops/decode.py: decode_parts_fused), counted in
``ringdecode.stats["overflow_fused_decodes"]``. Given a mesh, an
independent frame of more than one block, all compressed, shards over it
instead (parallel/pipeline.py: decode_blocks_sharded: one plan a mesh entry,
one grouped kernel launch a card).

``mesh=None`` means the one device that ``device`` names (the JAX package's
means every device; on one card the two agree).

The frame walk, header and checksum handling match the reference's wire
format: descriptor, BlockInfo words with the stored-block fallback, optional
xxHash32 block and content checksums, end mark, legacy and skippable frames,
and concatenated frames. Every xxHash32 pass is a ``frame.xxh`` span, and
every content checksum checked counts in
``ringdecode.stats["content_checksums"]``.
"""

from __future__ import annotations

import io
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
from ..utils import trace
from ..utils.checksum import xxh32
from . import errors
from .header import BlockInfo, BlockInfoKind, BlockMode, FrameInfo


def _is_any_magic(word: int) -> bool:
    return (
        word == LZ4F_MAGIC_NUMBER
        or word == LZ4F_LEGACY_MAGIC_NUMBER
        or LZ4F_SKIPPABLE_MAGIC_MIN <= word <= LZ4F_SKIPPABLE_MAGIC_MAX
    )


def compress_frame_device(data, frame_info: FrameInfo | None = None, *, mesh=None,
                          device=None, verify: bool = True) -> bytes:
    """Compress ``data`` into one LZ4 frame with the device encoder, the
    promised content size checked before any block is encoded: a
    :class:`FrameEncoder` on ``engine="device"`` given all of ``data`` in one
    write, so the frame's blocks are staged at once and encoded in batched
    dispatches.

    ``mesh`` (a list of devices, parallel/mesh.py) shards the blocks over
    its entries; without one, ``device=None`` means the CUDA card and
    ``device="cpu"`` runs the same torch ops on the CPU. ``verify`` (default
    on) checks every payload of the all-device encoder with the native
    verify walk and re-encodes a mismatching block on the host."""
    from .encoder import FrameEncoder

    with trace.span("frame.encode"):
        data = bytes(data)
        fi = frame_info if frame_info is not None else FrameInfo()
        buf = io.BytesIO()
        enc = FrameEncoder(buf, fi, engine="device", mesh=mesh, device=device, verify=verify)
        if fi.content_size is not None and fi.content_size != len(data):
            raise errors.ContentLengthError(fi.content_size, len(data))
        enc.write(data)
        enc.finish()
        return buf.getvalue()


def decompress_frame_device(data, *, mesh=None, device=None) -> bytes:
    """Decompress every concatenated frame in ``data`` on the device.

    Given ``mesh``, an independent frame of more than one block, every block
    compressed, shards over it (``decode_blocks_sharded``), and every other
    frame decodes on its first entry. Without one, ``device=None`` means the
    CUDA card and ``device="cpu"`` runs the ring kernel's and the expansion
    engine's plain PyTorch versions."""
    from ..ops.decode import decode_parts_fused
    from ..ops.ringdecode import decode_parts_ring, resolve_device, stats
    from ..parallel.mesh import codec_mesh

    if mesh is not None:
        mesh = codec_mesh(mesh)
        dev = mesh[0]
    else:
        dev = resolve_device(device)
    with trace.span("frame.decode"):
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
                    with trace.span("frame.xxh"):
                        got = xxh32(payload, 0)
                    if got != expected:
                        raise errors.BlockChecksumError()
                parts.append((payload, info.kind is BlockInfoKind.Compressed))

            # ---- device decode ------------------------------------------------
            independent = fi.legacy_frame or fi.block_mode == BlockMode.Independent
            try:
                if (mesh is not None and not fi.legacy_frame and fi.block_mode == BlockMode.Independent
                        and len(parts) > 1 and all(is_comp for _, is_comp in parts)):
                    from ..parallel.pipeline import decode_blocks_sharded

                    out = b"".join(decode_blocks_sharded([p for p, _ in parts], max_block_size,
                                                         mesh=mesh))
                else:
                    out = decode_parts_ring(
                        parts, independent=independent, max_block_size=max_block_size, device=dev
                    )
                if out is None:
                    stats["overflow_fused_decodes"] += 1
                    out = decode_parts_fused(
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
                    with trace.span("frame.xxh"):
                        got = xxh32(out, 0)
                    stats["content_checksums"] += 1
                    if got != expected:
                        raise errors.ContentChecksumError()
            chunks.append(out)
        return b"".join(chunks)
