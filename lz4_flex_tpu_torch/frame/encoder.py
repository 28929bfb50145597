"""Streaming LZ4 frame encoder.

The JAX package's ``frame/encoder.py`` on the port's engines (lz4_flex's
FrameEncoder, src/frame/compress.rs:62-404): buffered writes, block size
chosen from the first write, independent and linked blocks with the 64 KiB
window carried across them, stored blocks where compression does not
shrink, optional block and content checksums, the promised content size
checked, one encoder reused across frames, a finish-on-close wrapper, and
legacy frames written as well as read.

``engine="host"`` (default) drives the native encoder block by block, its
match table carried across blocks with 64-bit stream positions.
``engine="device"`` sends the full blocks buffered by each write through
the device encoder on the card (parallel/pipeline.py: encode_blocks): 64
and 256 KiB blocks through the all-device encoder in batched dispatches,
checked by the native verify walk unless ``verify=False``, and 1 to 8 MiB
blocks through the hybrid encoder; given a mesh, the blocks shard over it
and route as ``encode_blocks_sharded`` routes them (1 to 8 MiB blocks
through ``compress_block_device`` on a mesh of more than one entry).
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native as _native
from ..spec.constants import LZ4F_LEGACY_MAGIC_NUMBER, WINDOW_SIZE
from ..utils import trace
from ..utils.checksum import XxHash32, xxh32
from . import errors
from .header import BlockInfo, BlockInfoKind, BlockMode, BlockSize, FrameInfo


class FrameEncoder:
    """A writer compressing bytes into an LZ4 frame on an underlying stream.

    Must be finalized with :meth:`finish` / :meth:`try_finish`, or used as a
    context manager (which finishes on exit). ``mesh`` (a list of devices,
    parallel/mesh.py; ``None``: the one device ``device`` names), ``device``
    (``None`` = the CUDA card, or ``"cpu"``) and ``verify`` (default on:
    each payload of the all-device encoder checked by the native verify
    walk, a mismatching block re-encoded on the host) serve
    ``engine="device"``.
    """

    def __init__(self, w, frame_info: FrameInfo | None = None, *, engine: str = "host",
                 mesh=None, device=None, verify: bool = True) -> None:
        if engine not in ("host", "device"):
            raise ValueError(f"unknown engine {engine!r}")
        self._mesh = None
        if engine == "device":
            from ..ops.ringdecode import resolve_device
            from ..parallel.mesh import codec_mesh

            self._mesh = codec_mesh(mesh) if mesh is not None else [resolve_device(device)]
        self._w = w
        self._frame_info = frame_info if frame_info is not None else FrameInfo()
        self._is_frame_open = False
        self._data_to_frame_written = False
        self._content_len = 0
        self._content_hasher = XxHash32(0)
        self._pending = bytearray()
        self._window = b""
        self._table = _native.new_table()
        self._engine = engine
        self._verify = verify

    # -- accessors ----------------------------------------------------------

    @property
    def frame_info(self) -> FrameInfo:
        return self._frame_info

    def get_ref(self):
        return self._w

    def get_mut(self):
        return self._w

    def into_inner(self):
        """Return the underlying writer without flushing (may leave the
        output unfinished)."""
        return self._w

    # -- context manager / auto-finish --------------------------------------

    def __enter__(self) -> "FrameEncoder":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.try_finish()

    def auto_finish(self) -> "AutoFinishEncoder":
        return AutoFinishEncoder(self)

    # -- frame lifecycle -----------------------------------------------------

    def _begin_frame(self, buf_len: int) -> None:
        if self._frame_info.block_size == BlockSize.Auto:
            self._frame_info.block_size = BlockSize.from_buf_length(buf_len)
        if self._frame_info.legacy_frame:
            # Legacy frames are always independent 8 MiB blocks.
            self._frame_info.block_size = BlockSize.Max8MB
            self._frame_info.block_mode = BlockMode.Independent
        self._is_frame_open = True
        if self._frame_info.legacy_frame:
            self._w.write(struct.pack("<I", LZ4F_LEGACY_MAGIC_NUMBER))
        else:
            self._w.write(self._frame_info.write())
        if self._content_len != 0:
            # Second or later frame on this encoder: reset compressor state.
            self._content_len = 0
            self._content_hasher = XxHash32(0)
            self._window = b""
            self._table[:] = 0

    def _end_frame(self) -> None:
        self._is_frame_open = False
        if self._frame_info.legacy_frame:
            return  # legacy frames have no end mark or checksums
        if (
            self._frame_info.content_size is not None
            and self._frame_info.content_size != self._content_len
        ):
            raise errors.ContentLengthError(self._frame_info.content_size, self._content_len)
        self._w.write(BlockInfo(BlockInfoKind.EndMark).write())
        if self._frame_info.content_checksum:
            with trace.span("frame.xxh"):
                digest = self._content_hasher.digest()
            self._w.write(struct.pack("<I", digest))

    def _compress_pending_block(self, block: bytes) -> bytes:
        """Compress one block with the carried window and table."""
        window = self._window
        arr = np.empty(len(window) + len(block), np.uint8)
        arr[: len(window)] = np.frombuffer(window, np.uint8)
        arr[len(window) :] = np.frombuffer(block, np.uint8)
        return _native.compress_block(
            arr,
            input_pos=len(window),
            input_stream_offset=self._content_len - len(block) - len(window),
            table=self._table,
            use_hash5=True,
        )

    def _write_framed(self, comp: bytes, raw: bytes) -> None:
        """Write one block's payload (or the raw bytes, stored, where it did
        not shrink) with its BlockInfo word and checksum."""
        fi = self._frame_info
        if fi.legacy_frame:
            self._w.write(struct.pack("<I", len(comp)))
            self._w.write(comp)
            return
        if len(comp) < len(raw):
            info, payload = BlockInfo(BlockInfoKind.Compressed, len(comp)), comp
        else:
            info, payload = BlockInfo(BlockInfoKind.Uncompressed, len(raw)), raw
        self._w.write(info.write())
        self._w.write(payload)
        if fi.block_checksums:
            with trace.span("frame.xxh"):
                digest = xxh32(payload, 0)
            self._w.write(struct.pack("<I", digest))
        if fi.content_checksum:
            with trace.span("frame.xxh"):
                self._content_hasher.write(raw)

    def _write_block(self) -> None:
        max_block_size = self._frame_info.block_size.get_size()
        block = bytes(self._pending[:max_block_size])
        del self._pending[: len(block)]
        self._content_len += len(block)
        self._write_framed(self._compress_pending_block(block), block)
        if self._frame_info.block_mode == BlockMode.Linked:
            self._window = (self._window + block)[-WINDOW_SIZE:]

    # -- device engine ---------------------------------------------------------

    def _write_device_blocks(self, *, all_pending: bool) -> None:
        """Compress every buffered full block (all buffered bytes when
        ``all_pending``) on the device, in batched dispatches, and write
        them in frame order."""
        from ..parallel.pipeline import encode_blocks

        fi = self._frame_info
        bs = fi.block_size.get_size()
        take = len(self._pending) if all_pending else len(self._pending) // bs * bs
        if take == 0:
            return
        chunk = bytes(self._pending[:take])
        del self._pending[:take]
        linked = fi.block_mode == BlockMode.Linked and not fi.legacy_frame
        payloads, lens, self._window = encode_blocks(
            chunk, bs, linked=linked, carry=self._window, mesh=self._mesh, verify=self._verify,
        )
        pos = 0
        for comp, blen in zip(payloads, lens):
            self._content_len += blen
            self._write_framed(comp, chunk[pos : pos + blen])
            pos += blen

    # -- io.Write surface -----------------------------------------------------

    def write(self, buf) -> int:
        buf = bytes(buf)
        if not buf:
            # Nothing to buffer. (The JAX package's encoder reads the block
            # size here and raises ValueError while it is still Auto.)
            return 0
        if not self._is_frame_open:
            self._begin_frame(len(buf))
        self._pending += buf
        max_block_size = self._frame_info.block_size.get_size()
        while len(self._pending) >= max_block_size:
            if self._engine == "device":
                self._write_device_blocks(all_pending=False)
            else:
                self._write_block()
        return len(buf)

    def flush(self) -> None:
        """Force-compress any buffered bytes into a (possibly short) block."""
        if self._pending:
            if self._engine == "device":
                self._write_device_blocks(all_pending=True)
            else:
                self._write_block()
        if hasattr(self._w, "flush"):
            self._w.flush()

    def try_finish(self) -> None:
        """Flush buffered data and write the stream terminator (idempotent)."""
        self.flush()
        if not self._is_frame_open:
            if self._data_to_frame_written:
                return  # already finished
            # Empty input still produces a valid (empty) frame.
            self._begin_frame(0)
        self._end_frame()
        self._data_to_frame_written = True

    def finish(self):
        """Finalize the stream and return the underlying writer."""
        self.try_finish()
        return self._w


class AutoFinishEncoder:
    """Wrapper around :class:`FrameEncoder` that finishes the stream when
    closed or garbage-collected; errors during the implicit finish are
    ignored."""

    def __init__(self, encoder: FrameEncoder) -> None:
        self._encoder = encoder

    def write(self, buf) -> int:
        return self._encoder.write(buf)

    def flush(self) -> None:
        self._encoder.flush()

    def close(self) -> None:
        enc, self._encoder = self._encoder, None
        if enc is not None:
            try:
                enc.try_finish()
            except Exception:
                pass

    def __enter__(self) -> "AutoFinishEncoder":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def __del__(self) -> None:
        self.close()
