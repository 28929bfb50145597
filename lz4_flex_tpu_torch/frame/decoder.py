"""Streaming LZ4 frame decoder.

The JAX package's ``frame/decoder.py`` on the port's engines: incremental
header parsing (standard, legacy and skippable frames), stored and
compressed blocks, the linked-block 64 KiB window carried across blocks,
block and content checksums, content-size validation, and the reference's
frame-boundary contract (lz4_flex src/frame/decompress.rs:48-422): ``read``
returns 0 at the end of each frame and a later ``read`` resumes with the
next concatenated frame. Within a legacy frame a magic number in block
position starts the next frame, and ``read_all()`` drains every
concatenated frame at once.

Two block engines serve the same io surface. ``engine="host"`` (default)
decodes block by block on the native runtime. ``engine="device"`` greedily
batches blocks and decodes each batch with one launch of the ring kernel
(ops/ringdecode.py). Independent and legacy batches are pipelined: batch i
is dispatched without synchronizing, and the host reads and plans batch i+1
while the card decodes batch i; only ``_flush_pending`` brings a batch back.
Linked batches decode synchronously, the carried window riding ahead of them
as a stored pseudo-block. A batch whose plan overflows its static shape is
split into smaller plans, each launched on the card; a single block whose
plan overflows decodes through the expansion engine on the card
(ops/decode.py:decode_parts_fused). No batch decodes on the host.
``device=None`` means the CUDA card; ``device="cpu"`` runs the kernel's and
the expansion engine's plain PyTorch versions.
"""

from __future__ import annotations

import io
import struct

from .. import native as _native
from ..block.errors import DecompressError
from ..spec.constants import (
    LZ4F_LEGACY_MAGIC_NUMBER,
    MAGIC_NUMBER_SIZE,
    MIN_FRAME_INFO_SIZE,
    WINDOW_SIZE,
)
from ..utils import trace
from ..utils.checksum import XxHash32, xxh32
from . import errors
from .device import _is_any_magic
from .header import BlockInfo, BlockInfoKind, BlockMode, FrameInfo

# Largest legacy block payload: the compress bound of an 8 MiB block.
_LEGACY_MAX_PAYLOAD = 16 + 4 + (8 * 1024 * 1024 * 110) // 100


def _fetch(pieces) -> bytes:
    """The decoded bytes of (flat device tensor, total) pieces, in order."""
    return b"".join(t[:n].cpu().numpy().tobytes() for t, n in pieces)


def _split_overflow(nblocks: int) -> int:
    """Where to split a batch of several blocks whose ring plan overflows
    its static shape: counted in ``ringdecode.stats["overflow_splits"]``."""
    from ..ops import ringdecode

    ringdecode.stats["overflow_splits"] += 1
    return nblocks // 2


class FrameDecoder(io.RawIOBase):
    """A reader decompressing LZ4 frames from an underlying stream.

    ``mesh`` is accepted and not read, as in the JAX package: the device
    engine decodes its batches on ``device``."""

    #: device engine: max blocks batched per dispatch, the payload-bytes
    #: budget that bounds read-ahead memory (8 MiB ≈ one legacy block), and
    #: the projected-decoded-bytes budget that bounds the dispatch's output
    #: and plan (without it, 32 highly compressible legacy blocks could
    #: decode to ~256 MiB in one batch).
    DEVICE_BATCH_BLOCKS = 32
    DEVICE_BATCH_BYTES = 8 * 1024 * 1024
    DEVICE_BATCH_DECODED_BYTES = 32 * 1024 * 1024

    def __init__(self, r, *, engine: str = "host", mesh=None, device=None) -> None:
        super().__init__()
        if engine not in ("host", "device"):
            raise ValueError(f"unknown engine {engine!r}")
        self._device = None
        if engine == "device":
            from ..ops.ringdecode import resolve_device

            self._device = resolve_device(device)
        self._r = r
        self._pushback = b""  # bytes read ahead of the current position
        self._frame_info: FrameInfo | None = None
        self._content_hasher = XxHash32(0)
        self._content_len = 0
        self._window = b""
        self._out = b""
        self._out_pos = 0
        self._engine = engine
        # device-engine pipeline: one dispatched, not yet fetched batch, as
        # its (flat uint8 tensor on the device, total_out) pieces
        self._pending = None
        self._parts_stash = None  # sync-path batch deferred by a flush

    # -- accessors ------------------------------------------------------------

    def get_ref(self):
        return self._r

    def get_mut(self):
        return self._r

    def into_inner(self):
        return self._r

    @property
    def frame_info(self) -> FrameInfo | None:
        """FrameInfo of the frame being decoded (None between frames)."""
        return self._frame_info

    def readable(self) -> bool:
        return True

    # -- low-level input ------------------------------------------------------

    def _read_upto(self, n: int) -> bytes:
        if self._pushback:
            take, self._pushback = self._pushback[:n], self._pushback[n:]
            if len(take) == n:
                return take
            rest = self._r.read(n - len(take)) or b""
            return take + rest
        return self._r.read(n) or b""

    def _read_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            b = self._read_upto(n - got)
            if not b:
                raise errors.FrameError(f"unexpected end of stream: needed {n} bytes, got {got}")
            chunks.append(b)
            got += len(b)
        return b"".join(chunks)

    # -- frame parsing ----------------------------------------------------------

    def _read_frame_info(self) -> bool:
        """Parse the next frame header. Returns False on clean EOF."""
        head = self._read_upto(MAGIC_NUMBER_SIZE)
        if not head:
            return False
        if len(head) < MAGIC_NUMBER_SIZE:
            head += self._read_exact(MAGIC_NUMBER_SIZE - len(head))
        (magic,) = struct.unpack("<I", head)
        if magic != LZ4F_LEGACY_MAGIC_NUMBER:
            head += self._read_exact(MIN_FRAME_INFO_SIZE - MAGIC_NUMBER_SIZE)
        required = FrameInfo.read_size(head)
        if required > len(head):
            head += self._read_exact(required - len(head))
        frame_info = FrameInfo.read(head)  # raises SkippableFrame for skippables
        if frame_info.dict_id is not None:
            raise errors.DictionaryNotSupported()
        self._frame_info = frame_info
        self._content_hasher = XxHash32(0)
        self._content_len = 0
        self._window = b""
        self._out = b""
        self._out_pos = 0
        return True

    def _check_block_checksum(self, data: bytes) -> None:
        (expected,) = struct.unpack("<I", self._read_exact(4))
        with trace.span("frame.xxh"):
            got = xxh32(data, 0)
        if got != expected:
            raise errors.BlockChecksumError()

    def _decompress_block(self, comp: bytes, max_block_size: int) -> bytes:
        try:
            return _native.decompress_block(comp, max_block_size, ext_dict=self._window)
        except DecompressError as e:
            raise errors.DecompressionError(e) from e

    def _end_of_frame(self) -> None:
        fi = self._frame_info
        if fi.content_size is not None and self._content_len != fi.content_size:
            raise errors.ContentLengthError(fi.content_size, self._content_len)
        if fi.content_checksum:
            (expected,) = struct.unpack("<I", self._read_exact(4))
            with trace.span("frame.xxh"):
                got = self._content_hasher.digest()
            if self._engine == "device":
                from ..ops import ringdecode

                ringdecode.stats["content_checksums"] += 1
            if got != expected:
                raise errors.ContentChecksumError()
        self._frame_info = None

    # -- device engine ---------------------------------------------------------

    def _flush_pending(self) -> int:
        """Fetch and emit the dispatched, not yet fetched batch, if any. The
        only place where the device engine waits for the card on the
        pipelined path."""
        if self._pending is None:
            return 0
        pieces, self._pending = self._pending, None
        # self._parts_stash must survive this: the sync path stashes the
        # just-collected parts and then flushes the in-flight batch; the
        # stash is consumed at the top of the next _read_blocks_device.
        out = _fetch(pieces)
        self._append_output(out)
        return len(out)

    def _part_sizes(self, parts, max_block_size: int) -> list[int]:
        from ..ops import ringdecode

        try:
            return ringdecode.part_sizes(parts, max_block_size)
        except DecompressError as e:
            raise errors.DecompressionError(e) from e

    def _dispatch(self, parts, sizes, independent: bool):
        """One plan and one K1 launch, not fetched: (flat device tensor,
        total), or None when the plan overflows its static shape past the
        NFMAX ladder."""
        from ..ops import ringdecode

        try:
            return ringdecode.dispatch_parts_ring(
                parts, independent=independent, sizes=sizes, device=self._device
            )
        except DecompressError as e:
            raise errors.DecompressionError(e) from e

    def _fused(self, parts, independent: bool):
        """Decode a body whose ring plan overflows, one block (after its
        window in linked mode), through the expansion engine on the card:
        (flat device tensor, total), not fetched. Counted in
        ``ringdecode.stats["overflow_fused_decodes"]``."""
        from ..ops import decode, ringdecode

        ringdecode.stats["overflow_fused_decodes"] += 1
        try:
            out = decode.decode_parts_fused(parts, independent=independent,
                                            device=self._device, as_array=True)
        except DecompressError as e:
            raise errors.DecompressionError(e) from e
        return out, out.shape[0]

    def _dispatch_parts_device(self, parts, sizes) -> list:
        """Launch K1 on an independent-mode batch without fetching: the
        (flat device tensor, total) pieces in order, one per plan. A batch
        whose plan overflows is split in two (``_split_overflow``) and each
        half planned again; a single block whose plan overflows takes the
        expansion engine. The card decodes it either way."""
        r = self._dispatch(parts, sizes, True)
        if r is None and len(parts) == 1:
            r = self._fused(parts, True)
        if r is not None:
            return [r]
        h = _split_overflow(len(parts))
        return (self._dispatch_parts_device(parts[:h], sizes[:h])
                + self._dispatch_parts_device(parts[h:], sizes[h:]))

    def _decode_linked(self, parts, sizes, window: bytes) -> bytes:
        """Decode a linked-mode batch synchronously. The carried 64 KiB
        window rides ahead as a stored pseudo-block, so window references
        resolve through the kernel's ring, and is sliced off. A batch whose
        plan overflows is split in two, the second half's window taken from
        the first half's output; a single block whose plan overflows takes
        the expansion engine, its window ahead of it as here."""
        full, fsizes = parts, sizes
        if window:
            full, fsizes = [(window, False), *parts], [len(window), *sizes]
        r = self._dispatch(full, fsizes, False)
        if r is None and len(parts) == 1:
            r = self._fused(full, False)
        if r is not None:
            out, total = r
            return _fetch([(out[len(window) :], total - len(window))])
        h = _split_overflow(len(parts))
        first = self._decode_linked(parts[:h], sizes[:h], window)
        return first + self._decode_linked(parts[h:], sizes[h:], (window + first)[-WINDOW_SIZE:])

    def _decode_parts_device(self, parts, sizes) -> bytes:
        """Decode a batch synchronously: an empty one (no launch), or a
        linked one (independent batches always take the pipelined path)."""
        if not sum(sizes):
            return b""
        return self._decode_linked(parts, sizes, self._window)

    def _read_blocks_device(self) -> int:
        """Device-engine block read: greedily collect a batch of blocks (up to
        the three budgets, stopping early at the frame end), decode it with
        one launch (one per plan where its plan overflows and splits), and
        emit a batch as the current output span. Wire-format
        handling (BlockInfo words, checksums, end marks, legacy magic
        boundaries) is the host engine's; only the decode is batched."""
        fi = self._frame_info
        max_block_size = fi.block_size.get_size()
        if self._parts_stash is not None:
            parts, sizes = self._parts_stash
            self._parts_stash = None
            out = self._decode_parts_device(parts, sizes)
            self._append_output(out)
            return len(out)
        parts: list[tuple[bytes, bool]] = []
        total = 0
        projected = 0  # decoded-bytes upper bound (stored: exact; else max)

        while (
            len(parts) < self.DEVICE_BATCH_BLOCKS
            and total <= self.DEVICE_BATCH_BYTES
            and projected < self.DEVICE_BATCH_DECODED_BYTES
        ):
            word_bytes = self._read_upto(4)
            if len(word_bytes) == 0:
                if parts:
                    break  # decode what we have; EOF surfaces next call
                if self._pending is not None:
                    return self._flush_pending()
                self._frame_info = None
                return 0
            if len(word_bytes) < 4:
                word_bytes += self._read_exact(4 - len(word_bytes))

            if fi.legacy_frame:
                (word,) = struct.unpack("<I", word_bytes)
                if _is_any_magic(word):
                    self._pushback = word_bytes + self._pushback
                    if parts:
                        break
                    if self._pending is not None:
                        return self._flush_pending()
                    self._frame_info = None
                    return 0
                if word > _LEGACY_MAX_PAYLOAD:
                    raise errors.BlockTooBig()
                parts.append((self._read_exact(word), True))
                total += word
                projected += 8 * 1024 * 1024  # legacy max block size
                continue

            info = BlockInfo.read(word_bytes)
            if info.kind is BlockInfoKind.EndMark:
                if parts:
                    # decode the batch first; see the end mark again next call
                    self._pushback = word_bytes + self._pushback
                    break
                if self._pending is not None:
                    # emit the in-flight batch; see the end mark again next call
                    self._pushback = word_bytes + self._pushback
                    return self._flush_pending()
                self._end_of_frame()
                return 0
            if info.size > max_block_size:
                raise errors.BlockTooBig()
            payload = self._read_exact(info.size)
            if fi.block_checksums:
                self._check_block_checksum(payload)
            parts.append((payload, info.kind is BlockInfoKind.Compressed))
            total += info.size
            projected += max_block_size if info.kind is BlockInfoKind.Compressed else info.size

        # Pipelined path (independent and legacy frames): dispatch this batch
        # and emit the previous one while the card works on it.
        sizes = self._part_sizes(parts, max_block_size)
        independent = fi.legacy_frame or fi.block_mode == BlockMode.Independent
        if independent and sum(sizes):
            pieces = self._dispatch_parts_device(parts, sizes)
            prev_emitted = self._flush_pending()
            self._pending = pieces
            if prev_emitted:
                return prev_emitted
            # first batch of the pipeline: prime it by reading the next one
            return self._read_blocks_device()
        if self._pending is not None:
            # no launch for this batch while one is in flight: emit the
            # in-flight batch now, decode the collected parts next call
            self._parts_stash = (parts, sizes)
            return self._flush_pending()
        out = self._decode_parts_device(parts, sizes)
        self._append_output(out)
        return len(out)

    def _read_block(self) -> int:
        """Decode the next block into the output buffer. Returns its size
        (0 = end of frame or stream)."""
        if self._engine == "device":
            return self._read_blocks_device()
        fi = self._frame_info
        max_block_size = fi.block_size.get_size()

        word_bytes = self._read_upto(4)
        if len(word_bytes) == 0:
            # EOF at a block boundary ends the stream cleanly.
            self._frame_info = None
            return 0
        if len(word_bytes) < 4:
            word_bytes += self._read_exact(4 - len(word_bytes))

        if fi.legacy_frame:
            (word,) = struct.unpack("<I", word_bytes)
            if _is_any_magic(word):
                # Next frame follows immediately (no end mark in legacy frames).
                self._pushback = word_bytes + self._pushback
                self._frame_info = None
                return 0
            if word > _LEGACY_MAX_PAYLOAD:
                raise errors.BlockTooBig()
            out = self._decompress_block(self._read_exact(word), max_block_size)
            self._append_output(out)
            return len(out)

        info = BlockInfo.read(word_bytes)
        if info.kind is BlockInfoKind.EndMark:
            self._end_of_frame()
            return 0
        if info.size > max_block_size:
            raise errors.BlockTooBig()
        payload = self._read_exact(info.size)
        if fi.block_checksums:
            self._check_block_checksum(payload)
        if info.kind is BlockInfoKind.Uncompressed:
            out = payload
        else:
            out = self._decompress_block(payload, max_block_size)
        self._append_output(out)
        return len(out)

    def _append_output(self, out: bytes) -> None:
        fi = self._frame_info
        self._out = out
        self._out_pos = 0
        self._content_len += len(out)
        if fi.content_checksum:
            with trace.span("frame.xxh"):
                self._content_hasher.write(out)
        if fi.block_mode == BlockMode.Linked:
            self._window = (self._window + out)[-WINDOW_SIZE:]

    # -- io.RawIOBase surface ----------------------------------------------------

    def readinto(self, b) -> int:
        view = memoryview(b)
        if len(view) == 0:
            return 0
        while True:
            avail = len(self._out) - self._out_pos
            if avail > 0:
                n = min(avail, len(view))
                view[:n] = self._out[self._out_pos : self._out_pos + n]
                self._out_pos += n
                return n
            if self._frame_info is None:
                if not self._read_frame_info():
                    return 0
            if self._read_block() == 0:
                # Frame boundary: signal EOF; the next read resumes with the
                # next concatenated frame (reference contract).
                return 0

    def read_all(self) -> bytes:
        """Drain every concatenated frame from the stream (extension)."""
        chunks = []
        while True:
            got = self.readall()  # reads until a frame boundary
            if got:
                chunks.append(got)
                continue
            # A zero-length result is either a frame boundary or true EOF;
            # probe for another frame.
            if self._frame_info is None and not self._probe_next_frame():
                break
        return b"".join(chunks)

    def _probe_next_frame(self) -> bool:
        head = self._read_upto(1)
        if not head:
            return False
        self._pushback = head + self._pushback
        return True
