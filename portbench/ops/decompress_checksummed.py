"""``LZ4Codec(config).decompress(frame)`` on frames with a content checksum:
the ``decompress`` operation (frames the frozen encoder made from slices of
the seeded text; host bytes in and out), with the checksum held as well.

Judged: the kept answers as ``decompress`` judges them (``wrong_bytes``,
``wrong_answers``, limit 0); ``checksum_not_refused`` (limit 0), the frames
among the pool's smallest and largest, each with its stored content checksum
altered, that the timed path did not refuse with ``ContentChecksumError``;
and, in a run, ``checksums_unverified`` (limit 0), 1 when the window's
``ringdecode.content_checksums`` count is below its requests. A port
without that counter cannot run the cell: ``prepare`` raises.

Control: the plain reference decoder with no content-checksum check, in
the program's place (``ctx.codec``).
"""

from __future__ import annotations

import struct

from portbench.ops import decompress as _base
from portbench.reference import lz4_ref

Item = _base.Item
weight, call, amounts = _base.weight, _base.call, _base.amounts


def prepare(ctx) -> list[Item]:
    from lz4_flex_tpu_torch.ops import ringdecode

    if "content_checksums" not in ringdecode.stats:
        raise RuntimeError("the port counts no content checksums (ringdecode.stats); "
                           "this cell needs that counter")
    if not ctx.config["frame"]["content_checksum"]:
        raise ValueError("the configuration's frames carry no content checksum")
    return _base.prepare(ctx)


def _altered(item: Item) -> Item:
    """``item`` with the stored content checksum (the frame's last 4 bytes)
    changed."""
    (stored,) = struct.unpack_from("<I", item.frame, len(item.frame) - 4)
    return Item(item.data, item.frame[:-4] + struct.pack("<I", stored ^ 0x00010001))


def check(ctx, pool, kept, window=None) -> dict:
    out = _base.check(ctx, pool, kept, window)
    ends = {min(range(len(pool)), key=lambda i: weight(pool[i])),
            max(range(len(pool)), key=lambda i: weight(pool[i]))}
    from lz4_flex_tpu_torch.frame.errors import ContentChecksumError

    decoded = 0
    for i in sorted(ends):
        try:
            call(ctx, _altered(pool[i]))
        except ContentChecksumError:
            continue
        decoded += 1
    out["checksum_not_refused"] = (decoded, 0)
    if window is not None:
        seen = window.stats.get("ringdecode.content_checksums", 0)
        out["checksums_unverified"] = (int(seen < window.n), 0)
    return out


class _Unchecked:
    """The plain reference decoder as a codec that never compares a frame's
    content checksum with its content."""

    @staticmethod
    def decompress(frame: bytes) -> bytes:
        return lz4_ref.decode_frame(frame)[1]


def control(ctx, item: Item) -> bytes:
    ctx.codec = _Unchecked()
    return call(ctx, item)
