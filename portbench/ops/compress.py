"""``LZ4Codec(config).compress(data)``: slices of the seeded text; the answer
is one LZ4 frame (host bytes).

Judged: each kept frame decoded by the plain reference decoder and compared
with its input, its header flags with the configuration and its content
checksum with the input's xxHash32 (``frames_bad``, ``header_mismatch``,
``wrong_bytes``, limit 0). Where the configuration names the all-device
encoder, the window's counters hold that encoder to its output as well: the
port's verify guard replaces a device payload that does not decode to its
input with the host encoder's bytes, so a broken device encode would still
give right frames. ``verify_fallback_pct`` (payloads replaced, per 100
blocks encoded) has a limit above the rare fingerprint collisions of sound
runs, and ``no_device_encode`` (1 when no ``match_core`` dispatch ran) has
limit 0. Control: the frozen encoder with each block's matches reaching into
the block before it, under a header that says independent blocks.
"""

from __future__ import annotations

from dataclasses import dataclass

from portbench.gen import frozen
from portbench.reference import lz4_ref

#: Payloads the verify guard replaced, per 100 blocks encoded in the window:
#: the limit of ``verify_fallback_pct`` (PERF.md gives its readings).
FALLBACK_PCT_LIMIT = 0.5


@dataclass
class Item:
    data: bytes


def prepare(ctx) -> list[Item]:
    return [Item(ctx.slice_of_text(n).tobytes()) for n in ctx.pool_sizes()]


def weight(item: Item) -> int:
    return len(item.data)


def call(ctx, item: Item) -> bytes:
    return ctx.codec.compress(item.data)


def amounts(item: Item, result) -> tuple[int, int]:
    return len(item.data), len(result)


def check(ctx, pool, kept, window=None) -> dict:
    fc = ctx.config["frame"]
    total = {"frames_bad": 0, "header_mismatch": 0, "wrong_bytes": 0}
    for i, frame in kept.items():
        data = pool[i].data
        want = frozen.xxh32(data) if fc["content_checksum"] else None
        for k, v in lz4_ref.check_frame(frame, data, fc, want).items():
            total[k] += v
    out = {k: (v, 0) for k, v in total.items()}
    if window is not None and ctx.config.get("encoder") == "all-device":
        block = fc["block_size"]
        blocks = sum(-(-n // block) for n in window.in_bytes)
        replaced = window.stats.get("encode.verify_fallbacks", 0)
        out["verify_fallback_pct"] = (100.0 * replaced / max(blocks, 1), FALLBACK_PCT_LIMIT)
        out["no_device_encode"] = (int(window.stats.get("encode.match_calls", 0) == 0), 0)
    return out


def control(ctx, item: Item) -> bytes:
    return frozen.frame(item.data, **ctx.frame_args(), link_blocks=True)
