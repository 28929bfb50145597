"""``LZ4Codec(config).decompress(frame)``: frames that the frozen encoder made
from slices of the seeded text; the answer is host bytes.

Judged: every kept answer byte for byte against the text it was made from
(``wrong_bytes``, ``wrong_answers``, limit 0). Control: the reference
decoder with matches copied as one memmove (wrong where a match overlaps
its own output).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.gen import frozen
from portbench.reference import lz4_ref


@dataclass
class Item:
    data: np.ndarray  # the text the frame was made from
    frame: bytes


def prepare(ctx) -> list[Item]:
    args = ctx.frame_args()
    return [Item(d, frozen.frame(d, **args)) for d in map(ctx.slice_of_text, ctx.pool_sizes())]


def weight(item: Item) -> int:
    return item.data.size


def call(ctx, item: Item) -> bytes:
    return ctx.codec.decompress(item.frame)


def amounts(item: Item, result) -> tuple[int, int]:
    return len(item.frame), len(result)


def check(ctx, pool, kept, window=None) -> dict:
    wrong = [lz4_ref.wrong_bytes(res, pool[i].data) for i, res in kept.items()]
    return {"wrong_bytes": (sum(wrong), 0), "wrong_answers": (sum(1 for w in wrong if w), 0)}


def control(ctx, item: Item) -> bytes:
    return lz4_ref.decode_frame(item.frame, overlap_as_memmove=True)[1]
