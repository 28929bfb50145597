"""``LZ4Codec(config).decode_step(rows, lens)``: batches of B independent
64 KiB blocks, each a slice of the seeded text compressed by the frozen
encoder, as (B, row_width) uint8 payload rows zero-padded past each length,
placed on the card in set-up. The answer stays on the device
(outputs, lengths, error flags), ready after ``synchronize()``.

Judged: each kept batch's outputs byte for byte against its blocks
(``wrong_bytes``), its lengths (``wrong_lengths``) and its error flags
(``error_rows``), limit 0. Control: the reference decoder with matches
copied as one memmove, row by row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.gen import frozen
from portbench.reference import lz4_ref


@dataclass
class Item:
    data: np.ndarray  # (B, block) the blocks' text
    payloads: list  # the frozen encoder's blocks
    rows: torch.Tensor  # (B, row_width) uint8 on the device
    lens: torch.Tensor  # (B,) int32 on the device


def prepare(ctx) -> list[Item]:
    block = ctx.config["frame"]["block_size"]
    width = ctx.traffic["row_width"]
    datas = [np.stack([ctx.slice_of_text(block) for _ in range(nblocks)])
             for nblocks in ctx.pool_sizes()]
    flat = frozen.compress_blocks(np.concatenate(datas), block)
    items, at = [], 0
    for data in datas:
        nblocks = data.shape[0]
        payloads, at = flat[at : at + nblocks], at + nblocks
        if max(len(p) for p in payloads) >= width:
            raise ValueError(f"a payload does not fit a row of {width} bytes with a zero after it")
        rows = np.zeros((nblocks, width), np.uint8)
        for r, p in zip(rows, payloads):
            r[: len(p)] = np.frombuffer(p, np.uint8)
        lens = np.array([len(p) for p in payloads], np.int32)
        items.append(Item(data, payloads, torch.from_numpy(rows).to(ctx.device),
                          torch.from_numpy(lens).to(ctx.device)))
    return items


def weight(item: Item) -> int:
    return item.data.size


def call(ctx, item: Item):
    res = ctx.codec.decode_step(item.rows, item.lens)
    ctx.sync()
    return res


def amounts(item: Item, result) -> tuple[int, int]:
    return sum(len(p) for p in item.payloads), item.data.size


def check(ctx, pool, kept, window=None) -> dict:
    wrong = wrong_len = err_rows = 0
    for i, (out, lens, err) in kept.items():
        data = pool[i].data
        got = out[:, : data.shape[1]].cpu().numpy()
        wrong += int(np.count_nonzero(got != data)) + data.shape[0] * max(0, data.shape[1] - got.shape[1])
        wrong_len += int((lens.cpu().numpy() != data.shape[1]).sum())
        err_rows += int(err.cpu().numpy().any(axis=1).sum())
    return {"wrong_bytes": (wrong, 0), "wrong_lengths": (wrong_len, 0), "error_rows": (err_rows, 0)}


def control(ctx, item: Item):
    block = item.data.shape[1]
    out = np.zeros(item.data.shape, np.uint8)
    lens = np.zeros(len(item.payloads), np.int32)
    for r, p in enumerate(item.payloads):
        buf = bytearray()
        lz4_ref.decode_block(p, buf, 0, overlap_as_memmove=True)
        got = np.frombuffer(bytes(buf[:block]), np.uint8)
        out[r, : got.size] = got
        lens[r] = len(buf)
    return (torch.from_numpy(out), torch.from_numpy(lens),
            torch.zeros((len(item.payloads), 5), dtype=torch.bool))
