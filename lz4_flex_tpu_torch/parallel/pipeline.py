"""Frame blocks through the device codec on one card.

The one-card counterpart of the JAX package's
``parallel/pipeline.py:encode_blocks_sharded`` on a one-device mesh:
chunk-scale blocks (at least ``_CHUNK_C`` bytes, so 1, 4 and 8 MiB frame
blocks) go through the hybrid encoder one block at a time, a linked block's
dictionary being the 64 KiB of input before it; smaller blocks (64 and 256
KiB) are staged as rows on the host, dictionary ++ data, and encoded by the
all-device encoder ``_ENCODE_ROWS`` rows to a dispatch (``_encode_staged``),
each payload checked by the native verify walk.

The batched device-resident decode (``_decode_batch``, under
``LZ4Codec.decode_step``) is the one-device case of the JAX package's
``_decode_batch``: its ``vmap`` over rows becomes rows decoded one after
another, since the engines' loops end where each row's data says.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native as _native
from ..block import compress_with_dict
from ..ops import packing
from ..spec.constants import WINDOW_SIZE, get_maximum_output_size

# Rows per encode dispatch. One dispatch of the all-device encoder is ~1,700
# kernel launches whatever its row count, so rows are batched; its
# temporaries take ~250 bytes a position, so 32 rows of 256 KiB blocks
# (393,216 positions each) stay near 3 GB of device memory. encode_blocks
# uploads, encodes and reads back one such group at a time, so a frame's
# device memory is bounded by this constant, not by its input.
_ENCODE_ROWS = 32


def stage_blocks(data, block_size: int, *, linked: bool = False, start: int = 0):
    """Split ``data[start:]`` into frame blocks staged as a dense (B, D+S)
    uint8 array plus per-block (dict_len, total_len) vectors and the block
    count.

    In linked mode each row is prefixed with the previous 64 KiB of input
    (its dictionary); ``data[:start]`` is window context only (the carry
    from blocks a streaming encoder already wrote), so block 0's dictionary
    is its tail."""
    buf = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    n = buf.shape[0] - start
    nblocks = max(1, -(-n // block_size))
    w = WINDOW_SIZE if linked else 0
    width = packing.size_bucket(w + block_size + 4)
    rows = np.zeros((nblocks, width), dtype=np.uint8)
    dlen = np.zeros(nblocks, dtype=np.int32)
    tlen = np.zeros(nblocks, dtype=np.int32)
    for i in range(nblocks):
        s = start + i * block_size
        blk = buf[s : s + block_size]
        d = min(w, s)
        rows[i, : d + blk.shape[0]] = buf[s - d : s + blk.shape[0]]
        dlen[i] = d
        tlen[i] = d + blk.shape[0]
    return rows, dlen, tlen, nblocks


def _encode_batch(rows, words, dlen, tlen, *, levels: int, comp_pad: int, nseq_pad: int):
    """Independent rows through ``ops.encode.encode_chunk_core``,
    ``_ENCODE_ROWS`` to a dispatch: (B, S) uint8 rows (dict ++ data,
    padded), their (B, S / 4) int32 words and (B,) dictionary and
    dictionary + data lengths -> ((B, comp_pad) uint8 payloads, (B,) int32
    lengths), on the rows' device."""
    from ..ops.encode import encode_chunk_core

    outs, totals = [], []
    for g in range(0, rows.shape[0], _ENCODE_ROWS):
        sl = slice(g, g + _ENCODE_ROWS)
        out, total = encode_chunk_core(rows[sl], words[sl], dlen[sl], tlen[sl], levels=levels,
                                       comp_pad=comp_pad, nseq_pad=nseq_pad)
        outs.append(out)
        totals.append(total)
    if not outs:
        return (torch.zeros((0, comp_pad), dtype=torch.uint8, device=rows.device),
                torch.zeros(0, dtype=torch.int32, device=rows.device))
    return torch.cat(outs), torch.cat(totals)


def _encode_staged(rows, dlen, tlen, dev, geo: dict) -> list[bytes]:
    """Staged host rows through ``ops.encode.encode_chunk_core``, one group
    of ``_ENCODE_ROWS`` at a time: each group is uploaded, encoded and its
    payloads read back on its own, so device memory is bounded by the group
    size whatever the input's. On the card the copies go through pinned host
    memory without blocking, and a group's payloads are read only once the
    next group is queued, so the card is not left idle between groups."""
    from ..ops.encode import encode_chunk_core

    cuda = dev.type == "cuda"

    def put(a):
        t = torch.from_numpy(a)
        return t.pin_memory().to(dev, non_blocking=True) if cuda else t

    def get(t):
        if not cuda:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t, non_blocking=True)

    payloads, inflight = [], []

    def read_oldest():
        out, total, done = inflight.pop(0)
        if done is not None:
            done.synchronize()
        out, total = out.numpy(), total.numpy()
        payloads.extend(out[i, : total[i]].tobytes() for i in range(out.shape[0]))

    for g in range(0, rows.shape[0], _ENCODE_ROWS):
        sl = slice(g, g + _ENCODE_ROWS)
        r = put(rows[sl])
        out, total = encode_chunk_core(r, r.view(torch.int32), put(dlen[sl]), put(tlen[sl]), **geo)
        done = None
        if cuda:
            out, total = get(out), get(total)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        inflight.append((out, total, done))
        if len(inflight) > 1:
            read_oldest()
    while inflight:
        read_oldest()
    return payloads


def encode_geometry(width: int, block_size: int) -> dict:
    """The all-device encoder's static shapes for rows of ``width`` bytes
    holding blocks of at most ``block_size`` bytes: the lifting levels, the
    payload width and the sequence-table width."""
    return dict(levels=min(12, max(2, (width - 1).bit_length())),
                comp_pad=packing.size_bucket(get_maximum_output_size(block_size)),
                nseq_pad=packing.size_bucket(max(8, width // 4 + 2), minimum=256))


def encode_blocks(data, block_size: int, *, linked: bool = False, carry: bytes = b"",
                  device=None, verify: bool = True):
    """Compress ``data`` as frame blocks of ``block_size`` bytes.

    Returns (payloads: list[bytes], block_lens: list[int], window: bytes)
    in frame order; the frame layer wraps the payloads in BlockInfo words
    and checksums. ``carry`` is the linked-mode window context before
    ``data`` (the tail of blocks a streaming encoder already wrote); at most
    64 KiB of it is used, and ``window`` is the context after ``data``, for
    the next call (empty unless ``linked``).

    Blocks of ``_CHUNK_C`` bytes or more take the hybrid encoder, whose
    output is spec-valid by construction. Smaller blocks take the
    all-device encoder; with ``verify`` (the default) each payload goes
    through the native verify walk, and one that fails is replaced by the
    host encoder's bytes, counted in ``ops.encode.stats["verify_fallbacks"]``."""
    from ..ops import encode as E
    from ..ops.ringdecode import resolve_device

    dev = resolve_device(device)
    window = bytes(carry)[-WINDOW_SIZE:] if linked else b""
    buf = bytes(data)
    if block_size >= E._CHUNK_C:
        payloads, lens = [], []
        for pos in range(0, max(len(buf), 1), block_size):
            blk = buf[pos : pos + block_size]
            payloads.append(E.compress_block_hybrid(blk, ext_dict=window, device=dev))
            lens.append(len(blk))
            if linked:
                window = (window + blk)[-WINDOW_SIZE:]
        return payloads, lens, window

    staged = window + buf
    rows, dlen, tlen, nblocks = stage_blocks(staged, block_size, linked=linked, start=len(window))
    payloads = _encode_staged(rows, dlen, tlen, dev, encode_geometry(rows.shape[1], block_size))
    lens = [int(tlen[i] - dlen[i]) for i in range(nblocks)]
    if verify:
        for i in range(nblocks):
            d, n = int(dlen[i]), int(tlen[i])
            if not _native.verify_block(payloads[i], rows[i, d:n], rows[i, :d]):
                # a fingerprint collision overstated a match
                E.stats["verify_fallbacks"] += 1
                payloads[i] = compress_with_dict(rows[i, d:n], rows[i, :d])
    return payloads, lens, staged[-WINDOW_SIZE:] if linked else b""


def _decode_batch(rows, clen, *, out_pad, nseq_pad):
    """Decode independent blocks on ``rows``' device: (B, C) uint8 payload
    rows, each padded with at least one zero byte, and their (B,) lengths ->
    ((B, out_pad) uint8 outputs, (B,) int32 lengths, (B, 5) bool error
    flags), each row by ``ops.decode.decode_resident_core``."""
    from ..ops.decode import decode_resident_core
    from ..ops.parse import default_parse_engine

    outs, totals, errs = [], [], []
    for row, n in zip(rows, clen):
        out, total, err = decode_resident_core(
            row, n, out_pad=out_pad, nseq_pad=nseq_pad,
            parse_engine=default_parse_engine(),
        )
        outs.append(out)
        totals.append(total)
        errs.append(err)
    if not outs:
        dev = rows.device
        return (torch.zeros((0, out_pad), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((0, 5), dtype=torch.bool, device=dev))
    return torch.stack(outs), torch.stack(totals), torch.stack(errs)
