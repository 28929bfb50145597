"""Frame blocks through the device codec on one card.

The one-card counterpart of the JAX package's
``parallel/pipeline.py:encode_blocks_sharded``: on a one-device mesh that
function sends chunk-scale blocks (at least ``_CHUNK_C`` bytes, so 1, 4 and
8 MiB frame blocks) through the hybrid encoder one block at a time, with a
linked block's dictionary the 64 KiB of input before it. Smaller blocks take
the all-device encode there, which is not ported yet (ROADMAP item 6), so
they raise here rather than come out as other bytes.

The batched device-resident decode (``_decode_batch``, under
``LZ4Codec.decode_step``) is the one-device case of the JAX package's
``_decode_batch``: its ``vmap`` over rows becomes rows decoded one after
another, since the engines' loops end where each row's data says.
"""

from __future__ import annotations

from ..spec.constants import WINDOW_SIZE


def check_block_size(block_size: int) -> None:
    """Raise NotImplementedError for blocks the one-card route cannot encode
    as the JAX package does."""
    from ..ops.encode import _CHUNK_C

    if block_size < _CHUNK_C:
        raise NotImplementedError(
            f"device encode of {block_size}-byte blocks needs the all-device encoder "
            f"(ROADMAP item 6), which is not ported yet; blocks of at least {_CHUNK_C} "
            "bytes (1, 4 and 8 MiB) encode through the hybrid encoder"
        )


def encode_blocks(data, block_size: int, *, linked: bool = False, carry: bytes = b"",
                  device=None):
    """Compress ``data`` as frame blocks of ``block_size`` bytes.

    Returns (payloads: list[bytes], block_lens: list[int], window: bytes)
    in frame order; the frame layer wraps the payloads in BlockInfo words
    and checksums. ``carry`` is the linked-mode window context before
    ``data`` (the tail of blocks a streaming encoder already wrote); at most
    64 KiB of it is used, and ``window`` is the context after ``data``, for
    the next call (empty unless ``linked``). The hybrid encoder's output is
    spec-valid by construction (every candidate is re-extended with exact
    byte compares), so no verify pass runs."""
    from ..ops.encode import compress_block_hybrid

    check_block_size(block_size)
    window = bytes(carry)[-WINDOW_SIZE:] if linked else b""
    buf = bytes(data)
    payloads, lens = [], []
    for pos in range(0, max(len(buf), 1), block_size):
        blk = buf[pos : pos + block_size]
        payloads.append(compress_block_hybrid(blk, ext_dict=window, device=device))
        lens.append(len(blk))
        if linked:
            window = ((window + blk) if len(blk) < WINDOW_SIZE else blk)[-WINDOW_SIZE:]
    return payloads, lens, window


def _decode_batch(rows, clen, *, out_pad, nseq_pad):
    """Decode independent blocks on ``rows``' device: (B, C) uint8 payload
    rows, each padded with at least one zero byte, and their (B,) lengths ->
    ((B, out_pad) uint8 outputs, (B,) int32 lengths, (B, 5) bool error
    flags), each row by ``ops.decode.decode_resident_core``."""
    import torch

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
