"""Device block decode: the ring engine and the sequence-expansion engines.

``parse="ring"`` (the default): the native size walk measures the block
(raising the structural errors of the checked-decode error set, lz4_flex
src/block/mod.rs:82-98), the native planner turns it into a ring plan while
it checks every match offset against the output so far, and the ring kernel
(ops/ringdecode.py) decodes the plan on the card. A block whose plan
overflows its static shape decodes on the same device through the expansion
engine below, counted in ``ringdecode.stats["overflow_fused_decodes"]``.

The expansion engines (the JAX package's ``jnp`` programs, here torch ops on
the caller's device, bit-equal to them) invert the reference's sequential
token walk (src/block/decompress.rs:201-444) into vectorized stages over the
whole output:

  1. attribution: each sequence's deltas are scattered at its output offset
     and summed forward, giving every output byte its source in O(n);
  2. source resolution: a literal byte's source lies in the compressed
     stream, a match byte's at an earlier *output* position; match chains
     (matches of matches, and self-overlapping RLE runs) collapse by pointer
     doubling, s <- s[s], chains of depth 2^r after r rounds;
  3. materialization: one byte gather from the compressed stream (and the
     dictionary, when present).

``expand_core`` is v1 (per-byte doubling); ``ops/expand2.py:expand2_core``
is v2 (fragment cells, the default). ``parse="host"`` feeds them the native
parser's sequence table, ``parse="device"`` the on-device parse of
ops/parse.py; ``decode_resident_core`` fuses the device parse and an
expansion with input and output on the device, and ``decode_resident_rows``
does so for a batch of blocks as rows in one batched program: on the card
one launch of the hand-written kernel ``csrc/resident_decode.cu``, which
walks each row's tokens, and on the CPU those torch ops
(``decode_resident_rows_reference``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import native as _native
from ..block import errors as block_errors
from . import packing
from .ringdecode import decode_block_ring, decode_parts_ring, resolve_device, stats
from .sequences import SeqTable, parse_sequences_host

_MAX_DOUBLING_ROUNDS = 40  # chains deeper than 2^40 bytes cannot exist


def expand_core(
    comp_words: torch.Tensor,  # (COMP_PAD/4,) int32 words of the compressed bytes
    dict_words: torch.Tensor,  # (DICT_PAD/4,) int32 words of the dictionary
    seq_oo: torch.Tensor,  # (NSEQ_PAD,) int32 output offset per sequence
    seq_ls: torch.Tensor,  # (NSEQ_PAD,) int32 literal start (compressed pos)
    seq_ll: torch.Tensor,  # (NSEQ_PAD,) int32 literal length
    seq_mo: torch.Tensor,  # (NSEQ_PAD,) int32 match offset
    dict_len,  # int or () int32 tensor
    total_out,  # int or () int32 tensor
    *,
    out_pad: int,
    has_dict: bool,
) -> torch.Tensor:
    """The v1 expansion: (out_pad,) uint8 on the tables' device; see the
    module docstring for the three stages. A batch of blocks as rows, (B,
    ...) tensors and (B,) counts, gives (B, out_pad), each row as it would
    be alone."""
    if seq_oo.dim() == 1:
        return expand_core(comp_words[None], dict_words[None], seq_oo[None], seq_ls[None],
                           seq_ll[None], seq_mo[None], dict_len, total_out,
                           out_pad=out_pad, has_dict=has_dict)[0]
    dev = seq_oo.device
    comp_pad = comp_words.shape[1] * 4
    pout = torch.arange(out_pad, dtype=torch.int32, device=dev)

    # Stages 1+2 fused: the per-byte source map is piecewise affine in the
    # output position: on a literal segment s(p) = -(p + C_i + 1) with
    # C_i = lit_start_i - out_off_i, on a match segment s(p) = p - off_i.
    # So one piecewise-constant value array V (C_i on literal segments,
    # off_i on match segments) and one segment flag F rebuild s from two
    # sparse scatter-adds of per-sequence deltas and two cumulative sums.
    off_i = seq_mo.clamp(min=1)  # sanitized: offset 0 would never resolve
    c_i = seq_ls - seq_oo
    prev_off = torch.cat([off_i.new_zeros(off_i.shape[0], 1), off_i[:, :-1]], 1)
    lit_starts = seq_oo  # padding seqs carry out_off == out_pad -> dropped
    match_starts = (seq_oo + seq_ll).clamp(0, out_pad)
    zeros = torch.zeros((seq_oo.shape[0], out_pad), dtype=torch.int32, device=dev)

    V = packing.scatter_drop(zeros, lit_starts, c_i - prev_off, "add")
    V = packing.scatter_drop(V, match_starts, off_i - c_i, "add")
    V = packing.tiled_cumsum(V)

    F = packing.scatter_drop(zeros, lit_starts, 1, "add")
    F = packing.scatter_drop(F, match_starts, -1, "add")
    F = packing.tiled_cumsum(F)

    is_lit = F > 0
    lit_k = pout + V  # = lit_start + (p - out_off)
    msrc = pout - V  # = p - offset
    dict_k = comp_pad + (packing.per_row(dict_len) + msrc).clamp(
        0, dict_words.shape[1] * 4 - 1)
    s = torch.where(is_lit, -(lit_k + 1), torch.where(msrc >= 0, msrc, -(dict_k + 1)))
    s = torch.where(pout < packing.per_row(total_out), s, -1)

    # Pointer doubling: two dense rounds collapse chains of depth <= 4, then
    # each row's surviving positions (typically a few percent) are compacted
    # into a small workset and chased there, or, if its workset overflows,
    # over its whole map (the JAX package's lax.cond, per row under vmap).
    # The loops run while any row is live, one device scalar a round; a row
    # whose loop has ended is left as it stands.
    def dense_round(s):
        g = torch.gather(s, 1, s.clamp(0, out_pad - 1).long())
        return torch.where(s >= 0, g, s)

    s = dense_round(dense_round(s))

    un_pad = max(4096, out_pad // 8)
    mask = s >= 0
    cnt = mask.sum(1)
    rank = packing.tiled_cumsum(mask.to(torch.int32)) - 1
    # Sentinel entries point at position 0 (always resolved: position 0 has
    # no earlier output to copy from); their write-back is a no-op.
    uidx = packing.scatter_drop(
        torch.zeros((s.shape[0], un_pad), dtype=torch.int32, device=dev),
        torch.where(mask, rank, un_pad), pout).long()

    started = mask.any(1)
    live, i = started & (cnt <= un_pad), 0
    while i < _MAX_DOUBLING_ROUNDS and packing.host_read(bool, live.any()):
        su = torch.gather(s, 1, uidx)
        g = torch.gather(s, 1, su.clamp(0, out_pad - 1).long())
        new = torch.where(live[:, None] & (su >= 0), g, su)
        s = s.scatter(1, uidx, new)
        live, i = live & (new >= 0).any(1), i + 1
    live, i = started & (cnt > un_pad), 0
    while i < _MAX_DOUBLING_ROUNDS and packing.host_read(bool, live.any()):
        s = torch.where(live[:, None], dense_round(s), s)
        live, i = live & (s >= 0).any(1), i + 1

    # Stage 3: materialize bytes from the resolved sources.
    k = -s - 1
    out = packing.gather_bytes(comp_words, k)
    if has_dict:
        out = torch.where(k < comp_pad, out, packing.gather_bytes(dict_words, k - comp_pad))
    return out.to(torch.uint8)


def default_expand_engine() -> str:
    """Expansion engine: "v2" (fragment cells, ops/expand2.py) or "v1"
    (per-byte doubling, :func:`expand_core`). Override with TLZ4_EXPAND=v1."""
    return os.environ.get("TLZ4_EXPAND", "v2")


def _expand_fn(engine: str | None):
    if engine is None:
        engine = default_expand_engine()
    if engine == "v2":
        from .expand2 import expand2_core

        return expand2_core
    if engine == "v1":
        return expand_core
    raise ValueError(f"unknown expand engine {engine!r}")


def decode_resident_core(
    u8,
    clen,
    *,
    out_pad,
    nseq_pad,
    parse_engine="doubling",
    capacity=None,
    expand_engine=None,
):
    """Device-resident decode of one independent block: the on-device parse
    and an expansion, with input and output on ``u8``'s device (compressed
    bytes feed a device pipeline without a trip to the host). ``u8`` is the
    payload padded with at least one zero byte, ``clen`` its length (int or
    () tensor). Returns (out (out_pad,) uint8, total_out, error_flags):
    :func:`decode_resident_rows` on a batch of one (on the card, one launch
    of the resident kernel); ``parse_engine="walk"`` runs the token-walk
    parse's torch ops instead.

    error_flags is a (5,) bool tensor: [literal_oob, truncated, offset_zero,
    offset_oob, output_too_small], the checked-decode error set of lz4_flex
    src/block/mod.rs:82-98 plus the capacity check."""
    from .parse import parse_walk_core, row_lengths

    if parse_engine == "walk":
        tables = [t[None] for t in parse_walk_core(u8, clen, nseq_pad=nseq_pad)]
        out = _expand_parsed(u8[None], tables, out_pad=out_pad, capacity=capacity,
                             expand_engine=expand_engine)
    else:
        out = decode_resident_rows(u8[None], row_lengths(clen, 1, u8.device), out_pad=out_pad,
                                   nseq_pad=nseq_pad, capacity=capacity,
                                   expand_engine=expand_engine)
    return tuple(t[0] for t in out)


def decode_resident_rows(u8, clen, *, out_pad, nseq_pad, capacity=None, expand_engine=None):
    """:func:`decode_resident_core` over a batch of independent blocks, the
    JAX package's ``vmap`` of it with the doubling parse: ``u8`` (B, pad)
    payload rows, each padded with at least one zero byte, ``clen`` their
    (B,) lengths -> ((B, out_pad) uint8 outputs, (B,) int32 lengths, (B, 5)
    bool flags); row b's results, malformed or not, are those of row b
    decoded alone.

    On CUDA tensors this is one launch of the resident kernel
    (:func:`resident_decode_kernel`), whatever the expansion engine: it
    returns what the v2 expansion returns, and the engines differ only in
    the bytes past each row's total. CPU tensors take the torch ops of
    :func:`decode_resident_rows_reference`, the only place where
    ``expand_engine`` (default :func:`default_expand_engine`) picks one."""
    from .parse import row_lengths

    n = row_lengths(clen, u8.shape[0], u8.device)
    if u8.device.type == "cuda":
        _expand_fn(expand_engine)  # an unknown engine raises here as on the CPU
        return resident_decode_kernel(u8, n, out_pad=out_pad, nseq_pad=nseq_pad,
                                      capacity=capacity)
    return decode_resident_rows_reference(u8, n, out_pad=out_pad, nseq_pad=nseq_pad,
                                          capacity=capacity, expand_engine=expand_engine)


def decode_resident_rows_reference(u8, clen, *, out_pad, nseq_pad, capacity=None,
                                   expand_engine=None):
    """The plain version of :func:`decode_resident_rows`, torch ops on the
    rows' device: one batched parse (``parse.parse_rows``) and one batched
    expansion, whose loops read a device scalar a round."""
    from .parse import parse_rows, row_lengths

    tables = parse_rows(u8, row_lengths(clen, u8.shape[0], u8.device), nseq_pad=nseq_pad)
    return _expand_parsed(u8, tables, out_pad=out_pad, capacity=capacity,
                          expand_engine=expand_engine)


def resident_decode_kernel(u8, clen, *, out_pad, nseq_pad, capacity=None):
    """The resident decode as one launch of the kernel
    ``csrc/resident_decode.cu`` on the current stream: ``u8`` (B, width)
    uint8 CUDA rows (each row contiguous, any row stride), ``clen`` their
    (B,) int32 lengths on the same card. Returns what
    :func:`decode_resident_rows_reference` returns, byte for byte, in tensors
    made with ``torch.empty`` that the kernel fills; no host read. Raises
    ValueError on tensors or sizes the kernel does not take."""
    if u8.dtype != torch.uint8 or u8.dim() != 2:
        raise ValueError(f"rows must be a 2-D uint8 tensor, got {u8.dtype} {tuple(u8.shape)}")
    B, width = u8.shape
    if clen.dtype != torch.int32 or tuple(clen.shape) != (B,):
        raise ValueError(f"lengths must be int32 ({B},), got {clen.dtype} {tuple(clen.shape)}")
    if (width > 1 and u8.stride(1) != 1) or not clen.is_contiguous():
        raise ValueError("each row and the lengths must be contiguous")
    if not 0 < width < 2**31:
        raise ValueError(f"row width must be in [1, 2**31), got {width}")
    if not 0 < out_pad < 2**31 or out_pad % 16 or not 0 < nseq_pad < 2**31:
        raise ValueError(f"out_pad must be a positive multiple of 16 and nseq_pad positive "
                         f"(both under 2**31), got {out_pad} and {nseq_pad}")
    if u8.device.type != "cuda" or clen.device != u8.device:
        raise ValueError(f"the resident kernel takes rows and lengths on one CUDA card, got "
                         f"{u8.device} and {clen.device} (CPU tensors take "
                         "decode_resident_rows_reference)")
    cap = out_pad if capacity is None else max(-(2**31), min(int(capacity), 2**31 - 1))
    out = torch.empty((B, out_pad), dtype=torch.uint8, device=u8.device)
    total = torch.empty(B, dtype=torch.int32, device=u8.device)
    flags = torch.empty((B, 5), dtype=torch.bool, device=u8.device)
    if B:
        from ._kernels import launch_resident_decode

        with torch.cuda.device(u8.device):
            launch_resident_decode(u8, clen, out, total, flags, nseq_pad=nseq_pad, capacity=cap,
                                   stream=torch.cuda.current_stream().cuda_stream)
        stats["resident_launches"] += 1
        stats["resident_rows"] += B
    return out, total, flags


def _expand_parsed(u8, tables, *, out_pad, capacity, expand_engine):
    """The checks and the expansion of the resident decode, on (B, ...)
    parse tables of the (B, pad) payload rows ``u8``."""
    ls, ll, mo, ml, oo, nseq, total, errs = tables
    nseq_pad = ls.shape[1]
    real = torch.arange(nseq_pad, dtype=torch.int32, device=u8.device) < nseq[:, None]
    # Checked-decode bounds the parse flags cannot see: a match reaching
    # before the block start (no dict in the resident path) and an output
    # beyond the static capacity.
    off_oob = (real & (ml > 0) & (oo + ll - mo < 0)).any(1)
    out_oob = total > (out_pad if capacity is None else capacity)
    errs = torch.cat([errs, torch.stack([off_oob, out_oob], 1)], 1)
    oo = torch.where(real, oo, out_pad)
    mo = torch.where(real, mo, 1)
    out = _expand_fn(expand_engine)(
        packing.bytes_to_words(u8),
        torch.zeros((u8.shape[0], 1), dtype=torch.int32, device=u8.device),
        oo, ls, ll, mo, 0, total, out_pad=out_pad, has_dict=False,
    )
    return out, total, errs


#: The JAX package's name for the compiled form of the core; torch runs the
#: same ops eagerly.
decode_resident = decode_resident_core


def _pack_host(buf: np.ndarray, pad: int) -> np.ndarray:
    """Pad a host uint8 buffer to ``pad`` bytes and view it as int32 words."""
    out = np.zeros(pad, dtype=np.uint8)
    out[: buf.shape[0]] = buf
    return out.view("<i4")


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def expand_on_device(
    comp: np.ndarray,
    seq: SeqTable,
    ext_dict: np.ndarray,
    engine: str | None = None,
    *,
    device=None,
) -> torch.Tensor:
    """Run an expansion engine for a host-parsed block; returns the uint8
    tensor of ``seq.total_out`` bytes on ``device`` (a slice of the padded
    output). ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    expand = _expand_fn(engine)
    comp_pad = packing.size_bucket(max(comp.shape[0], 4))
    out_pad = packing.size_bucket(max(seq.total_out, 4))
    nseq_pad = packing.size_bucket(max(seq.nseq, 4), minimum=256)
    has_dict = ext_dict.shape[0] > 0
    pad_dict = packing.size_bucket(ext_dict.shape[0]) if has_dict else 4
    out = expand(
        _upload(_pack_host(comp, comp_pad), dev),
        _upload(_pack_host(ext_dict, pad_dict), dev),
        _upload(packing.pad_to(seq.out_off, nseq_pad, fill=out_pad), dev),
        _upload(packing.pad_to(seq.lit_start, nseq_pad), dev),
        _upload(packing.pad_to(seq.lit_len, nseq_pad), dev),
        _upload(packing.pad_to(seq.match_off, nseq_pad, fill=1), dev),
        int(ext_dict.shape[0]),
        int(seq.total_out),
        out_pad=out_pad,
        has_dict=has_dict,
    )
    return out[: seq.total_out]


def _validate(seq: SeqTable, dict_len: int, capacity: int) -> None:
    """Checked-decode validation of a host-parsed sequence table (the error
    set of lz4_flex src/block/mod.rs:82-98)."""
    if seq.total_out > capacity:
        raise block_errors.OutputTooSmall(seq.total_out, capacity)
    if seq.nseq == 0:
        return
    match_start = (
        seq.out_off.astype(np.int64) + seq.lit_len.astype(np.int64) - seq.match_off.astype(np.int64)
    )
    if ((seq.match_len > 0) & (match_start < -int(dict_len))).any():
        raise block_errors.OffsetOutOfBounds()


def _result(out: torch.Tensor, as_array: bool):
    return out if as_array else out.cpu().numpy().tobytes()


def decode_parts_fused(
    parts,
    *,
    as_array: bool = False,
    independent: bool = False,
    max_block_size: int | None = None,
    device=None,
    engine: str | None = None,
):
    """Decode a whole multi-block frame body in ONE device expansion.

    ``parts`` is the frame's block list in order: (payload, is_compressed)
    pairs (stored blocks pass through as literals). The blocks' sequence
    tables merge into one global table: output offsets shifted by each
    block's base, literal starts by each payload's position in the
    concatenated compressed buffer. A linked-mode window reference
    (src/frame/decompress.rs:282-292) is then a plain output position, and
    the pointer doubling resolves the whole body's dependencies at once.
    Stored blocks become literal-only pseudo-sequences.

    ``independent`` validates each block's matches against its own output
    only (the reference decodes independent blocks with no dictionary,
    src/frame/decompress.rs:294-306: a cross-block back-reference raises
    OffsetOutOfBounds). ``max_block_size`` caps every block's decompressed
    size. Returns bytes, or a uint8 tensor on ``device`` with ``as_array``;
    ``device=None`` means the CUDA card.
    """
    dev = resolve_device(device)
    bufs, tables = [], []
    cbase = obase = 0
    for payload, is_comp in parts:
        p = _native.as_u8(payload)
        if is_comp:
            seq = parse_sequences_host(p)
            if independent:
                # Block-local bounds: matches must stay inside this block.
                _validate(seq, 0, max_block_size or seq.total_out)
            elif max_block_size is not None and seq.total_out > max_block_size:
                raise block_errors.OutputTooSmall(seq.total_out, max_block_size)
            tables.append((seq.lit_start + cbase, seq.lit_len, seq.match_off, seq.match_len,
                           seq.out_off + obase))
            out_len = seq.total_out
        else:
            tables.append(tuple(np.array([v], np.int32) for v in (cbase, p.shape[0], 0, 0, obase)))
            out_len = p.shape[0]
        bufs.append(p)
        cbase += p.shape[0]
        obase += out_len
    if not bufs:
        return _result(torch.empty(0, dtype=torch.uint8, device=dev), as_array)
    comp = np.concatenate(bufs) if len(bufs) > 1 else bufs[0]
    merged = SeqTable(*(np.concatenate([t[i] for t in tables]) for i in range(5)), obase)
    _validate(merged, 0, obase)
    out = expand_on_device(comp, merged, np.empty(0, np.uint8), engine, device=dev)
    return _result(out, as_array)


def decode_block_device(
    data,
    max_output_size: int,
    ext_dict=b"",
    *,
    parse: str = "ring",
    device=None,
    as_array: bool = False,
    engine: str | None = None,
):
    """Decompress one raw LZ4 block on the device.

    ``parse`` selects the engine: "ring" (the default: host plan and the
    ring kernel; a dictionary rides as a stored pseudo-block of its last
    64 KiB, resolved through the kernel's linked window and sliced off; a
    block whose plan overflows its static shape takes the expansion engine
    on the same device), "host" (the native parser's sequence table feeding
    an expansion engine) or "device" (the on-device parse, ops/parse.py,
    feeding it). ``engine`` picks the expansion engine, "v1" or "v2"
    (default :func:`default_expand_engine`). ``device=None`` means the CUDA
    card; ``device="cpu"`` runs the kernel's and the engines' plain PyTorch
    versions.

    Returns bytes, or a uint8 tensor on ``device`` when ``as_array`` is true.
    Raises the block error taxonomy on malformed input.
    """
    if parse not in ("ring", "host", "device"):
        raise ValueError(f"unknown parse engine {parse!r}")
    dev = resolve_device(device)
    comp = _native.as_u8(data)
    dic = _native.as_u8(ext_dict)
    if parse == "ring":
        if dic.shape[0]:
            # Only the dict's last 64 KiB is reachable (LZ4 offsets cap at 65535).
            dtail = dic[-65536:]
            parts = [(dtail, False), (comp, True)]
            out = decode_parts_ring(parts, independent=False, max_block_size=max_output_size,
                                    device=dev, as_array=as_array)
            if out is None:
                stats["overflow_fused_decodes"] += 1
                out = decode_parts_fused(parts, max_block_size=max_output_size, device=dev,
                                         as_array=as_array, engine=engine)
            return out[dtail.shape[0]:]
        total = _native.measure_block(comp)
        if total > max_output_size:
            raise block_errors.OutputTooSmall(total, max_output_size)
        out = decode_block_ring(comp, total, device=dev, as_array=as_array)
        if out is not None:
            return out
        stats["overflow_fused_decodes"] += 1
        parse = "host"
    if parse == "device":
        from .parse import parse_sequences_device

        seq = parse_sequences_device(comp, device=dev)
    else:
        seq = parse_sequences_host(comp)
    _validate(seq, dic.shape[0], max_output_size)
    return _result(expand_on_device(comp, seq, dic, engine, device=dev), as_array)
