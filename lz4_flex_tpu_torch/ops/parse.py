"""On-device speculative token parse (the JAX package's ``ops/parse.py`` as
torch ops, bit-equal to it).

The LZ4 token stream is a linked list: each sequence header says where the
next one starts (lz4_flex walks it with a cursor,
src/block/decompress.rs:244-340). To parse without a sequential walk, the
program *speculatively* decodes a sequence header at EVERY byte position,
yielding a successor pointer ``next[p]`` per position. The real sequence
boundaries are the orbit of position 0 in that functional graph, found by
pointer-doubling reachability: after r rounds of (M |= scatter of M
through J; J <- J[J]), M marks every position reachable from 0 in fewer
than 2^r hops.

Output offsets then follow from a masked prefix sum of the speculative
output increments, and the sequence table is compacted with a rank
scatter. Malformed-stream conditions (literal overrun, truncation, offset
0: the checked-decode error set of src/block/mod.rs:82-98) are evaluated
per position and reported only where they lie on the real chain.

Three engines: ``parse_core`` (doubling, the default), ``parse_walk_core``
(one sequential step per sequence) and ``parse_strided_core`` (lanes walk
segments in lockstep). The walks' loops, whose trip count the data
decides, are Python loops over masked steps that read one device scalar
every ``_CHECK_EVERY`` steps; the doubling engine's round count follows
from the shape and reads none. ``parse_rows`` is the doubling engine over
a batch of payload rows (the JAX package's ``vmap`` of ``parse_core``);
``parse_core`` is its one-row view.
"""

from __future__ import annotations

import torch

from .. import native as _native
from ..block import errors as block_errors
from . import packing
from .ringdecode import resolve_device
from .sequences import SeqTable

# A masked walk step leaves its state unchanged once the walk has ended, so
# the loops read their end condition only this often.
_CHECK_EVERY = 32


def _speculative_tables(u8: torch.Tensor, n):
    """Decode a sequence header at EVERY byte position (vectorized), along
    the last dim: ``u8`` is one payload (pad,) with its length ``n``, or a
    batch (B, pad) with (B, 1) lengths.

    Returns per-position int32/bool tensors: (nxt, lit_start, lit_len,
    offset, match_len, out_inc, is_final, flag_lit_oob, flag_truncated,
    flag_offset_zero, flag_terminated). Flags describe what holds IF a real
    sequence starts at that position."""
    pad = u8.shape[-1]
    pos = torch.arange(pad, dtype=torch.int32, device=u8.device)
    u = u8.to(torch.int32)
    lsic_val, lsic_nb = packing.lsic_tables(u8)

    def at(arr, idx):
        return torch.gather(arr, -1, idx.clamp(0, pad - 1).long().expand(arr.shape))

    lln = u >> 4
    mln = u & 15
    ll_ext = lln == 15
    ll = lln + torch.where(ll_ext, at(lsic_val, pos + 1), 0)
    lit_hdr = 1 + torch.where(ll_ext, at(lsic_nb, pos + 1), 0)
    lit_start = pos + lit_hdr
    off_pos = lit_start + ll
    is_final = off_pos >= n

    offset = at(u, off_pos) | (at(u, off_pos + 1) << 8)
    ml_ext = mln == 15
    ml = 4 + mln + torch.where(ml_ext, at(lsic_val, off_pos + 2), 0)
    ml_hdr = 2 + torch.where(ml_ext, at(lsic_nb, off_pos + 2), 0)
    nxt = off_pos + ml_hdr

    offset = torch.where(is_final, 0, offset)
    ml = torch.where(is_final, 0, ml)
    nxt = torch.where(is_final, n, nxt)
    out_inc = ll + ml

    # A literal-length LSIC field running off the end is truncation (host
    # parser semantics) even though the bogus decoded length also makes the
    # position look like an overlong final sequence.
    f_lsic_trunc = ll_ext & (pos + 1 + at(lsic_nb, pos + 1) > n)
    f_lit_oob = is_final & (off_pos > n) & ~f_lsic_trunc
    f_terminated = is_final & (off_pos == n) & ~f_lsic_trunc
    f_offset_zero = ~is_final & (offset == 0)
    f_truncated = f_lsic_trunc | (~is_final & ((off_pos + 2 > n) | (nxt > n)))
    return (
        nxt, lit_start, ll, offset, ml, out_inc,
        is_final, f_lit_oob, f_truncated, f_offset_zero, f_terminated,
    )


def _flag_bits(f_lit_oob, f_truncated, f_offset_zero, f_terminated, is_final):
    """The five per-position flags packed as bits 0-4 of one int32."""
    return (f_lit_oob.to(torch.int32) | (f_truncated.to(torch.int32) << 1)
            | (f_offset_zero.to(torch.int32) << 2) | (f_terminated.to(torch.int32) << 3)
            | (is_final.to(torch.int32) << 4))


def row_lengths(n, rows: int, device) -> torch.Tensor:
    """A length (int or () tensor) or a batch of them as a (rows,) int32
    tensor on ``device``."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32).reshape(rows)
    return torch.full((rows,), n, dtype=torch.int32, device=device)


def parse_rows(u8: torch.Tensor, n: torch.Tensor, *, nseq_pad: int):
    """The speculative parse by pointer-doubling reachability over a batch:
    ``u8`` (B, pad) payload rows, each padded with at least one zero byte,
    ``n`` their (B,) int32 lengths. Returns (lit_start, lit_len, match_off,
    match_len, out_off, nseq, total_out, error_flags): (B, nseq_pad) int32
    sequence tables, (B,) int32 counts and (B, 3) bool flags [literal_oob,
    truncated, offset_zero]. Row b's results are those of ``parse_core`` on
    row b alone: every index stays inside its own row."""
    B, pad = u8.shape
    dev = u8.device
    pos = torch.arange(pad, dtype=torch.int32, device=dev)
    nb = n[:, None]
    (
        nxt, lit_start, ll, offset, ml, out_inc,
        is_final, f_lit_oob, f_truncated, f_offset_zero, f_terminated,
    ) = _speculative_tables(u8, nb)

    # --- chain reachability by pointer doubling ---------------------------
    # Slot `pad` of each row is its terminal sentinel; position n (the end
    # of the stream) maps into the pad region whose successor is the
    # sentinel. Successors are clamped into the row, so the doubling's
    # gathers and stores along dim 1 never leave it.
    sent = pad
    J = torch.where(pos < nb, nxt.clamp(0, sent), sent)
    J = torch.cat([J, J.new_full((B, 1), sent)], 1).long()
    M = torch.zeros((B, pad + 2), dtype=torch.int32, device=dev)  # slot pad+1: a sink
    M[:, 0] = 1
    for _ in range(max(1, (pad + 1).bit_length())):
        # M.at[J].max(M) of the JAX package: M is 0/1, so it sets 1 at J[i]
        # wherever M[i] is 1, as plain stores of one value (an atomic max
        # contends on the sentinel slot that most walks reach).
        tgt = torch.where(M[:, : pad + 1] == 1, J, pad + 1)
        M.scatter_(1, tgt, 1)
        M[:, pad + 1] = 0
        J = torch.gather(J, 1, J)
    on_chain = (M[:, :pad] == 1) & (pos < nb)

    # --- output offsets: masked exclusive prefix sum ----------------------
    inc = torch.where(on_chain, out_inc, 0)
    cum = packing.tiled_cumsum(inc)
    out_off = cum - inc
    total_out = cum[:, pad - 1]

    # --- error taxonomy (only chain positions count) ----------------------
    # "Never terminated" counts as truncation only when no specific error
    # explains it (error-type parity with the host parser).
    err_lit_oob = (on_chain & f_lit_oob).any(1)
    terminated = (on_chain & f_terminated).any(1)
    err_offset_zero = (on_chain & f_offset_zero).any(1)
    err_truncated = ((on_chain & f_truncated).any(1)
                     | (~terminated & ~err_lit_oob & ~err_offset_zero))

    # --- compaction to a fixed-width sequence table -----------------------
    rank = packing.tiled_cumsum(on_chain.to(torch.int32)) - 1
    nseq = rank[:, pad - 1] + 1
    tgt = torch.where(on_chain, rank, nseq_pad)  # dropped when not on chain

    def compact(field, fill):
        return packing.scatter_drop(
            torch.full((B, nseq_pad), fill, dtype=torch.int32, device=dev), tgt, field)

    return (
        compact(lit_start, 0),
        compact(ll, 0),
        compact(offset, 1),
        compact(ml, 0),
        compact(out_off, 0),
        nseq,
        total_out,
        torch.stack([err_lit_oob, err_truncated, err_offset_zero], 1),
    )


def parse_core(u8: torch.Tensor, n, *, nseq_pad: int):
    """The speculative parse of one payload: :func:`parse_rows` on a batch
    of one. ``u8`` is the payload padded with at least one zero byte, ``n``
    its length (int or () tensor). Returns (lit_start, lit_len, match_off,
    match_len, out_off, nseq, total_out, error_flags): nseq_pad-padded int32
    sequence tensors, () int32 counts and (3,) bool flags [literal_oob,
    truncated, offset_zero]."""
    out = parse_rows(u8[None], row_lengths(n, 1, u8.device), nseq_pad=nseq_pad)
    return tuple(t[0] for t in out)


def parse_walk_core(u8: torch.Tensor, n, *, nseq_pad: int):
    """Token-walk parse: the speculative per-position tables are computed
    vectorized, then the real chain is walked one sequence per step. Same
    interface as :func:`parse_core`.

    Each step is a masked update of a few device scalars (a stopped walk
    changes nothing), so the end condition is read every ``_CHECK_EVERY``
    steps: O(nseq) small launches, for small blocks; the doubling engine is
    the default."""
    (
        nxt, lit_start, ll, offset, ml, out_inc,
        is_final, f_lit_oob, f_truncated, f_offset_zero, f_terminated,
    ) = _speculative_tables(u8, n)
    # One packed row per position so each walk step is a single row read.
    tbl = torch.stack(
        [nxt, lit_start, ll, offset, ml,
         _flag_bits(f_lit_oob, f_truncated, f_offset_zero, f_terminated, is_final)], dim=1)
    pad = u8.shape[0]
    dev = u8.device
    n_t = torch.as_tensor(n, dtype=torch.int32, device=dev)
    # Records at slot nseq_pad are a sink for the steps of a stopped walk.
    rec = torch.zeros((5, nseq_pad + 1), dtype=torch.int32, device=dev)
    rec[2] = 1  # match_off fill
    # state: ip, opos, i, err, done
    st = torch.zeros(5, dtype=torch.int32, device=dev)
    step = 0
    while True:
        if step % _CHECK_EVERY == 0 and not packing.host_read(bool, (st[2] < nseq_pad) & (st[0] < n_t)):
            break
        step += 1
        ip, opos, i, err, done = st
        act = (i < nseq_pad) & (ip < n_t)
        row = tbl[ip.clamp(0, pad - 1)]
        slot = torch.where(act, i, nseq_pad).long()
        rec[:, slot] = torch.stack([row[1], row[2], row[3], row[4], opos])
        flags = row[5]
        bad = (flags & 0b111) != 0
        new = torch.stack([
            torch.where(bad, n_t, row[0]),
            opos + row[2] + row[4],
            i + 1,
            err | (flags & 0b111),
            done | ((flags >> 3) & 1),
        ])
        st = torch.where(act, new, st)
    ip, opos, i, err, done = st
    # "Never terminated" counts as truncation only when no specific error
    # explains the stop (parity with the doubling engine / host parser).
    other = (err & 0b101) != 0
    errs = torch.stack([
        (err & 1) == 1,
        (((err >> 1) & 1) == 1) | ((done == 0) & ~other),
        ((err >> 2) & 1) == 1,
    ])
    LS, LL, MO, ML, OO = rec[:, :nseq_pad]
    return LS, LL, MO, ML, OO, i, opos, errs


def parse_strided_core(u8: torch.Tensor, n, *, lanes: int):
    """Strided speculative walk: the whole-buffer parse without O(n) rounds
    or a single serial cursor.

    The buffer is cut into ``lanes`` equal segments. Every lane walks the
    speculative successor graph (:func:`_speculative_tables`) in lockstep, a
    vectorized step over lanes in which a finished lane stands still. Three
    passes:

      A. from the raw segment boundaries (almost certainly mid-token) to the
         first position past the next boundary: LZ4 token streams
         self-synchronize, so each exit is very likely the true chain's
         entry into the next segment;
      B. from the pass-A exits, re-walk and check the fixpoint
         exit[i] == entry[i+1]. Lane 0 starts at 0, always a true token
         start, so by induction the fixpoint proves every lane walked the
         true chain (the reference walks it with one cursor,
         src/block/decompress.rs:244-340). Up to 8 retries from improved
         entries handle slow synchronization; streams that never stabilize
         set the `unconverged` flag (the caller falls back to doubling);
      C. a record walk from the validated entries, writing each lane's
         sequences into its own row of (lanes, L) tables at globally correct
         output offsets (bases from an exclusive scan of per-lane totals).
         L = segment//3 + 2 bounds a lane's sequence count (a sequence takes
         >= 3 bytes).

    Returns per-lane tables (LS, LL, MO, ML, OO): (lanes, L) int32, plus
    nseq_i (lanes,), nseq, total_out, error flags (3,) and the unconverged
    flag. Padding entries carry the expansion-safe fills; callers mask with
    li < nseq_i."""
    pad = u8.shape[0]
    dev = u8.device
    (
        nxt, lit_start, ll, offset, ml, out_inc,
        is_final, f_lit_oob, f_truncated, f_offset_zero, f_terminated,
    ) = _speculative_tables(u8, n)
    S = lanes
    seg = pad // S
    L = seg // 3 + 2
    flags = _flag_bits(f_lit_oob, f_truncated, f_offset_zero, f_terminated, is_final)
    bad_stop = (flags & 0b111) != 0
    # Successor with error/final semantics folded in: errors and the final
    # sequence stop the walk by jumping past n.
    nxt_eff = torch.where(bad_stop | is_final, 1 << 28, nxt)
    starts = torch.arange(S, dtype=torch.int32, device=dev) * seg
    ends = starts + seg

    def walk_count(e, end):
        # Follow the chain from e to the first position >= end; count
        # sequences and accumulate output size and error flags on the way.
        ip = e.clone()
        cnt = torch.zeros_like(e)
        out = torch.zeros_like(e)
        err = torch.zeros_like(e)
        step = 0
        while True:
            act = (ip < end) & (ip < n)
            if step % _CHECK_EVERY == 0 and not packing.host_read(bool, act.any()):
                break
            step += 1
            ipc = ip.clamp(0, pad - 1)
            err = torch.where(act, err | flags[ipc], err)
            cnt = torch.where(act, cnt + 1, cnt)
            out = torch.where(act, out + out_inc[ipc], out)
            ip = torch.where(act, nxt_eff[ipc], ip)
        return ip, cnt, out, err

    def entries_from(exits):
        return torch.cat([exits.new_zeros(1), exits[:-1]])

    def is_fixpoint(e, exits):
        e2 = entries_from(exits)
        return packing.host_read(bool, ((e2 == e) | ((e2 >= n) & (e >= n))).all())

    # Pass A: exits from the speculative boundary entries (counts discarded).
    xA = walk_count(starts, ends)[0]
    # Pass B (+ retries): a lane set is a fixpoint when re-walking from
    # `entries` reproduces those same entries. Each retry validates at least
    # one more lane prefix, so the loop ends on valid data; the cap guards
    # streams that never synchronize.
    eB = entries_from(xA)
    exits, nseq_i, out_i, err_i = walk_count(eB, ends)
    i = 0
    while not is_fixpoint(eB, exits) and i < 8:
        eB = entries_from(exits)
        exits, nseq_i, out_i, err_i = walk_count(eB, ends)
        i += 1
    unconverged = torch.tensor(not is_fixpoint(eB, exits), device=dev)
    err_lit_oob = ((err_i & 1) == 1).any()
    err_trunc_bit = (((err_i >> 1) & 1) == 1).any()
    err_offset_zero = (((err_i >> 2) & 1) == 1).any()
    terminated = (((err_i >> 3) & 1) == 1).any()
    nseq = nseq_i.sum().to(torch.int32)
    total_out = out_i.sum().to(torch.int32)
    base_o = packing.tiled_cumsum(out_i) - out_i

    # Pass C: record walk; slot L of each row is a sink for stopped lanes.
    rec = torch.zeros((5, S, L + 1), dtype=torch.int32, device=dev)
    rec[2] = 1  # match_off fill
    lane = torch.arange(S, device=dev)
    ip, opos, li = eB.clone(), base_o.clone(), torch.zeros_like(eB)
    step = 0
    while True:
        act = (ip < ends) & (ip < n) & (li < L)
        if step % _CHECK_EVERY == 0 and not packing.host_read(bool, act.any()):
            break
        step += 1
        ipc = ip.clamp(0, pad - 1)
        slot = torch.where(act, li, L).long()
        rec[:, lane, slot] = torch.stack(
            [lit_start[ipc], ll[ipc], offset[ipc].clamp(min=1), ml[ipc], opos])
        ip = torch.where(act, nxt_eff[ipc], ip)
        opos = torch.where(act, opos + out_inc[ipc], opos)
        li = torch.where(act, li + 1, li)
    LS, LL, MO, ML, OO = rec[:, :, :L]

    other = err_lit_oob | err_offset_zero
    err_truncated = err_trunc_bit | (~terminated & ~other)
    errs = torch.stack([err_lit_oob, err_truncated, err_offset_zero])
    return LS, LL, MO, ML, OO, nseq_i, nseq, total_out, errs, unconverged


def default_parse_engine() -> str:
    """The device parse engine: "doubling". (The JAX package picks "walk" on
    a TPU only, where lockstep sequential walks are cheap; on a CPU or a
    CUDA card the vectorized doubling is faster.)"""
    return "doubling"


def parse_sequences_device(data, *, engine: str | None = None, device=None) -> SeqTable:
    """Parse a compressed block into a SeqTable on the device.

    ``engine``: "doubling" (the default) or "walk". ``device=None`` means
    the CUDA card. Raises the block error taxonomy on malformed input, as
    the host parser (sequences.parse_sequences_host) does."""
    if engine is None:
        engine = default_parse_engine()
    if engine not in ("doubling", "walk"):
        raise ValueError(f"unknown parse engine {engine!r}")
    dev = resolve_device(device)
    comp = _native.as_u8(data)
    n = comp.shape[0]
    if n == 0:
        raise block_errors.ExpectedAnotherByte()
    # +1: at least one zero pad byte must follow the payload, or a block
    # ending mid-0xFF LSIC run reads the last in-bounds byte as a terminator
    # instead of flagging truncation (packing.lsic_tables contract).
    pad = packing.size_bucket(n + 1)
    nseq_pad = packing.size_bucket(max(4, pad // 3 + 2), minimum=256)
    u8 = torch.from_numpy(packing.pad_to(comp, pad)).to(dev)
    parse = parse_walk_core if engine == "walk" else parse_core
    ls, ll, mo, ml, oo, nseq, total, errs = parse(u8, n, nseq_pad=nseq_pad)
    errs = errs.cpu().numpy()
    # Truncation first: a run-off LSIC field sets both flags, and the host
    # parser reports it as ExpectedAnotherByte.
    if errs[1]:
        raise block_errors.ExpectedAnotherByte()
    if errs[0]:
        raise block_errors.LiteralOutOfBounds()
    if errs[2]:
        raise block_errors.OffsetZero()
    k = int(nseq)
    return SeqTable(*(t[:k].cpu().numpy() for t in (ls, ll, mo, ml, oo)), int(total))
