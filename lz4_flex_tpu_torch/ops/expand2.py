"""Device block decode v2: fragment-structured expansion (the default engine).

The JAX package's ``ops/expand2.py`` as torch ops on the caller's device,
bit-equal to it. The v1 engine (ops/decode.py:expand_core) resolves the
per-byte source map with per-byte pointer doubling; this one exploits the
map's *fragment* structure: the resolved map is piecewise-affine with
fragments of a few bytes, so consecutive output bytes share a source delta
and a per-byte gather can become a per-(cell, fragment) row gather.

Three stages, mirroring the reference decoder's responsibilities (lz4_flex
src/block/decompress.rs:244-444) as data-parallel passes:

  1. map build: the piecewise-affine source map from the sequence table by
     sparse scatter-adds and cumulative sums, with self-overlapping matches
     (offset < length, the RLE case: src/block/decompress_safe.rs:301-318)
     collapsed analytically, src(p) = mstart - off + (p - mstart) % off;
  2. resolution: pointer doubling by W-byte cells: each cell takes the <= K
     distinct source deltas among its unresolved bytes and pulls each as one
     row; lanes of a higher rank wait a round (every hop strictly decreases
     the source, so progress is monotone). The surviving cells are compacted
     into a workset; a dense per-byte loop finishes whatever is left;
  3. materialization: each 16-byte output cell pulls its first K2 fragments
     as rows of the [compressed | dictionary] bytes and keeps each lane's
     own; cells with more fragments are compacted and finished in a second
     tier (a W-byte cell holds at most W fragments).

Every stage takes one block or a batch of blocks as rows (the JAX
package's ``vmap``), each row decoded as it would be alone. Loops whose
trip count the data decides (the resolution rounds) are Python loops that
read one device scalar a round for the whole batch. Padding, sentinels and
scatter targets keep the JAX semantics exactly
(ops/packing.py:scatter_drop).
"""

from __future__ import annotations

import torch

from . import packing

_INT_MIN = -(2**31)
_MAX_TAIL_ROUNDS = 40  # chains deeper than 2^40 bytes cannot exist


def _row_gather(operand: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """Fixed-width rows at dynamic starts: (N,) starts -> (N, width), or a
    batch: (B, n) operand and (B, N) starts -> (B, N, width), each row of
    starts into its own operand row.

    The JAX form reads the two aligned ``width`` rows covering the span
    (the second clamped to the last row) and selects the window; this is the
    same read as one indexed gather: starts are clamped into the operand,
    bytes past its end within the last row are zeros, and a window that runs
    past the last row wraps into that row again."""
    n = operand.shape[-1]
    rem = (-n) % width
    if rem:
        operand = torch.cat([operand, operand.new_zeros(*operand.shape[:-1], rem)], -1)
    nrows = operand.shape[-1] // width
    st = starts.clamp(0, n - 1)
    q, sh = st // width, st % width
    t = sh[..., None] + torch.arange(width, dtype=st.dtype, device=st.device)
    row = torch.where(t < width, q[..., None], (q[..., None] + 1).clamp(max=nrows - 1))
    idx = row * width + t % width
    if operand.dim() == 1:
        return operand[idx]
    return torch.gather(operand, -1, idx.reshape(idx.shape[0], -1).long()).reshape(idx.shape)


def _cell_ranks(d: torch.Tensor, active: torch.Tensor):
    """Per-cell distinct-run ranking of source deltas.

    d, active: (..., ncells, W). Equal deltas within a cell are contiguous
    runs (fragments are intervals), so run starts mark distinct fragments.
    Returns (rank, bnd): rank[..., c, l] is lane l's fragment index among
    the cell's active fragments (valid where active), bnd the run-start
    flags."""
    prev_same = torch.zeros_like(active)
    prev_same[..., 1:] = (d[..., 1:] == d[..., :-1]) & active[..., :-1]
    bnd = active & ~prev_same
    # A log-step scan over the W lanes: torch.cumsum along short rows runs
    # one slow kernel (PERF.md).
    rank = packing.doubling_scan(bnd.to(torch.int32), torch.add) - 1
    return rank, bnd


def _rank_value(d, bnd, rank, j):
    """The shared delta of fragment-rank j per cell: (..., ncells) int32."""
    return torch.where(bnd & (rank == j), d, _INT_MIN).amax(dim=-1)


def build_source_map(
    seq_oo,
    seq_ls,
    seq_ll,
    seq_mo,
    dict_len,
    total_out,
    *,
    out_pad,
    comp_pad,
    dict_bytes,
    prev_off=None,
):
    """Stage 1: the per-byte source map, self-overlap collapsed analytically.
    The sequence tables are (nseq_pad,) with int or () ``dict_len`` and
    ``total_out``, giving an (out_pad,) map, or a batch (B, nseq_pad) with
    (B,) ones, giving (B, out_pad) maps.

    Encoding: s[p] >= 0 is unresolved, its source the *output* position s[p]
    (always < p); s[p] < 0 is resolved, its source the byte -(s[p]+1) of the
    concatenated [compressed | dictionary] byte space.

    ``prev_off``: the previous *real* sequence's match offset per sequence.
    Defaults to the flat shift, right for order-packed tables; lane-major
    (strided-parse) tables must supply it."""
    if seq_oo.dim() == 1:
        return build_source_map(
            seq_oo[None], seq_ls[None], seq_ll[None], seq_mo[None], dict_len, total_out,
            out_pad=out_pad, comp_pad=comp_pad, dict_bytes=dict_bytes,
            prev_off=None if prev_off is None else prev_off[None])[0]
    dev = seq_oo.device
    pout = torch.arange(out_pad, dtype=torch.int32, device=dev)
    off_i = seq_mo.clamp(min=1)
    c_i = seq_ls - seq_oo
    if prev_off is None:
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

    # Latest match-segment start at/before p (literal positions don't care).
    M = packing.scatter_drop(zeros, match_starts, match_starts, "max")
    M = packing.tiled_cummax(M)

    is_lit = F > 0
    lit_k = pout + V
    off = V.clamp(min=1)  # V == match offset on match segments
    rel = pout - M
    # Self-overlap collapse: for rel < off this is just p - off; for
    # rel >= off it lands the RLE chain's true source, strictly before M.
    src = M - off + rel % off
    dict_k = comp_pad + (packing.per_row(dict_len) + src).clamp(0, max(dict_bytes - 1, 0))
    s = torch.where(is_lit, -(lit_k + 1), torch.where(src >= 0, src, -(dict_k + 1)))
    # Padding bytes: resolved with k = p so the padding region of every cell
    # shares one delta (d = 0) and cannot inflate fragment ranks.
    return torch.where(pout < packing.per_row(total_out), s, -(pout + 1))


def resolve_cells(s: torch.Tensor, *, out_pad, W=16, K=4, dense_rounds=3, tail_k=8):
    """Stage 2: collapse match chains, for one (out_pad,) map or a batch
    (B, out_pad) of them.

    Doubling at cell granularity: ``dense_rounds`` rounds over every cell,
    then the surviving cells (a shrinking fraction) are compacted into a
    cell-index workset and chased there with the same row pull, whole cells
    written back with a row scatter. A dense per-byte loop remains as the
    fallback for workset overflow (pathological inputs).

    Each row takes the workset or the fallback as its own counts say (the
    JAX package's ``lax.cond``, which ``vmap`` makes per row). The loops
    run while any row is live and read one device scalar a round; a row
    whose loop has ended is left as it stands, as a vmapped ``while_loop``
    leaves it."""
    if s.dim() == 1:
        return resolve_cells(s[None], out_pad=out_pad, W=W, K=K, dense_rounds=dense_rounds,
                             tail_k=tail_k)[0]
    dev = s.device
    B = s.shape[0]
    ncells = out_pad // W
    lane = torch.arange(W, dtype=torch.int32, device=dev)
    cellstart = torch.arange(ncells, dtype=torch.int32, device=dev) * W

    def cell_round(sv, cs, sflat, k):
        """One doubling hop for the cells starting at byte offsets ``cs``:
        sv (B, n, W) current values, sflat the full maps. Lanes whose
        fragment rank exceeds ``k`` wait a round."""
        un = sv >= 0
        d = sv - (cs[..., None] + lane)
        rank, bnd = _cell_ranks(d, un)
        sg = torch.cat([sflat.new_zeros(B, W), sflat], 1)
        new = sv
        for j in range(k):
            vj = _rank_value(d, bnd, rank, j)
            base = (cs + vj + W).clamp(0, out_pad)
            rows = _row_gather(sg, base, W)
            new = torch.where(un & (rank == j), rows, new)
        return new

    for _ in range(dense_rounds):
        s = cell_round(s.reshape(B, ncells, W), cellstart, s, K).reshape(B, out_pad)

    # Compact each row's surviving cells into a workset of cell indices.
    ws = max(1024, ncells // 4)
    active = (s.reshape(B, ncells, W) >= 0).any(dim=2)
    cnt = active.sum(1)
    crank = packing.tiled_cumsum(active.to(torch.int32)) - 1
    cells_i = torch.arange(ncells, dtype=torch.int32, device=dev)
    # Sentinel entries point at cell 0 (resolved in any valid stream: the
    # first output byte is a literal); their write-back is a no-op.
    cidx = packing.scatter_drop(
        torch.zeros((B, ws), dtype=torch.int32, device=dev), torch.where(active, crank, ws),
        cells_i)

    cells_w = cidx.long()[..., None].expand(-1, -1, W)  # the workset's cells, (B, ws, W)
    live, i = (cnt > 0) & (cnt <= ws), 0
    while i < _MAX_TAIL_ROUNDS and packing.host_read(bool, live.any()):
        sv = torch.gather(s.reshape(B, ncells, W), 1, cells_w)
        new = torch.where(live[:, None, None], cell_round(sv, cidx * W, s, tail_k), sv)
        s = s.reshape(B, ncells, W).scatter(1, cells_w, new).reshape(B, out_pad)
        live, i = live & (new >= 0).flatten(1).any(1), i + 1
    # The fallback finishes anything left (workset overflow, or lanes that
    # kept waiting behind rank > tail_k in a pathological cell).
    live, i = (s >= 0).any(1) & (cnt > 0), 0
    while i < _MAX_TAIL_ROUNDS and packing.host_read(bool, live.any()):
        g = torch.gather(s, 1, s.clamp(0, out_pad - 1).long())
        s = torch.where(live[:, None] & (s >= 0), g, s)
        live, i = live & (s >= 0).any(1), i + 1
    return s


def materialize_cells(s: torch.Tensor, words_g: torch.Tensor, *, out_pad, guard_words, W=16, K=8):
    """Stage 3: the cell pull, for one resolved (out_pad,) map or a batch
    (B, out_pad) of them. ``words_g`` is the guarded concatenated
    [zeros(guard) | compressed | dict | zeros(guard+8)] word buffer (int32
    bit patterns), one a row; ``s`` must be fully resolved (all negative).

    The JAX form pulls 5-word rows and funnel-shifts each lane's byte out;
    here the rows are read from the buffer's bytes, at the byte the funnel
    shift would pick, with the same clamps. Tier 2 and the per-byte
    fallback apply to the rows whose counts call for them."""
    if s.dim() == 1:
        return materialize_cells(s[None], words_g[None], out_pad=out_pad,
                                 guard_words=guard_words, W=W, K=K)[0]
    dev = s.device
    B = s.shape[0]
    ncells = out_pad // W
    nwords = words_g.shape[1]
    wslice = W // 4 + 1
    bytes_g = packing.words_to_bytes(words_g)
    lane = torch.arange(W, dtype=torch.int32, device=dev)
    cellstart = torch.arange(ncells, dtype=torch.int32, device=dev) * W
    pos = cellstart[:, None] + lane

    k = (-s - 1).reshape(B, ncells, W)
    d = k - pos
    rank, bnd = _cell_ranks(d, torch.ones((B, ncells, W), dtype=torch.bool, device=dev))

    def pull(j, d, bnd, rank, cs):
        vj = _rank_value(d, bnd, rank, j)
        b = cs + vj  # byte base of the source row (>= -(W-1))
        wb = ((b >> 2) + guard_words).clamp(0, nwords - wslice - 1)
        rows = _row_gather(bytes_g, wb * 4 + (b & 3), W)
        return rows, rank == j  # (B, n, W) bytes, take mask

    out = torch.zeros((B, ncells, W), dtype=torch.uint8, device=dev)
    for j in range(K):
        bytes_j, take = pull(j, d, bnd, rank, cellstart)
        out = torch.where(take, bytes_j, out)

    # Tier 2: cells whose fragment count exceeds K. A W-byte cell has at most
    # W fragments, so ranks K..W-1 are exhaustive. Compact those cells and
    # finish them with the same pull.
    over = rank.amax(dim=2) >= K
    ws = max(256, ncells // 8)
    cnt = over.sum(1)
    most = packing.host_read(int, cnt.max())
    crank = packing.tiled_cumsum(over.to(torch.int32)) - 1
    cidx = packing.scatter_drop(
        torch.zeros((B, ws), dtype=torch.int32, device=dev), torch.where(over, crank, ws),
        torch.arange(ncells, dtype=torch.int32, device=dev))

    if most > 0:
        cs2 = cidx * W
        d2 = _row_gather(d.reshape(B, -1), cs2, W)
        r2 = _row_gather(rank.reshape(B, -1), cs2, W)
        b2 = _row_gather(bnd.reshape(B, -1).to(torch.int32), cs2, W) > 0
        vals = out.reshape(B, -1)
        for j in range(K, W):
            bytes_j, take = pull(j, d2, b2, r2, cs2)
            flat = torch.where(take, cs2[..., None] + lane, out_pad)
            vals = packing.scatter_drop(vals, flat.reshape(B, -1), bytes_j.reshape(B, -1))
        out = torch.where((cnt > 0)[:, None, None], vals.reshape(B, ncells, W), out)
    if most > ws:
        # cnt > ws drops cells: every byte of such a row gathered on its own
        # instead (never seen in practice).
        kk = (-s - 1) + guard_words * 4
        one = torch.gather(bytes_g, 1, ((kk >> 2).clamp(0, nwords - 1) * 4 + (kk & 3)).long())
        out = torch.where((cnt > ws)[:, None, None], one.reshape(B, ncells, W), out)
    return out.reshape(B, out_pad)


def expand2_core(
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
    res_w: int = 16,
    res_k: int = 4,
    dense_rounds: int = 3,
    mat_w: int = 16,
    mat_k: int = 8,
) -> torch.Tensor:
    """Drop-in replacement for ops.decode.expand_core (same signature and
    output contract: (out_pad,) uint8, or (B, out_pad) for a batch of rows
    with (B, ...) tensors and (B,) counts) through the three stages above."""
    comp_pad = comp_words.shape[-1] * 4
    dict_bytes = dict_words.shape[-1] * 4 if has_dict else 0
    s = build_source_map(
        seq_oo, seq_ls, seq_ll, seq_mo, dict_len, total_out,
        out_pad=out_pad, comp_pad=comp_pad, dict_bytes=dict_bytes,
    )
    s = resolve_cells(s, out_pad=out_pad, W=res_w, K=res_k, dense_rounds=dense_rounds)
    guard_words = mat_w // 4
    lead = comp_words.shape[:-1]
    parts = [comp_words.new_zeros(*lead, guard_words), comp_words]
    if has_dict:
        parts.append(dict_words)
    # Tail pad >= the gather width so clamping never shifts a valid read.
    parts.append(comp_words.new_zeros(*lead, guard_words + 8))
    return materialize_cells(
        s, torch.cat(parts, -1), out_pad=out_pad, guard_words=guard_words, W=mat_w, K=mat_k
    )
