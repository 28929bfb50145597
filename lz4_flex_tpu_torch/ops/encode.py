"""Block encode on the device: the production hybrid encoder and the
all-device encoder.

The hybrid encoder (the JAX package's ``ops/encode.py:compress_block_hybrid``)
splits compression the way the ring decoder splits decompression: the device
finds, for every position, the closest previous occurrences of its 4-byte
word, exactly, by a sort; the native host walk (lz4_native.cpp) turns them
into wire bytes, re-extending every candidate with exact byte compares, so
the output is spec-valid whatever the planes hold.

The all-device encoder (``compress_block_device``, and the frame blocks
under 448 KiB through ``parallel/pipeline.py``) recovers the reference's
greedy walk algebraically, for all positions at once: the 4 closest
previous occurrences by the sort, match lengths by binary lifting over
power-of-two substring fingerprints, the greedy chain by pointer-doubling
reachability, a capped backward extension, and an emission in which every
output byte computes its own role and value. A fingerprint collision can
only overstate a match, so a zero-write host verify walk guards every
result and falls back to the host encoder on a mismatch.

Device programs (plain PyTorch on the caller's device, bit-equal to the JAX
functions; the JAX package has no Pallas kernel here):

  candidates_core    the 4 closest previous occurrences of each position's
                     word, as packed uint32 back-distances (hybrid, single
                     chunk)
  best_plane_core    the best of the 16 closest, scored by a capped exact
                     extension, 4:1 max-pooled to one uint16 per 4 positions
                     (hybrid streaming path, one row per 512 KiB chunk)
  match_core         stages 1-4 of the all-device encoder, per chunk row
  emit_core          stage 5: a sequence table to wire bytes, per row
  encode_chunk_core  both, for independent rows (the frame blocks): on the
                     card one launch of the hand-written kernel
                     ``csrc/encode_rows.cu``, bit-equal to its plain version
                     ``encode_chunk_core_reference`` (these torch ops),
                     which CPU tensors take
  _merge_emit        the resident path's stacked per-chunk tables merged
                     and emitted in one pass

The all-device programs take a leading batch dimension, which JAX's ``vmap``
and unrolled row groups give them there: their trip counts (the lifting
levels, the doubling rounds, the 16 backward steps) follow from the shapes,
so a group of rows is one dispatch.

The uint32 word math runs in int64; the words then travel as their int32 bit
patterns, because the sort only groups equal words: within a group the
stable sort keeps positions ascending, and no result depends on the order of
the groups. Outputs carry the uint32/uint16 values as int32/int16 bit
patterns; view the host copy as uint32/uint16.

Inputs wider than one chunk row stream: the stream uploads once, the chunk
rows are sliced from it on the device (each ~448 KiB chunk's dictionary is
the preceding 64 KiB of the stream). The hybrid encoder computes its planes
8 rows at a time, each group coming back to the host while the next one
computes, runs the chunk walks concurrently on a host thread pool, and
stitches the chunk wires. The all-device encoder matches 4 rows a dispatch,
reads back only each chunk's (match count, last match end), and merges and
emits the stacked tables on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native as _native
from ..block import compress_with_dict
from ..parallel.executor import plan_executor
from ..spec.constants import WINDOW_SIZE, get_maximum_output_size
from ..utils import trace
from . import packing
from .ringdecode import resolve_device

# Fixed chunking geometry for large inputs.
_CHUNK_W = 1 << 19  # 512 KiB row width (dict + data + slack)
_CHUNK_C = _CHUNK_W - WINDOW_SIZE - 4  # data bytes per chunk

# 4:1 pooling: the host walk probes both positions of a group and
# re-extends exactly, so pooling costs ratio, never correctness.
_PLANE_POOL = 4
_PLANE_ROWS = 8  # chunk rows per device dispatch

_C1, _C2, _C3 = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B1
_M32 = 0xFFFFFFFF

#: Public counters: ``candidate_calls`` counts calls of ``candidates_core``,
#: ``plane_quads`` dispatches of ``_best_plane_quad`` (each computes up to
#: ``_PLANE_ROWS`` chunk rows' planes), ``match_calls`` and ``emit_calls``
#: dispatches of the all-device encoder's match and emit stages over a batch
#: of rows, whichever implementation ran (``match_core`` and ``emit_core``,
#: or one launch of the kernel, which counts one of each),
#: ``encode_launches`` the kernel's launches and ``encode_rows`` the rows
#: they encoded, ``verify_fallbacks`` the device encodes that failed the host
#: verify walk and were replaced by the host encoder's bytes,
#: ``hybrid_blocks`` the non-empty blocks of ``compress_block_hybrid`` and
#: ``hybrid_chunks`` the chunk rows its streaming path walked.
stats = {"candidate_calls": 0, "plane_quads": 0, "match_calls": 0, "emit_calls": 0,
         "encode_launches": 0, "encode_rows": 0, "verify_fallbacks": 0, "hybrid_blocks": 0,
         "hybrid_chunks": 0}


def _shift_read(arr: torch.Tensor, k: int) -> torch.Tensor:
    """arr shifted left by k along the last dim (arr[..., i+k]), zero-padded."""
    if k == 0:
        return arr
    return torch.cat([arr[..., k:], arr.new_zeros(arr.shape[:-1] + (k,))], dim=-1)


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as the int32 tensor of their bit patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _words(u8: torch.Tensor) -> torch.Tensor:
    """The unaligned little-endian 4-byte word at every position (int64)."""
    u = u8.to(torch.int64)
    return u | (_shift_read(u, 1) << 8) | (_shift_read(u, 2) << 16) | (_shift_read(u, 3) << 24)


def candidates_core(u8: torch.Tensor):
    """The 4 closest previous occurrences of every position's 4-byte word,
    as u16 back-distances, over the last dim of a uint8 tensor.

    Returns (d12, d34) packing (delta1 | delta2 << 16) and (delta3 | delta4
    << 16) as int32 bit patterns of uint32; 0 means no candidate (or one
    beyond the 65535-byte reach)."""
    stats["candidate_calls"] += 1
    sw, sp = torch.sort(_u32_bits(_words(u8)), dim=-1, stable=True)
    ds = []
    for j in range(1, 5):
        # sorted index i against i-j, in place on slices; the first j get 0
        d = sp[..., j:] - sp[..., :-j]
        delta = torch.zeros_like(sp)
        delta[..., j:] = torch.where((sw[..., j:] == sw[..., :-j]) & (d <= 65535), d, 0)
        ds.append(delta)

    def to_positions(v):
        return _u32_bits(torch.zeros_like(sp).scatter_(-1, sp, v))

    return to_positions(ds[0] | (ds[1] << 16)), to_positions(ds[2] | (ds[3] << 16))


def best_plane_core(u8: torch.Tensor, pool: int = 2) -> torch.Tensor:
    """The best of the 16 closest previous occurrences of each position's
    word, ``pool``:1 max-pooled to one u16 back-distance per position group
    (0 = none), over the last dim of a uint8 tensor.

    A candidate's score is a capped exact extension (4, 8 or 12 bytes): the
    +4/+8-shifted word planes ride through the sort's permutation, so the
    scoring is compares of slices in the sorted domain. (score, closeness)
    pack into one int32, score << 16 | (65536 - delta), whose max is the best
    score with ties to the closest, and one scatter returns to position
    order. Returns the uint16 plane as an int16 tensor of bit patterns."""
    pad = u8.shape[-1]
    w4 = _u32_bits(_words(u8))
    pos = torch.arange(pad, dtype=torch.int32, device=u8.device)
    sw, perm = torch.sort(w4, dim=-1, stable=True)
    spi = pos[perm]  # true positions in sorted order
    s4 = torch.gather(_shift_read(w4, 4), -1, perm)
    s8 = torch.gather(_shift_read(w4, 8), -1, perm)
    best = torch.zeros(sw.shape, dtype=torch.int32, device=u8.device)
    for j in range(1, 17):
        # sorted index i against i-j, in place on slices; the first j keep 0
        d = spi[..., j:] - spi[..., :-j]
        ok = (sw[..., j:] == sw[..., :-j]) & (d <= 65535)
        e1 = s4[..., j:] == s4[..., :-j]
        e2 = (s8[..., j:] == s8[..., :-j]) & e1
        score = 4 + 4 * e1.to(torch.int32) + 4 * e2.to(torch.int32)
        tail = best[..., j:]
        torch.maximum(tail, torch.where(ok, (score << 16) | (65536 - d), 0), out=tail)
    plane = torch.zeros_like(best).scatter_(-1, spi.to(torch.int64), best)
    w = plane.reshape(plane.shape[:-1] + (pad // pool, pool)).amax(-1)
    v = torch.where(w > 0, 65536 - (w & 0xFFFF), 0)
    return (v - ((v >> 15) << 16)).to(torch.int16)


def _best_plane_quad(gpad: torch.Tensor, starts, pool: int = _PLANE_POOL) -> torch.Tensor:
    """The pooled planes of a group of chunk rows, (len(starts),
    _CHUNK_W // pool) int16, the rows sliced on the device from the resident
    stream at ``starts`` (host ints) and planed by one batched sort."""
    stats["plane_quads"] += 1
    rows = torch.stack([gpad[s : s + _CHUNK_W] for s in starts])
    return best_plane_core(rows, pool)


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy()).to(dev)


def _stream_rows(g_len: int, dlen: int, n_data: int):
    """The streaming encode's geometry: the padded stream length (dict ++
    data), and per chunk row its start in the stream and the end of its
    chunk's data; the row starts grouped ``_PLANE_ROWS`` to a dispatch, the
    last group padded with the last row."""
    bucket = packing.size_bucket(g_len + 8)
    starts, limits = [], []
    for i in range(-(-n_data // _CHUNK_C)):
        base = i * _CHUNK_C
        s = 0 if i == 0 else dlen + base - WINDOW_SIZE
        starts.append(min(s, bucket - _CHUNK_W))
        limits.append(dlen + min(base + _CHUNK_C, n_data))
    R = _PLANE_ROWS
    nquads = -(-len(starts) // R)
    padded = starts + [starts[-1]] * (R * nquads - len(starts))
    groups = [padded[R * q : R * q + R] for q in range(nquads)]
    return bucket, starts, limits, groups


def _host_planes(gpad: torch.Tensor, groups):
    """Yield each group's planes on the host, (rows, plane_len) uint16, in
    order. On CUDA every group is queued at once and copied into pinned
    memory on a side stream as it completes, so group q's copy overlaps
    group q+1's planes, and the caller's walks of group q overlap both."""
    if gpad.device.type != "cuda":
        for starts in groups:
            with trace.span("enc.planes"):
                planes = _best_plane_quad(gpad, starts).numpy().view(np.uint16)
            yield planes
        return
    main = torch.cuda.current_stream(gpad.device)
    side = torch.cuda.Stream(gpad.device)
    staged = []
    for starts in groups:
        with trace.span("enc.planes"):
            quad = _best_plane_quad(gpad, starts)
            host = torch.empty(quad.shape, dtype=quad.dtype, pin_memory=True)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                host.copy_(quad, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            quad.record_stream(side)
        staged.append((host, done))
    for host, done in staged:
        with trace.span("enc.plane_wait"):
            done.synchronize()
        yield host.numpy().view(np.uint16)


def compress_block_hybrid(data, ext_dict=b"", *, device=None) -> bytes:
    """Compress one raw LZ4 block (no size header): device candidate search
    + native host walk. ``device=None`` means the CUDA card; ``device="cpu"``
    computes the planes with the same PyTorch ops on the CPU.

    The walk is global over the chunk grid, so matches cross chunk
    boundaries. Output is byte-equal to the JAX package's
    ``compress_block_hybrid`` on the same input."""
    dev = resolve_device(device)
    src = _native.as_u8(data)
    dic = _native.as_u8(ext_dict)[-WINDOW_SIZE:]
    dlen = int(dic.shape[0])
    n_data = int(src.shape[0])
    if n_data == 0:
        return bytes([0x00])
    stats["hybrid_blocks"] += 1
    with trace.span("enc.hybrid"):
        G = np.concatenate([dic, src]) if dlen else src
        g_len = G.shape[0]
        if g_len + 4 > _CHUNK_W:
            return _compress_hybrid_streaming(G, g_len, dlen, n_data, dev)

        pad = packing.size_bucket(max(g_len + 4, 8))
        d12, d34 = candidates_core(_upload(packing.pad_to(G, pad), dev))
        return _native.compress_with_candidates(
            G, dlen, d12.cpu().numpy().view(np.uint32)[None], d34.cpu().numpy().view(np.uint32)[None],
            np.zeros(1, np.int64), np.array([dlen], np.int32),
        )


class _ChunkWalks:
    """The chunk walks of one streaming encode, run on the host pool, and
    the stitch that joins their wires (each pending literal tail folds into
    the next chunk's first sequence). One flat wire buffer holds a
    fixed-capacity region per chunk: a walk writes its region directly and
    the stitch reads (buffer, offsets)."""

    _CCAP = 16 + 4 + (_CHUNK_C * 110) // 100 + 16

    def __init__(self, G: np.ndarray, dlen: int, n_data: int, starts, limits) -> None:
        nrows = len(starts)
        self.G, self.n_data, self.starts, self.limits = G, n_data, starts, limits
        self.wirebuf = np.empty(nrows * self._CCAP, np.uint8)
        self.wire_off = np.arange(nrows, dtype=np.int64) * self._CCAP
        self.wire_len = np.zeros(nrows, np.int64)
        self.tails = np.zeros(nrows, np.int64)
        self.chunk_start = dlen + np.arange(nrows, dtype=np.int64) * _CHUNK_C
        self._futures = []

    def _walk(self, i: int, plane: np.ndarray, traced: bool) -> None:
        c = self._CCAP
        with trace.span("enc.walk", on=traced):
            self.wire_len[i], self.tails[i] = _native.hybrid_walk_chunk(
                self.G, plane, self.starts[i], int(self.chunk_start[i]), self.limits[i],
                _PLANE_POOL.bit_length() - 1, self.wirebuf[i * c : (i + 1) * c],
                i == len(self.starts) - 1,
            )

    def submit(self, first_row: int, planes: np.ndarray) -> None:
        """Start the walks of chunk rows ``first_row``, ... on the pool,
        ``planes[k]`` being row ``first_row + k``'s plane (the padding rows
        of a last group are skipped)."""
        pool, traced = plan_executor(), trace.enabled()
        for k in range(min(len(planes), len(self.starts) - first_row)):
            stats["hybrid_chunks"] += 1
            self._futures.append(pool.submit(self._walk, first_row + k, planes[k], traced))

    def wait(self) -> None:
        for f in self._futures:
            f.result()

    def stitch(self) -> bytes:
        self.wait()
        with trace.span("enc.stitch"):
            return _native.hybrid_stitch(self.G, self.wirebuf, self.wire_off, self.wire_len,
                                         self.chunk_start, self.tails,
                                         get_maximum_output_size(self.n_data))


def _compress_hybrid_streaming(G: np.ndarray, g_len: int, dlen: int, n_data: int,
                               dev: torch.device) -> bytes:
    """Multi-chunk hybrid encode, pipelined and chunk-parallel: the stream
    uploads once, the planes come back group by group (``_host_planes``),
    each chunk's walk starts on the pool as soon as its plane is on the
    host, and one stitch merges the chunk wires."""
    bucket, starts, limits, groups = _stream_rows(g_len, dlen, n_data)
    gpad = _upload(packing.pad_to(G, bucket), dev)
    walks = _ChunkWalks(G, dlen, n_data, starts, limits)
    for q, planes in enumerate(_host_planes(gpad, groups)):
        walks.submit(q * _PLANE_ROWS, planes)
    return walks.stitch()


# ---------------------------------------------------------------------------
# The all-device encoder
# ---------------------------------------------------------------------------


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32): the product is taken
    in two 16-bit halves so that no int64 product overflows."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two span fingerprints (int64 holding uint32 values) into the
    covering span's fingerprint, bit-equal to the JAX package's ``_mix``.

    Each input goes through multiply + xorshift before the modular-add
    combine: a purely linear combine like ``a ^ rotl(b, r)`` lets correlated
    ASCII pairs ('.'/',' in one word, 's'/'c' in the other) cancel exactly,
    which on English text produces systematic bogus matches."""
    a = _mul32(a, _C1)
    a = a ^ (a >> 16)
    b = _mul32(b, _C2)
    b = b ^ (b >> 16)
    h = _mul32((a + b) & _M32, _C3)
    return h ^ (h >> 15)


def match_core(u8: torch.Tensor, d: torch.Tensor, n: torch.Tensor, *, levels: int,
               nseq_pad: int):
    """Stages 1-4 of the all-device encoder for a batch of chunk rows.

    ``u8`` is (B, pad) uint8, each row dict ++ data, zero padded; ``d`` and
    ``n`` are (B,) int tensors: each row's dictionary length (its data
    starts there) and dictionary + data length. Returns the compacted
    per-match tables (lit_len, lit_start, offset, match_len), each (B,
    nseq_pad) int32 in chunk coordinates, the (B,) int32 match counts, and
    the (B,) int32 last_end, where each row's trailing literal run begins.

    Matches start at least 13 bytes before the row's end and end at least 5
    before it, offsets are 1..65535 (lz4_Block_format.md)."""
    stats["match_calls"] += 1
    B, pad = u8.shape
    dev = u8.device
    pos = torch.arange(pad, dtype=torch.int64, device=dev)
    d = d.to(device=dev, dtype=torch.int64).reshape(B, 1)
    n = n.to(device=dev, dtype=torch.int64).reshape(B, 1)
    u = u8.to(torch.int64)
    w4 = _words(u8)

    # --- 1. the 4 closest previous occurrences of each position's word -----
    sw, sp = torch.sort(_u32_bits(w4), dim=-1, stable=True)
    cands = []
    for j in range(1, 5):
        prev = torch.full_like(sp, -1)
        prev[:, j:] = torch.where(sw[:, j:] == sw[:, :-j], sp[:, :-j], -1)
        cands.append(torch.empty_like(sp).scatter_(-1, sp, prev))

    # --- 2. match lengths by binary lifting --------------------------------
    # H[k] fingerprints the 2**k bytes at each position: exact for k <= 2
    # (byte, u16, u32), mixed above; kept as int32 bit patterns.
    H = [_u32_bits(u), _u32_bits(u | (_shift_read(u, 1) << 8)), _u32_bits(w4)]
    h = w4
    for k in range(3, levels + 1):
        h = _mix(h, _shift_read(h, 1 << (k - 1)))
        H.append(_u32_bits(h))
    del h

    lim = (n - 5 - pos).clamp(min=0)  # match end <= n - 5
    top = pad - 1

    def eq_at(k, a, b):
        return torch.gather(H[k], -1, a.clamp(0, top)) == torch.gather(H[k], -1, b.clamp(0, top))

    eligible = (pos >= d) & (pos <= n - 13) & (lim >= 4)
    cand = torch.full((B, pad), -1, dtype=torch.int64, device=dev)
    mlen = torch.zeros((B, pad), dtype=torch.int64, device=dev)
    for ck in cands:
        valid = eligible & (ck >= 0) & (pos - ck <= 65535)
        c = ck.clamp(min=0)
        ml_k = torch.full((B, pad), 4, dtype=torch.int64, device=dev)
        for k in range(levels, -1, -1):
            step = 1 << k
            ok = (ml_k + step <= lim) & eq_at(k, pos + ml_k, c + ml_k)
            ml_k = ml_k + step * ok
        better = valid & (ml_k > mlen)  # ties keep the closer candidate
        cand = torch.where(better, ck, cand)
        mlen = torch.where(better, ml_k, mlen)
    del H, cands

    has_match = cand >= 0
    # Lazy one-step deferral: when the next position holds a strictly longer
    # match, step one literal instead of committing now.
    defer = torch.zeros_like(has_match)
    defer[:, :-1] = has_match[:, 1:] & (mlen[:, 1:] > mlen[:, :-1])
    has_match = has_match & ~defer
    mlen = torch.where(has_match, mlen, 0)
    c = cand.clamp(min=0)

    # --- 3. greedy chain by pointer-doubling reachability ------------------
    # The rows' jump tables lie end to end in one flat buffer (row r at
    # r * (pad + 1); slot pad of each row is its sentinel), with one sink
    # slot after them. M is 0/1, so the JAX package's M.at[J].max(M) sets 1
    # at J[i] wherever M[i] is 1: plain stores of one value (an atomic max
    # would contend on the sentinels that most walks reach).
    sent = pad
    jump = torch.where(has_match, pos + mlen, pos + 1)
    J = torch.where(pos < n, jump.clamp(0, sent), sent)
    J = torch.cat([J, J.new_full((B, 1), sent)], dim=1)
    row_base = torch.arange(B, dtype=torch.int64, device=dev).reshape(B, 1) * (pad + 1)
    J = (J + row_base).reshape(-1)
    cells = B * (pad + 1)
    M = torch.zeros(cells + 1, dtype=torch.int32, device=dev)
    M[(d + row_base).reshape(-1)] = 1
    for _ in range(max(1, (pad + 1).bit_length())):
        M[torch.where(M[:cells] == 1, J, cells)] = 1
        M[cells] = 0
        J = J[J]
    on_chain = (M[:cells].reshape(B, pad + 1)[:, :pad] == 1) & (pos < n)
    is_match = on_chain & has_match

    # Previous-match-end forward fill: the literal run feeding each match.
    ends = torch.where(is_match, pos + mlen, 0)
    E = packing.tiled_cummax(ends)
    E_excl = torch.cat([E.new_zeros((B, 1)), E[:, :-1]], dim=1)
    prev_end = torch.maximum(d, E_excl)

    # --- 4. capped backward extension over the literal run -----------------
    back_cap = torch.minimum(pos - prev_end, c)
    b = torch.zeros((B, pad), dtype=torch.int64, device=dev)
    live = is_match
    for j in range(1, 17):  # 16 bytes cover nearly all of lz4_flex's backtrack_match
        before = torch.gather(u8, -1, (pos - j).clamp(0, top).expand(B, pad))
        same = before == torch.gather(u8, -1, (c - j).clamp(0, top))
        live = live & same & (b + 1 <= back_cap)
        b = b + live
    mstart = pos - b
    mlen_x = mlen + b

    # --- compaction (JAX's mode="drop": a rank past nseq_pad is dropped) ---
    rank = torch.cumsum(is_match, dim=-1) - 1
    nmatch = rank[:, -1] + 1
    keep = is_match & (rank < nseq_pad)
    slot_base = torch.arange(B, dtype=torch.int64, device=dev).reshape(B, 1) * nseq_pad
    tgt = torch.where(keep, rank + slot_base, B * nseq_pad).reshape(-1)

    def compact(field, fill=0):
        base = torch.full((B * nseq_pad,), fill, dtype=torch.int32, device=dev)
        return packing.scatter_drop(base, tgt, field.reshape(-1)).reshape(B, nseq_pad)

    last_end = torch.maximum(d[:, 0], E[:, -1])
    return (
        compact(mstart - prev_end),  # literal length
        compact(prev_end),  # literal start, chunk coords
        compact(pos - c, fill=1),  # offset
        compact(mlen_x),  # match length (after backward extension)
        nmatch.to(torch.int32),
        last_end.to(torch.int32),
    )


def emit_core(words: torch.Tensor, s_ll, s_ls, s_off, s_mlc, s_match, nseq, *, comp_pad: int,
              real: torch.Tensor | None = None):
    """Stage 5: serialize sequence tables to LZ4 wire bytes, one per row.

    ``words`` is (B, W) int32: each row's source bytes packed as words (the
    literals' bytes, in the coordinates of ``s_ls``). The tables are (B,
    nseq_pad) int: literal length, literal start, match offset, match
    length code (length - 4), and 1 where the sequence has a match; ``nseq``
    (B,) counts each row's live sequences, or ``real`` (B, nseq_pad) bool
    says which slots are live (a stacked table with gaps; order is slot
    order). Returns (B, comp_pad) uint8 wire bytes, zero past each row's
    length, and the (B,) int32 lengths."""
    stats["emit_calls"] += 1
    B, nseq_pad = s_ll.shape
    dev = s_ll.device
    seq_i = torch.arange(nseq_pad, dtype=torch.int64, device=dev)
    if real is None:
        real = seq_i < nseq.to(device=dev, dtype=torch.int64).reshape(B, 1)
    s_ll, s_ls, s_off, s_mlc, s_match = (t.to(torch.int64) for t in (s_ll, s_ls, s_off, s_mlc, s_match))

    def lsic_n(v):
        return torch.where(v >= 15, (v - 15) // 255 + 1, 0)

    comp_len = 1 + lsic_n(s_ll) + s_ll + torch.where(s_match == 1, 2 + lsic_n(s_mlc), 0)
    comp_len = torch.where(real, comp_len, 0)
    ccum = torch.cumsum(comp_len, dim=-1)
    s_coff = ccum - comp_len
    total_comp = ccum[:, -1]

    # Each output byte's sequence: the sequence index at its start offset,
    # forward-filled. The JAX package max-scatters into a zero plane with
    # every non-live slot sent to one dropped target; a live sequence has
    # comp_len >= 1, so live start offsets are distinct and a plain store
    # (non-live slots to a sink column, sliced off) gives the same plane.
    q = torch.arange(comp_pad, dtype=torch.int64, device=dev)
    z = torch.zeros((B, comp_pad + 1), dtype=torch.int64, device=dev)
    z.scatter_(-1, torch.where(real & (s_coff < comp_pad), s_coff, comp_pad), seq_i.expand(B, nseq_pad))
    sq = packing.tiled_cummax(z[:, :comp_pad])

    def at(t):
        return torch.gather(t, -1, sq)

    ll, src, off, mlcq = at(s_ll), at(s_ls), at(s_off), at(s_mlc)
    hasm = at(s_match) == 1
    delta = q - at(s_coff)

    ll_v = ll - 15
    t1 = 1 + torch.where(ll >= 15, ll_v // 255 + 1, 0)
    t2 = t1 + ll
    ml_v = mlcq - 15

    token = (ll.clamp(max=15) << 4) | torch.where(hasm, mlcq.clamp(max=15), 0)
    lsic_ll = (ll_v - 255 * (delta - 1)).clamp(max=255)
    lit_byte = packing.gather_bytes(words, src + (delta - t1))
    off_byte = torch.where(delta == t2, off & 0xFF, off >> 8)
    lsic_ml = (ml_v - 255 * (delta - t2 - 2)).clamp(max=255)

    val = torch.where(
        delta == 0, token,
        torch.where(delta < t1, lsic_ll,
                    torch.where(delta < t2, lit_byte,
                                torch.where(delta < t2 + 2, off_byte, lsic_ml))))
    out = torch.where(q < total_comp.reshape(B, 1), val, 0).to(torch.uint8)
    return out, total_comp.to(torch.int32)


def encode_chunk_core(u8, words, d, n, *, levels: int, comp_pad: int, nseq_pad: int):
    """Independent rows encoded whole (match, final literal record,
    emission) in chunk coordinates: (B, pad) uint8 rows, their (B, pad / 4)
    int32 words, and (B,) dictionary and dictionary + data lengths ->
    ((B, comp_pad) uint8 wire bytes, (B,) int32 lengths).

    On CUDA rows this is one launch of the kernel ``csrc/encode_rows.cu``
    (:func:`encode_rows_kernel`); CPU rows take the torch ops of
    :func:`encode_chunk_core_reference`. Both give the same bytes."""
    if u8.device.type == "cuda":
        stats["match_calls"] += 1
        stats["emit_calls"] += 1
        lens = [t.to(device=u8.device, dtype=torch.int32).reshape(-1).contiguous() for t in (d, n)]
        return encode_rows_kernel(u8, words, *lens, levels=levels, comp_pad=comp_pad,
                                  nseq_pad=nseq_pad)
    return encode_chunk_core_reference(u8, words, d, n, levels=levels, comp_pad=comp_pad,
                                       nseq_pad=nseq_pad)


def encode_chunk_core_reference(u8, words, d, n, *, levels: int, comp_pad: int, nseq_pad: int):
    """The plain version of :func:`encode_chunk_core`: ``match_core``, the
    trailing literal run in slot nm, and ``emit_core``, torch ops on the
    rows' device."""
    ll, ls, off, ml, nm, last_end = match_core(u8, d, n, levels=levels, nseq_pad=nseq_pad)
    B = u8.shape[0]
    nm_col = nm.to(torch.int64).reshape(B, 1)
    n_col = n.to(device=u8.device, dtype=torch.int32).reshape(B, 1)
    # slot nm (< nseq_pad: a row of pad bytes holds fewer than pad / 4
    # matches) takes the trailing literal run
    ll = ll.scatter(-1, nm_col, n_col - last_end.reshape(B, 1))
    ls = ls.scatter(-1, nm_col, last_end.reshape(B, 1))
    mlc = (ml - 4).clamp(min=0)
    seq_i = torch.arange(ll.shape[1], dtype=torch.int64, device=u8.device)
    s_match = (seq_i < nm_col).to(torch.int32)
    return emit_core(words, ll, ls, off, mlc, s_match, nm + 1, comp_pad=comp_pad)


def encode_rows_kernel(u8, words, d, n, *, levels: int, comp_pad: int, nseq_pad: int):
    """The all-device encode as one launch of the kernel
    ``csrc/encode_rows.cu`` on the current stream, a cluster of up to 4 CTAs
    a row: ``u8`` (B, width) uint8 CUDA rows (dictionary ++ data, zero
    padded), ``words`` their (B, width / 4) int32 words (the literals'
    source), ``d`` and ``n`` the (B,) int32 dictionary and dictionary + data
    lengths, all contiguous on one card. Returns what
    :func:`encode_chunk_core_reference` returns, byte for byte, in tensors
    made with ``torch.empty`` that the kernel fills; its scratch is made here
    too (the fingerprint planes, the chain and the tables: 52 bytes a
    position at 12 levels, and the CTAs' hash tables, 16-32). No host read.
    Raises ValueError on tensors or sizes the kernel does not take."""
    if u8.dtype != torch.uint8 or u8.dim() != 2:
        raise ValueError(f"rows must be a 2-D uint8 tensor, got {u8.dtype} {tuple(u8.shape)}")
    B, width = u8.shape
    if not 0 < width < 2**28 or width % 4:
        raise ValueError(f"row width must be a multiple of 4 in (0, 2**28), got {width}")
    if words.dtype != torch.int32 or tuple(words.shape) != (B, width // 4):
        raise ValueError(f"words must be int32 ({B}, {width // 4}), got {words.dtype} "
                         f"{tuple(words.shape)}")
    for name, t in (("dictionary lengths", d), ("lengths", n)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be int32 ({B},), got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (u8, words, d, n)):
        raise ValueError("the rows, words and lengths must be contiguous")
    if not 2 <= levels <= 24 or not 0 < comp_pad < 2**31 or not 0 < nseq_pad < 2**28:
        raise ValueError(f"levels must be in [2, 24], comp_pad in (0, 2**31) and nseq_pad in "
                         f"(0, 2**28), got {levels}, {comp_pad} and {nseq_pad}")
    if u8.device.type != "cuda" or any(t.device != u8.device for t in (words, d, n)):
        raise ValueError(f"the encode kernel takes its tensors on one CUDA card, got "
                         f"{[str(t.device) for t in (u8, words, d, n)]} (CPU tensors take "
                         "encode_chunk_core_reference)")
    dev = u8.device
    out = torch.empty((B, comp_pad), dtype=torch.uint8, device=dev)
    total = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        from ._kernels import encode_rows_ranks, launch_encode_rows

        plane = width + 4  # a position plane and its sentinel slot
        row_ints = (3 + max(levels - 2, 4)) * plane + 5 * nseq_pad + 2
        scratch = torch.empty((B, row_ints), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            ranks = encode_rows_ranks(B)
            # a CTA's hash table holds the words of its segment, at most half full
            segment = width // ranks + 1024
            tables = torch.empty((B, ranks, 1 << max(12, (2 * segment - 1).bit_length())),
                                 dtype=torch.int64, device=dev)
            launch_encode_rows(u8, words, d, n, out, total, scratch, tables, levels=levels,
                               nseq_pad=nseq_pad, stream=torch.cuda.current_stream().cuda_stream)
        stats["encode_launches"] += 1
        stats["encode_rows"] += B
    return out, total


_ROW_BUCKETS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256]


def _row_bucket(b: int) -> int:
    for rb in _ROW_BUCKETS:
        if rb >= b:
            return rb
    return -(-b // 256) * 256


def _levels_for(pad: int) -> int:
    return min(14 if pad <= (1 << 20) else 12, max(2, (pad - 1).bit_length()))


def _match_quad(gpad: torch.Tensor, starts4, d4, t4, *, levels: int, nseq_pad: int):
    """Four chunk rows matched in one dispatch, sliced on the device from
    the resident stream at ``starts4`` (host ints; each row's dictionary is
    the preceding 64 KiB of the stream), with their dictionary and
    dictionary + data lengths ``d4``, ``t4``: ``match_core``'s six outputs,
    stacked over the four rows."""
    rows = torch.stack([gpad[s : s + _CHUNK_W] for s in starts4])
    lens = torch.tensor(np.stack([d4, t4]), dtype=torch.int64).to(gpad.device)
    return match_core(rows, lens[0], lens[1], levels=levels, nseq_pad=nseq_pad)


def _merge_emit(words, ll, ls, off, ml, nm_dev, g_dev, carry_vec, final_carry: int, n_data: int,
                *, comp_pad: int):
    """The resident encoder's table merge and emission on the device. The
    per-chunk tables stay stacked, (brows, nseq_pad) with their pad gaps:
    live slots are masked and flat order is stream order, so the merge is
    elementwise (rebase to data coordinates by ``g_dev``, slot-0 fixups
    that fold each chunk's carried literal run, starting at ``carry_vec``,
    into its first sequence, and one appended final literal-only sequence
    from ``final_carry`` to ``n_data``). Returns the (comp_pad,) uint8 wire
    bytes and their () int32 length."""
    brows, nseq_pad = ll.shape
    dev = ll.device
    slot = torch.arange(nseq_pad, dtype=torch.int64, device=dev)
    real = (slot < nm_dev.to(torch.int64).reshape(brows, 1)).reshape(-1)
    ls_g = (ls.to(torch.int64) + g_dev.to(torch.int64).reshape(brows, 1)).reshape(-1)
    ll_f = ll.reshape(-1).to(torch.int64, copy=True)  # written below
    # Slot-0 fixups (rows whose nm == 0 are fixed too: their slot 0 is not
    # live, so the write is harmless).
    fix = torch.arange(brows, dtype=torch.int64, device=dev) * nseq_pad
    carry = carry_vec.to(torch.int64)
    m0 = ls_g[fix] + ll_f[fix]
    ll_f[fix] = m0 - carry
    ls_g[fix] = carry
    # The final literal-only sequence rides an appended pad block (slot 0 live).
    head = torch.arange(256, device=dev) == 0
    ll_f = torch.cat([ll_f, torch.where(head, n_data - final_carry, 0)])
    ls_g = torch.cat([ls_g, torch.where(head, final_carry, 0)])
    off_f = torch.cat([off.to(torch.int64).reshape(-1), torch.ones(256, dtype=torch.int64, device=dev)])
    mlc_f = torch.cat([(ml.to(torch.int64).reshape(-1) - 4).clamp(min=0),
                       torch.zeros(256, dtype=torch.int64, device=dev)])
    match_f = torch.cat([real.to(torch.int64), torch.zeros(256, dtype=torch.int64, device=dev)])
    real_f = torch.cat([real, head])
    out, total = emit_core(words.reshape(1, -1), ll_f[None], ls_g[None], off_f[None], mlc_f[None],
                           match_f[None], None, comp_pad=comp_pad, real=real_f[None])
    return out[0], total[0]


@dataclass
class _Merged:
    ll: np.ndarray
    ls: np.ndarray
    off: np.ndarray
    mlc: np.ndarray
    match: np.ndarray
    nseq: int


def _merge_tables(chunks, data_len: int) -> _Merged:
    """Stitch per-chunk match tables (chunk coords) into one global table,
    on the host.

    chunks: list of (lit_len, lit_start, off, mlen, nmatch, last_end, d, base)
    where base is the chunk data's global start and d its dictionary length.
    Literal runs merge across chunk boundaries: each chunk's trailing
    literals become the head of the next chunk's first sequence.
    """
    ll_out, ls_out, off_out, mlc_out = [], [], [], []
    carry_start = 0  # global position where the pending literal run begins
    for ll, ls, off, ml, nm, last_end, d, base in chunks:
        nm = int(nm)
        if nm == 0:
            continue  # the whole chunk rides the literal carry
        g = base - int(d)  # chunk coord -> global data coord
        ll = ll[:nm].astype(np.int64)
        ls = ls[:nm].astype(np.int64) + g
        # The first sequence absorbs the carried literal run.
        m0 = ls[0] + ll[0]
        ls[0] = carry_start
        ll[0] = m0 - carry_start
        ll_out.append(ll)
        ls_out.append(ls)
        off_out.append(off[:nm])
        mlc_out.append(ml[:nm] - 4)
        carry_start = int(last_end) + g
    # The final literal-only sequence.
    ll_out.append(np.array([data_len - carry_start], np.int64))
    ls_out.append(np.array([carry_start], np.int64))
    off_out.append(np.array([0], np.int32))
    mlc_out.append(np.array([0], np.int32))
    ll = np.concatenate(ll_out).astype(np.int32)
    ls = np.concatenate(ls_out).astype(np.int32)
    off = np.concatenate(off_out).astype(np.int32)
    mlc = np.concatenate(mlc_out).astype(np.int32)
    match = np.ones(ll.shape[0], np.int32)
    match[-1] = 0
    return _Merged(ll, ls, off, mlc, match, ll.shape[0])


def _words_of(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``arr`` zero-padded to its size bucket and uploaded as int32 words."""
    return _upload(packing.pad_to(arr, packing.size_bucket(max(arr.shape[0], 4))).view(np.int32), dev)


def compress_block_device(data, ext_dict=b"", *, verify: bool = True, as_array: bool = False,
                          device=None):
    """Compress one raw LZ4 block (no size header) with the all-device
    encoder. ``device=None`` means the CUDA card; ``device="cpu"`` runs the
    same torch ops on the CPU.

    ``verify`` checks the result with the native zero-write verify walk and
    falls back to the host encoder on a mismatch (the guard against
    fingerprint collisions in the match lengths), counted in
    ``stats["verify_fallbacks"]``. Returns bytes, or with ``as_array`` the
    (comp_pad,) uint8 tensor on the device (zero past the end) and the
    length. Output is byte-equal to the JAX package's
    ``compress_block_device`` on the same input."""
    dev = resolve_device(device)
    src = _native.as_u8(data)
    dic = _native.as_u8(ext_dict)[-WINDOW_SIZE:]
    dlen = int(dic.shape[0])
    n_data = int(src.shape[0])

    if n_data + dlen + 4 > _CHUNK_W:
        out, total = _compress_device_resident(src, dic, dev)
        return _finish_device_block(out, total, src, dic, verify=verify, as_array=as_array)

    # One chunk at a per-size bucket; its table is merged on the host.
    buf = np.concatenate([dic, src]) if dlen else src
    pad = packing.size_bucket(max(buf.shape[0] + 4, 8))
    nseq_pad = packing.size_bucket(max(8, pad // 4 + 2), minimum=256)
    lens = torch.tensor([dlen, buf.shape[0]], dtype=torch.int64).to(dev)
    ll, ls, off, ml, nm, last_end = match_core(
        _upload(packing.pad_to(buf, pad), dev)[None], lens[:1], lens[1:],
        levels=_levels_for(pad), nseq_pad=nseq_pad)
    tables = torch.cat([ll, ls, off, ml]).cpu().numpy()
    counts = torch.cat([nm, last_end]).cpu().numpy()
    merged = _merge_tables([(*tables, *counts, dlen, 0)], n_data)
    comp_pad = packing.size_bucket(get_maximum_output_size(n_data))
    nseq_pad_g = packing.size_bucket(max(8, merged.nseq), minimum=256)
    fields = np.stack([packing.pad_to(merged.ll, nseq_pad_g), packing.pad_to(merged.ls, nseq_pad_g),
                       packing.pad_to(merged.off, nseq_pad_g, fill=1),
                       packing.pad_to(merged.mlc, nseq_pad_g), packing.pad_to(merged.match, nseq_pad_g)])
    t = torch.from_numpy(fields).to(dev)
    out, total = emit_core(_words_of(src, dev)[None], *(t[i : i + 1] for i in range(5)),
                           torch.tensor([merged.nseq]), comp_pad=comp_pad)
    return _finish_device_block(out[0], total[0], src, dic, verify=verify, as_array=as_array)


def _compress_device_resident(src: np.ndarray, dic: np.ndarray, dev: torch.device):
    """The resident multi-chunk encode: the stream uploads once, chunk rows
    are sliced from it on the device and matched 4 a dispatch, and the
    stacked tables are merged and emitted on the device (``_merge_emit``).
    The only host read before the wire bytes is one (match count,
    last_end) pair per ~448 KiB chunk, which the literal carries need."""
    dlen = int(dic.shape[0])
    n_data = int(src.shape[0])
    nrows = -(-n_data // _CHUNK_C)
    brows = _row_bucket(nrows)
    nq = -(-brows // 4)

    G = np.concatenate([dic, src]) if dlen else src
    gpad = _upload(packing.pad_to(G, packing.size_bucket(G.shape[0] + _CHUNK_W)), dev)
    words = _words_of(src, dev)

    starts = np.zeros(4 * nq, np.int64)
    d4 = np.zeros(4 * nq, np.int64)
    t4 = np.zeros(4 * nq, np.int64)
    g4 = np.zeros(4 * nq, np.int64)
    for i in range(nrows):
        base = dlen + i * _CHUNK_C  # chunk data start in G
        d_i = min(WINDOW_SIZE, base)
        clen = min(_CHUNK_C, n_data - i * _CHUNK_C)
        starts[i] = base - d_i
        d4[i] = d_i
        t4[i] = d_i + clen
        g4[i] = base - dlen - d_i  # chunk coord -> data coord
    nseq_pad = packing.size_bucket(_CHUNK_W // 4 + 2, minimum=256)
    levels = _levels_for(_CHUNK_W)
    quads = [_match_quad(gpad, starts[4 * q : 4 * q + 4].tolist(), d4[4 * q : 4 * q + 4],
                         t4[4 * q : 4 * q + 4], levels=levels, nseq_pad=nseq_pad)
             for q in range(nq)]
    ll, ls, off, ml, nm, last_end = (torch.cat([qd[k] for qd in quads]) for k in range(6))
    nm_h, le_h = torch.stack([nm, last_end]).cpu().numpy()
    carry_vec = np.zeros(4 * nq, np.int64)
    carry = 0
    for i in range(4 * nq):
        carry_vec[i] = carry
        if i < nrows and nm_h[i] > 0:
            carry = int(le_h[i]) + int(g4[i])
    live_rows = torch.from_numpy((np.arange(4 * nq) < nrows).astype(np.int32)).to(dev)
    per_row = torch.from_numpy(np.stack([g4, carry_vec])).to(dev)
    return _merge_emit(words, ll, ls, off, ml, nm * live_rows, per_row[0], per_row[1], carry,
                       n_data, comp_pad=packing.size_bucket(get_maximum_output_size(n_data)))


def _finish_device_block(out: torch.Tensor, total_comp: torch.Tensor, src: np.ndarray,
                         dic: np.ndarray, *, verify: bool, as_array: bool):
    """The wire bytes of a device encode, through the verify guard."""
    total = int(total_comp)
    if as_array and not verify:
        return out, total
    comp = out[:total].cpu().numpy().tobytes()
    if verify and not _native.verify_block(comp, src, dic):
        # a fingerprint collision overstated a match: the host encoder's
        # output is valid by construction
        stats["verify_fallbacks"] += 1
        comp = compress_with_dict(src, dic)
        if as_array:
            return _upload(np.frombuffer(comp, np.uint8), out.device), len(comp)
    if as_array:
        return out, total
    return comp
