"""Production block encode: device candidate planes + native host walk.

The hybrid encoder (the JAX package's ``ops/encode.py:compress_block_hybrid``)
splits compression the way the ring decoder splits decompression: the device
finds, for every position, the closest previous occurrences of its 4-byte
word, exactly, by a sort; the native host walk (lz4_native.cpp) turns them
into wire bytes, re-extending every candidate with exact byte compares, so
the output is spec-valid whatever the planes hold.

Device programs (plain PyTorch on the caller's device, bit-equal to the JAX
functions; the JAX package has no Pallas kernel here):

  candidates_core  the 4 closest previous occurrences of each position's
                   word, as packed uint32 back-distances (single-chunk path)
  best_plane_core  the best of the 16 closest, scored by a capped exact
                   extension, 4:1 max-pooled to one uint16 per 4 positions
                   (streaming path, one row per 512 KiB chunk)

The uint32 word math runs in int64; the words then travel as their int32 bit
patterns, because the sort only groups equal words: within a group the
stable sort keeps positions ascending, and no result depends on the order of
the groups. Outputs carry the uint32/uint16 values as int32/int16 bit
patterns; view the host copy as uint32/uint16.

Inputs wider than one chunk row stream: the stream uploads once, the planes
are computed 8 chunk rows at a time from slices of it, each group comes back
to the host while the next one computes, the chunk walks run concurrently on
a host thread pool (each ~448 KiB chunk's dictionary is the preceding 64 KiB
of the stream), and one stitch joins the chunk wires.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native as _native
from ..parallel.executor import plan_executor
from ..spec.constants import WINDOW_SIZE, get_maximum_output_size
from . import packing
from .ringdecode import resolve_device

# Fixed chunking geometry for large inputs.
_CHUNK_W = 1 << 19  # 512 KiB row width (dict + data + slack)
_CHUNK_C = _CHUNK_W - WINDOW_SIZE - 4  # data bytes per chunk

# 4:1 pooling: the host walk probes both positions of a group and
# re-extends exactly, so pooling costs ratio, never correctness.
_PLANE_POOL = 4
_PLANE_ROWS = 8  # chunk rows per device dispatch

#: Public counters: ``candidate_calls`` counts calls of ``candidates_core``,
#: ``plane_quads`` dispatches of ``_best_plane_quad`` (each computes up to
#: ``_PLANE_ROWS`` chunk rows' planes).
stats = {"candidate_calls": 0, "plane_quads": 0}


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
            yield _best_plane_quad(gpad, starts).numpy().view(np.uint16)
        return
    main = torch.cuda.current_stream(gpad.device)
    side = torch.cuda.Stream(gpad.device)
    staged = []
    for starts in groups:
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

    def _walk(self, i: int, plane: np.ndarray) -> None:
        c = self._CCAP
        self.wire_len[i], self.tails[i] = _native.hybrid_walk_chunk(
            self.G, plane, self.starts[i], int(self.chunk_start[i]), self.limits[i],
            _PLANE_POOL.bit_length() - 1, self.wirebuf[i * c : (i + 1) * c],
            i == len(self.starts) - 1,
        )

    def submit(self, first_row: int, planes: np.ndarray) -> None:
        """Start the walks of chunk rows ``first_row``, ... on the pool,
        ``planes[k]`` being row ``first_row + k``'s plane (the padding rows
        of a last group are skipped)."""
        pool = plan_executor()
        for k in range(min(len(planes), len(self.starts) - first_row)):
            self._futures.append(pool.submit(self._walk, first_row + k, planes[k]))

    def wait(self) -> None:
        for f in self._futures:
            f.result()

    def stitch(self) -> bytes:
        self.wait()
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
