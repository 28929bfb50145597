"""Ring decoder: host pull-plan + hand-written CUDA kernel for LZ4 decode.

The native runtime (`tlz4_build_ring_plan2`, native/lz4_native.cpp) walks
the compressed stream once and emits a data-parallel pull schedule instead of
performing the copies: a per-tile LITERAL IMAGE (every literal byte, and
every match byte whose source is already final, at its output position) plus
compact per-tile match record streams that the kernel applies RB records
("one fire") at a time over a 64 KiB ring window.

Table layout per tile t (rows of 128 bytes):

  [0, WR)      ring: output rows [t*TR - WR, t*TR)   (WR = 64 KiB)
  [WR, WR+TR)  the tile being decoded — seeded from the literal image,
               match fires update it in place

Record stream semantics (record k -> field arrays [t, k // RB, k % RB], so
fire j = k // RB consumes the contiguous record row j):

  out lane l (lo <= l < lo+len) of row `row` = tbl[S + (l+ph) mod P]

  f0 = S                     table-local byte address (<= 17 bits)
  f1 = ph | (P-1)<<7 | lo<<14
  f2 = (len-1) | row<<7      row >= TR is padding (no scatter)

All reads of a fire see the table as it was before that fire's writes; the
writes within a fire are disjoint. :func:`ring_decode` launches the CUDA
kernel (csrc/ring_decode.cu) on CUDA tensors and runs the plain PyTorch
version :func:`ring_decode_reference` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import native as _native
from ..block import errors as block_errors

# 32 KiB output tiles by default; ``tile_rows=512`` selects 64 KiB tiles
# (fewer, longer fire chains, and the dense reserved-fire packer in the
# native planner). Must be a power of two in [64, 512]: the native packers
# keep 512-row hazard state.
TILE_ROWS = 256
WINDOW_ROWS = 512  # 64 KiB LZ4 window
RB = 256  # records per fire
NFMAX_ALLOC = 24  # fires-per-tile first-try cap (retry ladder on overflow)
# Retry ladder instead of one jump to the hard cap keeps the record arrays
# (ntiles x NF x RB) tight; the last step is the hard cap, and overflow
# there makes plan building return None.
NFMAX_STEPS = (32, 48, 64, 96, 160)
NFMAX_RETRY = NFMAX_STEPS[-1]
_NFMAX_LADDER = (NFMAX_ALLOC,) + NFMAX_STEPS
# Adaptive starting rung: the next default-capacity build starts at the
# smallest rung that held the previous plan (benign race — worst case is
# one extra retry).
_nfmax_hint = [NFMAX_ALLOC]
# Host-side chain resolution: pieces at least this deep resolve into affine
# runs on the host instead of becoming kernel records.
RESOLVE_MIN_DEPTH = 16
RESOLVE_RUNS = 16

PLAN_OVERFLOW_CODES = (-100, -102, -103, -104)

#: Public counters. ``kernel_launches`` counts every launch of the ring
#: kernel (K1), ``checksum_launches`` those of its checksum variant (K1b),
#: ``overflow_host_decodes`` every decode that fell to the native host
#: decoder because the plan overflowed its static shape.
stats = {"kernel_launches": 0, "checksum_launches": 0, "overflow_host_decodes": 0}


def check_tile_rows(tile_rows: int) -> None:
    if tile_rows & (tile_rows - 1) or not 64 <= tile_rows <= 512:
        raise ValueError(f"tile_rows must be a power of two in [64, 512], got {tile_rows}")


@dataclass
class RingPlan:
    rec_f0: np.ndarray  # (ntiles, NF, RB) int32: S
    rec_f1: np.ndarray  # (ntiles, NF, RB) int32: ph | (P-1)<<7 | lo<<14
    rec_f2: np.ndarray  # (ntiles, NF, RB) int32: (len-1) | row<<7
    nf_tot: np.ndarray  # (ntiles,) int32, match fires per tile
    fper: np.ndarray  # (ntiles, ceil(NF/32)) int32 per-fire periodic flags;
    #                   kept for parity of plans, never read by the kernel
    lit_init: np.ndarray  # (ntiles*TR, 128) uint8 literal image
    total_out: int
    ntiles: int

    tile_rows: int = TILE_ROWS
    window_rows: int = WINDOW_ROWS
    rb: int = RB

    # Pool-lifetime stamp: the arrays come from a 2-generation rotating pool
    # (`_record_arrays`), so the SECOND later build on the same thread reuses
    # them. check_live() fails loudly instead of uploading stale records.
    seq: int = 0
    seq_holder: object = None

    def check_live(self) -> None:
        if self.seq_holder is not None and self.seq_holder[0] - self.seq >= 2:
            raise RuntimeError(
                "RingPlan invalidated: its pooled record arrays were reused "
                f"by a later build_ring_plan call on this thread (built at "
                f"generation {self.seq}, pool now at {self.seq_holder[0]}). "
                "Upload each plan before building two more, or copy the "
                "record arrays out."
            )

    @classmethod
    def from_arrays(cls, rec_f0, rec_f1, rec_f2, nf_tot, fper, lit_init,
                    total_out: int, tile_rows: int = TILE_ROWS) -> "RingPlan":
        """A plan from the numpy fields of a plan built elsewhere (e.g. by
        the JAX package's planner). The arrays are copied, so the plan owns
        them and is never invalidated by a pool."""
        check_tile_rows(tile_rows)
        f0, f1, f2 = (np.array(a, np.int32) for a in (rec_f0, rec_f1, rec_f2))
        nf_tot = np.array(nf_tot, np.int32)
        lit_init = np.array(lit_init, np.uint8)
        ntiles = nf_tot.shape[0]
        if f0.ndim != 3 or not f0.shape == f1.shape == f2.shape or f0.shape[0] != ntiles:
            raise ValueError(f"record arrays must be (ntiles, NF, RB), got {f0.shape}")
        if lit_init.shape != (ntiles * tile_rows, 128):
            raise ValueError(f"lit_init must be ({ntiles * tile_rows}, 128), got {lit_init.shape}")
        if int(total_out) > ntiles * tile_rows * 128:
            raise ValueError("total_out exceeds the plan's tiles")
        return cls(f0, f1, f2, nf_tot, np.array(fper, np.int32), lit_init,
                   int(total_out), ntiles, tile_rows, WINDOW_ROWS, f0.shape[2])


_scratch = threading.local()


def _record_arrays(ntiles: int, nfmax: int, rb: int, tile_rows: int):
    """Per-thread rotating pool for the plan's (ntiles, NF, RB) record arrays
    and its (ntiles*tile_rows, 128) literal image.

    Two generations rotate so the arrays of the previous build stay untouched
    while the next one runs. Returns (arrays, seq_holder, seq): a plan is
    live while ``seq_holder[0] - seq < 2`` (see :meth:`RingPlan.check_live`).
    """
    gens = getattr(_scratch, "plan_gens", None)
    if gens is None:
        gens = _scratch.plan_gens = [None, None]
        _scratch.plan_idx = 0
        _scratch.plan_seq = [0]
    _scratch.plan_idx ^= 1
    _scratch.plan_seq[0] += 1
    cur = gens[_scratch.plan_idx]
    shape = (ntiles, nfmax, rb)
    ishape = (ntiles * tile_rows, 128)
    if cur is None or cur[0].shape != shape or cur[3].shape != ishape:
        cur = tuple(np.empty(shape, np.int32) for _ in range(3)) + (
            np.empty(ishape, np.uint8),
        )
        gens[_scratch.plan_idx] = cur
    return cur, _scratch.plan_seq, _scratch.plan_seq[0]


def build_ring_plan_parts(
    parts,
    total_out: int,
    *,
    independent: bool = False,
    tile_rows: int = TILE_ROWS,
    nfmax: int | None = None,
):
    """Build the ring-decoder plan for a block list on the host.

    ``parts`` is a list of (payload, is_compressed) pairs in frame order —
    one entry decodes a raw block, several decode a whole frame body (stored
    blocks pass through as literals). ``independent`` restricts every match
    to its own block's output.

    Returns (plan, concatenated_comp), or (None, None) when the input does
    not fit the static plan shape (record, depth, or literal-window
    overflow). Raises the block error taxonomy on malformed input.
    """
    check_tile_rows(tile_rows)
    if nfmax is None:
        nfmax = _nfmax_hint[0]
    bufs = [_native.as_u8(p) for p, _ in parts]
    comp = np.concatenate(bufs) if len(bufs) != 1 else bufs[0]
    blk_off = np.zeros(len(parts), np.int64)
    blk_len = np.array([b.shape[0] for b in bufs], np.int64)
    np.cumsum(blk_len[:-1], out=blk_off[1:])
    blk_store = np.array([0 if is_comp else 1 for _, is_comp in parts], np.uint8)

    nrows = -(-max(total_out, 1) // 128)
    ntiles = -(-nrows // tile_rows)
    # Pooled, uninitialized record arrays: the native planner stamps every slot the
    # kernel can read (fires < nf_tot).
    (f0, f1, f2, lit_init), seq_holder, seq = _record_arrays(ntiles, nfmax, RB, tile_rows)
    nf_tot = np.zeros(ntiles, np.int32)
    fper = np.zeros((ntiles, (nfmax + 31) // 32), np.int32)
    tot = np.zeros(1, np.int64)

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = _native._lib().tlz4_build_ring_plan2(
        _native._ptr(comp), comp.shape[0],
        blk_off.ctypes.data_as(i64p), blk_len.ctypes.data_as(i64p),
        blk_store.ctypes.data_as(u8p), len(parts),
        1 if independent else 0, total_out,
        tile_rows, WINDOW_ROWS, RB, nfmax,
        ntiles, RESOLVE_MIN_DEPTH, RESOLVE_RUNS, 0,  # 0: the native pool picks the thread count
        f0.ctypes.data_as(i32p), f1.ctypes.data_as(i32p),
        f2.ctypes.data_as(i32p),
        nf_tot.ctypes.data_as(i32p), fper.ctypes.data_as(i32p),
        lit_init.ctypes.data_as(u8p),
        tot.ctypes.data_as(i64p),
    )
    if rc == -102 and nfmax < NFMAX_RETRY:
        # record-capacity overflow: climb the retry ladder
        nxt = next(s for s in NFMAX_STEPS if s > nfmax)
        return build_ring_plan_parts(
            parts, total_out, independent=independent, tile_rows=tile_rows, nfmax=nxt
        )
    if rc in PLAN_OVERFLOW_CODES:
        return None, None
    if rc < 0:
        _native._raise_decompress_error(int(rc), int(tot[0]), total_out)
    if int(tot[0]) != total_out:
        raise block_errors.OutputTooSmall(int(tot[0]), total_out)
    plan = RingPlan(
        f0, f1, f2, nf_tot, fper, lit_init, total_out, ntiles,
        tile_rows, WINDOW_ROWS, RB, seq, seq_holder,
    )
    used = int(nf_tot.max()) if ntiles else 1
    _nfmax_hint[0] = next((s for s in _NFMAX_LADDER if s >= used), NFMAX_RETRY)
    return plan, comp


def build_ring_plan(comp, total_out: int, **kw) -> RingPlan | None:
    """Single raw-block form of :func:`build_ring_plan_parts`."""
    plan, _ = build_ring_plan_parts([(comp, True)], total_out, **kw)
    return plan


def ring_checksum_expected(data: bytes) -> int:
    """Host-side expected value of the kernel's checksum variant:
    sum over i of data[i] * ((i*131+7) & 0xFFFF), mod 2**32."""
    x = np.frombuffer(data, np.uint8).astype(np.uint64)
    i = np.arange(x.shape[0], dtype=np.uint64)
    w = (i * 131 + 7) & 0xFFFF
    return int((x * w).sum() & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------


def ring_engine_available() -> bool:
    """True when a CUDA card of compute capability 9.0 or newer is present
    (the kernel is built for sm_90a)."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability() >= (9, 0)


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: ``None`` means the CUDA card, and a
    CUDA device without a card of capability 9.0+ raises; nothing drops to
    the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not ring_engine_available():
            raise RuntimeError(
                "the ring decoder needs a CUDA card of compute capability 9.0+ "
                "(pass device='cpu' to run the plain PyTorch version)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def ring_plan_device_tensors(plan: RingPlan, device) -> tuple:
    """Upload a plan: (init, f0, f1, f2, nf_tot) on ``device``.

    For CUDA the arrays are first copied into pinned host memory, so the
    pooled numpy arrays are free again once this returns, and the copies to
    the card are ``non_blocking`` on the current stream. CPU tensors share
    memory with the plan's arrays."""
    plan.check_live()
    dev = torch.device(device)
    arrs = (plan.lit_init, plan.rec_f0, plan.rec_f1, plan.rec_f2, plan.nf_tot)
    if dev.type != "cuda":
        return tuple(torch.from_numpy(a) for a in arrs)
    return tuple(
        torch.from_numpy(a).pin_memory().to(dev, non_blocking=True) for a in arrs
    )


def _check_plan_tensors(init, f0, f1, f2, nf_tot, tile_rows: int) -> None:
    check_tile_rows(tile_rows)
    nt = nf_tot.shape[0]
    if nf_tot.dtype != torch.int32 or nf_tot.dim() != 1:
        raise ValueError("nf_tot must be a 1-D int32 tensor")
    for name, f in (("f0", f0), ("f1", f1), ("f2", f2)):
        if f.dtype != torch.int32 or f.dim() != 3 or f.shape[0] != nt or f.shape[2] != RB:
            raise ValueError(f"{name} must be int32 (ntiles={nt}, NF, {RB}), got {f.dtype} {tuple(f.shape)}")
        if f.shape != f0.shape:
            raise ValueError("f0, f1 and f2 must have one shape")
    if init.dtype != torch.uint8 or tuple(init.shape) != (nt * tile_rows, 128):
        raise ValueError(f"init must be uint8 ({nt * tile_rows}, 128), got {init.dtype} {tuple(init.shape)}")
    devs = {t.device for t in (init, f0, f1, f2, nf_tot)}
    if len(devs) != 1:
        raise ValueError(f"plan tensors lie on several devices: {devs}")


def ring_decode(init, f0, f1, f2, nf_tot, *, tile_rows: int = TILE_ROWS,
                ntot: int | None = None):
    """Run the ring decoder over one uploaded plan.

    Returns the decoded tiles as a (ntiles*tile_rows, 128) uint8 tensor and,
    with ``ntot`` (the decoded byte count), also the (1, 128) int32 lane
    partials of the position-weighted checksum (sum the lanes mod 2**32 and
    compare with :func:`ring_checksum_expected`). On CUDA tensors this
    launches the kernel K1 (K1b with ``ntot``) and nothing else; on CPU
    tensors it runs :func:`ring_decode_reference`.
    """
    _check_plan_tensors(init, f0, f1, f2, nf_tot, tile_rows)
    if init.device.type != "cuda":
        return ring_decode_reference(init, f0, f1, f2, nf_tot, tile_rows=tile_rows, ntot=ntot)
    from ._kernels import launch_ring_decode

    for name, t in (("init", init), ("f0", f0), ("f1", f1), ("f2", f2), ("nf_tot", nf_tot)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty(init.shape, dtype=torch.uint8, device=init.device)
    acc = None if ntot is None else torch.empty((1, 128), dtype=torch.int32, device=init.device)
    if nf_tot.shape[0]:
        with torch.cuda.device(init.device):
            launch_ring_decode(
                init, f0, f1, f2, nf_tot, out, tile_rows=tile_rows, ntot=ntot,
                acc=acc, stream=torch.cuda.current_stream().cuda_stream,
            )
        stats["kernel_launches"] += 1
        if acc is not None:
            stats["checksum_launches"] += 1
    elif acc is not None:
        acc.zero_()
    return out if acc is None else (out, acc)


def ring_decode_reference(init, f0, f1, f2, nf_tot, *, tile_rows: int = TILE_ROWS,
                          ntot: int | None = None):
    """The plain PyTorch version of the ring kernel: the executable spec,
    on whatever device the tensors lie. Follows the numpy simulator of the
    JAX package exactly: addresses clamped into the table, padding rows
    (row >= TR) masked, and each fire's scatter a masked add over records
    (exact because a fire writes each lane at most once)."""
    TR, WR = tile_rows, WINDOW_ROWS
    dev = init.device
    nt = nf_tot.shape[0]
    ring, flat = WR * 128, (WR + TR) * 128
    tbl = torch.zeros(flat, dtype=torch.int32, device=dev)
    out = torch.empty((nt * TR, 128), dtype=torch.uint8, device=dev)
    lane = torch.arange(128, dtype=torch.int32, device=dev)[None, :]
    for t, nft in enumerate(nf_tot.tolist()):
        if t:
            tbl[:ring] = tbl[TR * 128 : TR * 128 + ring].clone()
        tbl[ring:] = init[t * TR : (t + 1) * TR].reshape(-1)
        for j in range(nft):
            S, a1, a2 = f0[t, j][:, None], f1[t, j][:, None], f2[t, j][:, None]
            ph = a1 & 127
            P = ((a1 >> 7) & 127) + 1
            lo = (a1 >> 14) & 127
            ln = (a2 & 127) + 1
            row = (a2 >> 7) & (2 * TR - 1)
            y = tbl[(S + (lane + ph) % P).clamp(0, flat - 1).long()]
            mask = (row < TR) & (lane >= lo) & (lane < lo + ln)
            dst = (row.clamp(0, TR - 1) * 128 + lane).reshape(-1).long()
            contrib = torch.zeros(TR * 128, dtype=torch.int32, device=dev)
            contrib.index_add_(0, dst, torch.where(mask, y, 0).reshape(-1))
            cov = torch.zeros(TR * 128, dtype=torch.int32, device=dev)
            cov.index_add_(0, dst, mask.to(torch.int32).reshape(-1))
            tbl[ring:] = torch.where(cov > 0, contrib, tbl[ring:])
        out[t * TR : (t + 1) * TR] = tbl[ring:].reshape(TR, 128).to(torch.uint8)
    if ntot is None:
        return out
    idx = torch.arange(nt * TR * 128, dtype=torch.int64, device=dev)
    w = torch.where(idx < ntot, (idx * 131 + 7) & 0xFFFF, 0)
    part = (out.reshape(-1).to(torch.int64) * w).reshape(-1, 128).sum(0, keepdim=True)
    part = part & 0xFFFFFFFF
    return out, torch.where(part >= 2**31, part - 2**32, part).to(torch.int32)


def _to_bytes(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


def _host_decode_parts(parts, *, independent: bool, max_block_size: int | None) -> bytes:
    """Native host decode of a block list: the overflow fallback until the
    port has a device expansion engine. Linked blocks see the last 64 KiB of
    output as their dictionary."""
    out = bytearray()
    for payload, is_comp in parts:
        if is_comp:
            cap = _native.measure_block(payload)
            if max_block_size is not None and cap > max_block_size:
                raise block_errors.OutputTooSmall(cap, max_block_size)
            dic = b"" if independent else bytes(out[-65536:])
            out += _native.decompress_block(payload, cap, dic)
        else:
            out += _native.as_u8(payload).tobytes()
    stats["overflow_host_decodes"] += 1
    return bytes(out)


def _host_result(data: bytes, dev: torch.device, as_array: bool):
    if not as_array:
        return data
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)


def decode_block_ring(comp, total_out: int, *, device=None, as_array: bool = False):
    """Decode one LZ4 block through the ring kernel.

    Returns bytes, or a uint8 tensor on ``device`` with ``as_array``. A block
    whose plan overflows the static shape decodes on the native host decoder
    (counted in ``stats["overflow_host_decodes"]``). Raises the block error
    taxonomy on malformed input."""
    dev = resolve_device(device)
    plan = build_ring_plan(comp, total_out)
    if plan is None:
        return _host_result(
            _host_decode_parts([(comp, True)], independent=True, max_block_size=None),
            dev, as_array,
        )
    out = ring_decode(*ring_plan_device_tensors(plan, dev), tile_rows=plan.tile_rows)
    flat = out.reshape(-1)[: plan.total_out]
    return flat if as_array else _to_bytes(flat)


def dispatch_parts_ring(parts, *, independent: bool = False,
                        max_block_size: int | None = None, device=None):
    """Build the plan and launch the ring kernel for a frame body without
    synchronizing: returns (flat uint8 tensor on ``device``, total_out) —
    bytes past ``total_out`` are padding — or None when the plan overflows
    its static shape."""
    dev = resolve_device(device)
    total = 0
    for payload, is_comp in parts:
        if is_comp:
            n_out = _native.measure_block(payload)
            if max_block_size is not None and n_out > max_block_size:
                raise block_errors.OutputTooSmall(n_out, max_block_size)
            total += n_out
        else:
            total += len(payload)
    if total == 0:
        return torch.empty(0, dtype=torch.uint8, device=dev), 0
    plan, _ = build_ring_plan_parts(parts, total, independent=independent)
    if plan is None:
        return None
    out = ring_decode(*ring_plan_device_tensors(plan, dev), tile_rows=plan.tile_rows)
    return out.reshape(-1), plan.total_out


def decode_parts_ring(parts, *, independent: bool = False,
                      max_block_size: int | None = None, device=None,
                      as_array: bool = False):
    """Decode a whole frame body through the ring kernel.

    ``parts`` is the frame's block list in order: (payload, is_compressed)
    pairs; linked-mode window references resolve through the kernel's 64 KiB
    output ring. Returns bytes (or a device tensor with ``as_array``). A body
    whose plan overflows decodes on the native host decoder (counted in
    ``stats["overflow_host_decodes"]``). Raises the block error taxonomy on
    malformed input."""
    dev = resolve_device(device)
    r = dispatch_parts_ring(parts, independent=independent,
                            max_block_size=max_block_size, device=dev)
    if r is None:
        return _host_result(
            _host_decode_parts(parts, independent=independent, max_block_size=max_block_size),
            dev, as_array,
        )
    out, total = r
    return out[:total] if as_array else _to_bytes(out[:total])
