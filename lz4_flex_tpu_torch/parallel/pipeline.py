"""Sharded block pipelines: frame blocks data-parallel over a mesh.

The JAX package's ``parallel/pipeline.py`` on the port's mesh, a list of
torch devices (parallel/mesh.py); entry i of the global mesh takes the i-th
contiguous span of blocks, and the routing follows the global entry count
(``len(mesh)`` times the processes) as JAX's follows the mesh's device
count.

Across processes (a ``torch.distributed`` group of W > 1): each process
stages, plans and launches only the groups of its own entries; then every
rank agrees on the outcome (``mesh.agree``: one status word a rank, so an
overflow or a malformed block on one rank sends every rank the same way),
and the results are gathered as host copies (``mesh.all_gather_arrays``):
on encode the 4-byte compressed length of each block, then the payloads;
on decode the decoded sizes, then the bytes. Every rank returns the same
list in frame order.

Encode (``encode_blocks_sharded``): frame blocks are independent compression
problems even in linked mode (each block's 64 KiB dictionary is a slice of
the input, known upfront). On a one-entry mesh, chunk-scale blocks (at
least ``_CHUNK_C`` bytes, so 1, 4 and 8 MiB frame blocks) go through the
hybrid encoder one block at a time; on a larger mesh, blocks above
``_CHUNK_C`` go through ``compress_block_device`` one at a time. So a frame
of 1-8 MiB blocks has other bytes at N = 1 than at N > 1, as in JAX. Smaller
blocks (64 and 256 KiB) are staged as rows, dictionary ++ data, padded to a
multiple of the mesh size; each entry encodes its span of rows with the
all-device encoder, ``_ENCODE_ROWS`` rows to a dispatch (``_encode_staged``),
and every payload is checked by the native verify walk.

Decode (``decode_blocks_sharded``): each entry's span of independent blocks
becomes one ring plan, all built at once on the host pool
(``stage_ring_groups``); the plans of the entries that share a card are
padded to one shape and decoded by one launch of the grouped ring kernel
K1c, one CTA per plan (``decode_blocks_sharded_ring``). When a plan
overflows its static shape the resident decoder takes the frame
(``_decode_blocks_sharded_resident``).

The batched device-resident decode ``_decode_batch`` (under
``LZ4Codec.decode_step``, ``roundtrip_step_sharded`` and the overflow
decode) is the JAX package's ``_decode_batch``: its ``vmap`` over rows is
one batched program over the rows (``ops.decode.decode_resident_rows``): on
the card one launch of the resident kernel, on the CPU torch ops whose loops
run while any row's data says and leave a finished row as it stands.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native as _native
from ..block import compress_with_dict
from ..block import errors as block_errors
from ..ops import packing
from ..spec.constants import WINDOW_SIZE, get_maximum_output_size
from ..utils import trace
from .executor import plan_executor
from .mesh import (
    MeshLayout,
    agree,
    all_gather_arrays,
    codec_mesh,
    mesh_layout,
    process_rank_and_world,
)

# Rows per encode dispatch. On the card a dispatch is one launch of the
# encode kernel (a cluster of CTAs a row; its scratch ~85 bytes a position,
# so 32 rows of 256 KiB blocks take ~1 GB). The plain version, the torch ops
# CPU rows take, is ~1,700 kernel launches a dispatch whatever its row count,
# so rows are batched; its temporaries take ~250 bytes a position, so 32 rows
# of 256 KiB blocks (393,216 positions each) stay near 3 GB of device memory.
# encode_blocks uploads, encodes and reads back one such group at a time, so
# a frame's device memory is bounded by this constant, not by its input.
_ENCODE_ROWS = 32

# Positions per resident-decode dispatch (``_decode_batch``): rows times the
# larger of their payload width and output size. A dispatch's temporaries
# scale with its positions, so a batch past this is decoded in groups of
# rows, in order (256 rows of 64 KiB blocks, 4 of 4 MiB); the bytes do not
# depend on the split.
_DECODE_POSITIONS = 1 << 24


def fetch_global(x, *, force_replicate: bool = False) -> np.ndarray:
    """The global value of a tensor, or of a per-entry list of tensors
    (concatenated along their first axis in mesh order), as one numpy array.

    In a process group of W > 1 processes, ``x`` is this process's pieces of
    an array sharded over the processes in rank order: every process's
    pieces are gathered (host copies, ``mesh.all_gather_arrays``) and every
    rank returns the same global array, as JAX's does. With one process,
    ``force_replicate`` first gathers every piece onto the first piece's
    device and reads it from there."""
    parts = [x] if isinstance(x, torch.Tensor) else list(x)
    if process_rank_and_world()[1] > 1:
        return np.concatenate(all_gather_arrays(np.concatenate([p.cpu().numpy() for p in parts])))
    if force_replicate:
        home = parts[0].device
        return torch.cat([p.to(home) for p in parts]).cpu().numpy()
    return np.concatenate([p.cpu().numpy() for p in parts])


def stage_blocks(data, block_size: int, *, linked: bool = False, pad_rows_to: int = 1,
                 start: int = 0):
    """Split ``data[start:]`` into frame blocks staged as a dense (B, D+S)
    uint8 array plus per-block (dict_len, total_len) vectors and the block
    count.

    In linked mode each row is prefixed with the previous 64 KiB of input
    (its dictionary); ``data[:start]`` is window context only (the carry
    from blocks a streaming encoder already wrote), so block 0's dictionary
    is its tail. ``pad_rows_to`` pads the batch with empty rows so that B
    divides the mesh size."""
    buf = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    n = buf.shape[0] - start
    nblocks = max(1, -(-n // block_size))
    b_pad = -(-nblocks // pad_rows_to) * pad_rows_to
    w = WINDOW_SIZE if linked else 0
    width = packing.size_bucket(w + block_size + 4)
    with trace.span("enc.stage"):
        rows = np.zeros((b_pad, width), dtype=np.uint8)
        dlen = np.zeros(b_pad, dtype=np.int32)
        tlen = np.zeros(b_pad, dtype=np.int32)
        for i in range(nblocks):
            s = start + i * block_size
            blk = buf[s : s + block_size]
            d = min(w, s)
            rows[i, : d + blk.shape[0]] = buf[s - d : s + blk.shape[0]]
            dlen[i] = d
            tlen[i] = d + blk.shape[0]
    return rows, dlen, tlen, nblocks


def _stage_own_rows(staged, block_size: int, *, linked: bool, start: int, layout: MeshLayout,
                    local: int):
    """The rows of ``stage_blocks(staged, block_size, linked=linked,
    pad_rows_to=layout.total, start=start)`` that this process's ``local``
    entries hold, staged alone: (rows, dlen, tlen, nblocks, per), nblocks
    the frame's block count and per the rows an entry. A rank whose entries
    hold padding rows only stages one empty block (its payload is dropped)."""
    nblocks = max(1, -(-(len(staged) - start) // block_size))
    per = -(-nblocks // layout.total)
    s0, s1 = (min(len(staged), start + min(nblocks, g * per) * block_size)
              for g in (layout.first, layout.first + local))
    w0 = min(WINDOW_SIZE, s0) if linked else 0
    rows, dlen, tlen, _ = stage_blocks(staged[s0 - w0 : s1], block_size, linked=linked,
                                       pad_rows_to=per * local, start=w0)
    return rows, dlen, tlen, nblocks, per


def _gather_blocks(blocks: list[bytes], layout: MeshLayout, counts) -> list[bytes]:
    """Every rank's blocks, in rank order: their 4-byte sizes, then their
    bytes (each rank's padded to the longest). ``counts`` are the ranks'
    block counts, which every rank knows."""
    if layout.world == 1:
        return blocks
    sizes = all_gather_arrays(np.array([len(b) for b in blocks], np.int32), counts)
    datas = all_gather_arrays(np.frombuffer(b"".join(blocks), np.uint8),
                              [int(s.sum(dtype=np.int64)) for s in sizes])
    out = []
    for size, flat in zip(sizes, datas):
        ends = np.cumsum(size, dtype=np.int64)
        out += [flat[e - k : e].tobytes() for k, e in zip(size, ends)]
    return out


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
            with trace.span("enc.wait"):
                done.synchronize()
        with trace.span("enc.unpack"):
            out, total = out.numpy(), total.numpy()
            payloads.extend(out[i, : total[i]].tobytes() for i in range(out.shape[0]))

    for g in range(0, rows.shape[0], _ENCODE_ROWS):
        with trace.span("enc.launch"):
            sl = slice(g, g + _ENCODE_ROWS)
            r = put(rows[sl])
            out, total = encode_chunk_core(r, r.view(torch.int32), put(dlen[sl]), put(tlen[sl]),
                                           **geo)
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


def _encode_each_block(buf: bytes, block_size: int, linked: bool, window: bytes, encode,
                       layout: MeshLayout):
    """``encode(block, dictionary)`` on each block of ``buf`` in turn, a
    linked block's dictionary being the 64 KiB of input before it
    (``window`` before block 0). Across W processes each encodes its
    contiguous W-th of the blocks, and the payloads are gathered."""
    nblocks = max(1, -(-len(buf) // block_size))
    per = -(-nblocks // layout.world)
    spans = [(min(nblocks, r * per), min(nblocks, (r + 1) * per)) for r in range(layout.world)]
    lo, hi = spans[layout.rank]
    if linked:
        window = (window + buf[max(0, lo * block_size - WINDOW_SIZE) : lo * block_size])[-WINDOW_SIZE:]

    def encode_own():
        nonlocal window
        payloads = []
        for i in range(lo, hi):
            blk = buf[i * block_size : (i + 1) * block_size]
            payloads.append(encode(blk, window))
            if linked:
                window = (window + blk)[-WINDOW_SIZE:]
        return payloads

    payloads = _gather_blocks(agree(encode_own, layout), layout, [b - a for a, b in spans])
    lens = [len(buf[i * block_size : (i + 1) * block_size]) for i in range(nblocks)]
    return payloads, lens


def encode_blocks_sharded(data, block_size: int, *, linked: bool = False, mesh=None,
                          verify: bool = True, carry: bytes = b""):
    """Compress ``data`` as frame blocks of ``block_size`` bytes,
    data-parallel over the mesh (``None``: every visible card).

    Returns (payloads: list[bytes], block_lens: list[int]) in frame order;
    the frame layer wraps the payloads in BlockInfo words and checksums.
    ``carry`` is the linked-mode window context before ``data`` (the tail
    of blocks a streaming encoder already wrote); at most 64 KiB of it is
    used.

    The routing is the JAX package's (see the module docstring). With
    ``verify`` (the default) every payload of the all-device encoder goes
    through the native verify walk, and one that fails is replaced by the
    host encoder's bytes, counted in ``ops.encode.stats["verify_fallbacks"]``
    (the guard against fingerprint collisions); the hybrid encoder's output
    is spec-valid by construction."""
    mesh = codec_mesh(mesh)
    return _encode_blocks_sharded(data, block_size, linked, mesh, mesh_layout(mesh), verify, carry)


def _encode_blocks_sharded(data, block_size: int, linked: bool, mesh, layout: MeshLayout,
                           verify: bool, carry: bytes):
    """:func:`encode_blocks_sharded` on this process's entries ``mesh`` of
    the global mesh that ``layout`` describes."""
    from ..ops import encode as E

    window = bytes(carry)[-WINDOW_SIZE:] if linked else b""
    buf = bytes(data)
    if layout.total == 1 and block_size >= E._CHUNK_C:
        return _encode_each_block(buf, block_size, linked, window, lambda blk, d: (
            E.compress_block_hybrid(blk, ext_dict=d, device=mesh[0])), layout)
    if block_size > E._CHUNK_C:
        # Blocks above the fixed chunk width: the chunked all-device encoder
        # one block at a time (its shapes stay fixed), on the mesh's first
        # entry as JAX's runs on the default device.
        return _encode_each_block(buf, block_size, linked, window, lambda blk, d: (
            E.compress_block_device(blk, ext_dict=d, verify=verify, device=mesh[0])), layout)

    rows, dlen, tlen, nblocks, per = _stage_own_rows(
        window + buf, block_size, linked=linked, start=len(window), layout=layout, local=len(mesh))
    geo = encode_geometry(rows.shape[1], block_size)
    first_row = layout.first * per  # global index of this process's row 0

    def encode_own():
        payloads = []
        for d, dev in enumerate(mesh):
            sl = slice(d * per, (d + 1) * per)
            payloads += _encode_staged(rows[sl], dlen[sl], tlen[sl], dev, geo)
        if verify:
            with trace.span("enc.verify"):
                for i in range(min(len(payloads), nblocks - first_row)):
                    d, n = int(dlen[i]), int(tlen[i])
                    if not _native.verify_block(payloads[i], rows[i, d:n], rows[i, :d]):
                        # a fingerprint collision overstated a match
                        E.stats["verify_fallbacks"] += 1
                        payloads[i] = compress_with_dict(rows[i, d:n], rows[i, :d])
        return payloads

    payloads = _gather_blocks(agree(encode_own, layout), layout, [per * len(mesh)] * layout.world)
    del payloads[nblocks:]
    lens = [min(block_size, len(buf) - i * block_size) for i in range(nblocks)]
    return payloads, lens


def encode_blocks(data, block_size: int, *, linked: bool = False, carry: bytes = b"",
                  device=None, mesh=None, verify: bool = True):
    """:func:`encode_blocks_sharded` on ``mesh``, or on the one device that
    ``device`` names (``None``: the CUDA card), plus the linked-mode window
    after ``data`` for the next call of a streaming encoder: returns
    (payloads, block_lens, window), the window empty unless ``linked``."""
    from ..ops.ringdecode import resolve_device

    if mesh is None:  # one device of this process, whatever group runs: no gathers
        mesh = [resolve_device(device)]
        layout = MeshLayout(0, 1, 0, 1)
    else:
        mesh = codec_mesh(mesh)
        layout = mesh_layout(mesh)
    payloads, lens = _encode_blocks_sharded(data, block_size, linked, mesh, layout, verify, carry)
    if not linked:
        return payloads, lens, b""
    return payloads, lens, (bytes(carry)[-WINDOW_SIZE:] + bytes(data[-WINDOW_SIZE:]))[-WINDOW_SIZE:]


def _decode_batch(rows, clen, *, out_pad, nseq_pad, capacity=None):
    """Decode independent blocks on ``rows``' device: (B, C) uint8 payload
    rows, each padded with at least one zero byte, and their (B,) lengths ->
    ((B, out_pad) uint8 outputs, (B,) int32 lengths, (B, 5) bool error
    flags), the JAX package's ``vmap`` of the resident decode as one batched
    program (``ops.decode.decode_resident_rows``: on the card one kernel
    launch) a group of rows, groups of at most ``_DECODE_POSITIONS``
    positions in order; ``capacity`` (default
    ``out_pad``) is the output size past which a row flags
    output_too_small."""
    from ..ops.decode import decode_resident_rows

    if rows.shape[0] == 0:
        dev = rows.device
        return (torch.zeros((0, out_pad), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((0, 5), dtype=torch.bool, device=dev))
    per = max(1, _DECODE_POSITIONS // max(out_pad, rows.shape[1]))
    parts = []
    for i in range(0, rows.shape[0], per):
        with trace.span("resident.step"):
            parts.append(decode_resident_rows(rows[i : i + per], clen[i : i + per],
                                              out_pad=out_pad, nseq_pad=nseq_pad,
                                              capacity=capacity))
    return parts[0] if len(parts) == 1 else tuple(torch.cat(t) for t in zip(*parts))


def roundtrip_step_sharded(data, block_size: int, *, mesh=None):
    """One full sharded codec step: each mesh entry encodes its span of
    staged independent blocks and decodes them back (``_decode_batch``),
    then the compressed lengths are gathered in mesh order (the frame
    assembly plan), the assembly offsets are their exclusive cumsum, and
    the roundtrip flag is the minimum of the entries' flags.

    Returns (comp_payload_rows (B, C) uint8, comp_lens (B,) int32,
    assembly_offsets (B,) int32, ok () bool), on the mesh's first entry.
    Across processes each encodes and decodes its own entries' rows, and
    the rows, lengths and flags are gathered, so every rank returns the
    global result."""
    mesh = codec_mesh(mesh)
    layout = mesh_layout(mesh)
    rows, dlen, tlen, _, per = _stage_own_rows(data, block_size, linked=False, start=0,
                                               layout=layout, local=len(mesh))
    width = rows.shape[1]
    geo = encode_geometry(width, block_size)
    out_pad = packing.size_bucket(block_size)
    dec_nseq_pad = packing.size_bucket(max(8, geo["comp_pad"] // 3 + 2), minimum=256)

    def step_own():
        comps, totals, oks = [], [], []
        for d, dev in enumerate(mesh):
            sl = slice(d * per, (d + 1) * per)
            r = torch.from_numpy(rows[sl]).to(dev)
            dl, tl = torch.from_numpy(dlen[sl]).to(dev), torch.from_numpy(tlen[sl]).to(dev)
            comp, total = _encode_batch(r, r.view(torch.int32), dl, tl, **geo)
            out, out_total, _errs = _decode_batch(comp, total, out_pad=out_pad,
                                                  nseq_pad=dec_nseq_pad)
            blen = tl - dl
            w = min(out_pad, width)
            mask = torch.arange(w, device=dev)[None, :] < blen[:, None]
            ok = (torch.where(mask, out[:, :w] == r[:, :w], True).all()
                  & (out_total == blen).all())
            comps.append(comp)
            totals.append(total)
            oks.append(ok[None])
        return comps, totals, oks

    comps, totals, oks = agree(step_own, layout)
    home = mesh[0]
    if layout.world == 1:
        comp, all_lens, ok = (torch.cat([t.to(home) for t in ts]) for ts in (comps, totals, oks))
    else:
        comp, all_lens, ok = (torch.from_numpy(fetch_global(ts)).to(home)
                              for ts in (comps, totals, oks))
    offsets = torch.cumsum(all_lens, 0, dtype=torch.int32) - all_lens
    return comp, all_lens, offsets, ok.all()


def _stage_ring_group(group, block_size: int, nthreads: int):
    """Size walk, plan build and copy-out for one mesh entry's span of
    independent block payloads.

    Returns (arrs, sizes): arrs the plan's (nf_tot, init, f0, f1, f2) as
    numpy arrays that no pool owns, its record fields cut to the fires it
    uses, or () for an all-empty span, and sizes the blocks' decoded sizes;
    or None when the span does not fit the static plan shape. Runs on the
    plan executor: the native calls release the GIL, so the groups build
    concurrently."""
    from ..ops import ringdecode as RD

    parts = [(np.frombuffer(p, np.uint8), True) for p in group]
    sizes = RD.part_sizes(parts, block_size)
    total = int(sum(sizes))
    if total == 0:
        return (), sizes
    plan, _ = RD.build_ring_plan_parts(parts, total, independent=True, nthreads=nthreads)
    if plan is None:
        return None
    # Copy the record fields out, cut to the fires this plan executes
    # (typical plans use about half the ladder's allocation). .copy(), NOT
    # np.ascontiguousarray: a sliced view with a size-1 leading dimension
    # counts as contiguous, so ascontiguousarray would return the pool's own
    # array, which this thread's build after next overwrites.
    nf_used = min(max(8, -(-int(plan.nf_tot.max()) // 8) * 8), plan.rec_f0.shape[1])
    arrs = (plan.nf_tot.copy(), plan.lit_init.copy(),
            *(f[:, :nf_used].copy() for f in (plan.rec_f0, plan.rec_f1, plan.rec_f2)))
    return arrs, sizes


def stage_ring_groups(groups, block_size: int):
    """Build every group's ring plan concurrently on the plan executor.

    Returns one :func:`_stage_ring_group` result a group (None for an empty
    group), or None when any group overflows the static plan shape. With
    more than one live group each build runs on one lane (``nthreads=1``:
    the native pool's job lock would serialise concurrent multi-lane
    builds) and the executor runs the groups in parallel, so the plan wall
    is about the slowest group's build, not the sum."""
    live = sum(1 for g in groups if g)
    if live <= 1:
        staged = [_stage_ring_group(g, block_size, 0) if g else None for g in groups]
    else:
        ex = plan_executor()
        futs = [ex.submit(_stage_ring_group, g, block_size, 1) if g else None for g in groups]
        staged = [f.result() if f is not None else None for f in futs]
    if any(g and s is None for g, s in zip(groups, staged)):
        return None
    return staged


def stack_ring_plans(plans, tile_rows: int):
    """Pad plans, each as its (nf_tot, init, f0, f1, f2) numpy arrays, to one
    (ntiles, nf) shape and stack them: (init, f0, f1, f2, nf_tot), the
    arguments of ``ring_decode_grouped`` in its order. Padding tiles and
    fires are zeros: a tile of no fire emits its zero literal image, which
    no caller reads."""
    from ..ops.ringdecode import RB

    nt = max(a[0].shape[0] for a in plans)
    nf = max(a[2].shape[1] for a in plans)
    g = len(plans)
    nft = np.zeros((g, nt), np.int32)
    init = np.zeros((g, nt * tile_rows, 128), np.uint8)
    fs = [np.zeros((g, nt, nf, RB), np.int32) for _ in range(3)]
    for k, (a_nft, a_init, *a_fs) in enumerate(plans):
        dnt, dnf = a_nft.shape[0], a_fs[0].shape[1]
        nft[k, :dnt] = a_nft
        init[k, : a_init.shape[0]] = a_init
        for f, a in zip(fs, a_fs):
            f[k, :dnt, :dnf] = a
    return init, *fs, nft


def decode_blocks_sharded_ring(payloads, block_size: int, *, mesh=None):
    """Ring-engine mesh decode of independent compressed block payloads.

    The blocks split into one contiguous group a global mesh entry; this
    process builds its entries' plans at once (:func:`stage_ring_groups`).
    The plans of the entries that share a device are padded to one (ntiles,
    nf) shape, stacked and uploaded through pinned memory, and decoded by
    one launch of the grouped ring kernel K1c (``ring_decode_grouped``: one
    CTA per plan; its plain version on CPU tensors). Each device's output
    is read once and cut into blocks by their sizes; across processes the
    blocks are then gathered. Returns list[bytes], or None when any group
    of any process overflows the static plan shape (the caller takes the
    resident decoder)."""
    mesh = codec_mesh(mesh)
    return _decode_ring(payloads, block_size, mesh, mesh_layout(mesh))


def _decode_ring(payloads, block_size: int, mesh, layout: MeshLayout):
    """:func:`decode_blocks_sharded_ring` on this process's entries ``mesh``
    of the global mesh that ``layout`` describes."""
    from ..ops import ringdecode as RD

    nblocks = len(payloads)
    per = -(-nblocks // layout.total) if nblocks else 1
    groups = [payloads[g * per : (g + 1) * per] for g in layout.entries(len(mesh))]
    staged = agree(lambda: stage_ring_groups(groups, block_size), layout)
    if staged is None:
        return None

    tr = RD.TILE_ROWS
    launched = []  # (group indices, output tensor) of each physical device
    for dev in dict.fromkeys(mesh):  # each physical device once, in mesh order
        idx = [d for d, m in enumerate(mesh) if m == dev and staged[d] and staged[d][0]]
        if not idx:
            continue
        stacked = stack_ring_plans([staged[d][0] for d in idx], tr)
        if dev.type == "cuda":
            up = [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True) for a in stacked]
        else:
            up = [torch.from_numpy(a) for a in stacked]
        launched.append((idx, RD.ring_decode_grouped(*up, tile_rows=tr)))
    decoded = {}  # group index -> flat uint8 numpy output
    for idx, out in launched:  # every device's launch is queued before the first read
        out = out.cpu().numpy()
        for k, d in enumerate(idx):
            decoded[d] = out[k].reshape(-1)

    blocks: list[bytes] = []
    for d, s in enumerate(staged):
        if s is None:
            continue
        flat, pos = decoded.get(d), 0
        for sz in s[1]:
            blocks.append(b"" if flat is None else flat[pos : pos + sz].tobytes())
            pos += sz
    span = per * len(mesh)  # blocks a process
    return _gather_blocks(blocks, layout, [len(payloads[r * span : (r + 1) * span])
                                           for r in range(layout.world)])


def decode_blocks_sharded(payloads, block_size: int, *, mesh=None):
    """Decompress independent-mode compressed block payloads data-parallel
    over the mesh (``None``: every visible card): the ring engine's grouped
    launch when every group's plan fits its static shape, the resident
    decoder otherwise (counted in
    ``ops.ringdecode.stats["overflow_sharded_decodes"]``). Returns the
    blocks' bytes in order; raises the block error taxonomy on malformed
    input."""
    from ..ops.ringdecode import stats

    mesh = codec_mesh(mesh)
    layout = mesh_layout(mesh)
    ring = _decode_ring(payloads, block_size, mesh, layout)
    if ring is not None:
        return ring
    stats["overflow_sharded_decodes"] += 1
    return _decode_resident(payloads, block_size, mesh, layout)


def _decode_blocks_sharded_resident(payloads, block_size: int, *, mesh=None):
    """The resident-decoder mesh decode, the fallback when a ring plan
    overflows (the JAX package's ``_decode_blocks_sharded_xla``): payload
    rows padded to a multiple of the global mesh size, each entry's span
    decoded by ``_decode_batch`` on its device, the flags, lengths and
    outputs gathered across processes, and the error flags of the first bad
    block raised, on every rank, as the block error they name."""
    mesh = codec_mesh(mesh)
    return _decode_resident(payloads, block_size, mesh, mesh_layout(mesh))


def _decode_resident(payloads, block_size: int, mesh, layout: MeshLayout):
    """:func:`_decode_blocks_sharded_resident` on this process's entries
    ``mesh`` of the global mesh that ``layout`` describes."""
    nblocks = len(payloads)
    per = max(1, -(-nblocks // layout.total))
    # +1: the device parser needs at least one zero pad byte after each
    # payload to detect blocks truncated mid-LSIC run.
    width = packing.size_bucket(max(max((len(p) for p in payloads), default=4), 4) + 1)
    first = layout.first * per  # global index of this process's row 0
    rows = np.zeros((per * len(mesh), width), dtype=np.uint8)
    clen = np.ones(rows.shape[0], dtype=np.int32)  # padding rows: one empty-block token
    for i, p in enumerate(payloads[first : first + rows.shape[0]]):
        rows[i, : len(p)] = np.frombuffer(p, np.uint8)
        clen[i] = len(p)
    out_pad = packing.size_bucket(block_size)
    nseq_pad = packing.size_bucket(max(8, width // 3 + 2), minimum=256)

    def decode_own():
        outs, totals, errs = [], [], []
        for d, dev in enumerate(mesh):
            sl = slice(d * per, (d + 1) * per)
            o, t, e = _decode_batch(torch.from_numpy(rows[sl]).to(dev),
                                    torch.from_numpy(clen[sl]).to(dev),
                                    out_pad=out_pad, nseq_pad=nseq_pad, capacity=block_size)
            outs.append(o)
            totals.append(t)
            errs.append(e)
        return outs, totals, errs

    outs, totals, errs = agree(decode_own, layout)
    errs_h = fetch_global(errs)[:nblocks]
    total_h = fetch_global(totals)
    if errs_h.any():
        bad = int(np.argwhere(errs_h.any(axis=1))[0][0])
        flags = errs_h[bad]
        if flags[1]:
            raise block_errors.ExpectedAnotherByte()
        if flags[0]:
            raise block_errors.LiteralOutOfBounds()
        if flags[2]:
            raise block_errors.OffsetZero()
        if flags[3]:
            raise block_errors.OffsetOutOfBounds()
        if flags[4]:
            raise block_errors.OutputTooSmall(int(total_h[bad]), block_size)
        raise block_errors.ExpectedAnotherByte()
    out_h = fetch_global(outs)
    return [out_h[i, : total_h[i]].tobytes() for i in range(nblocks)]
