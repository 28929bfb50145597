"""The ring kernel (one plan, and grouped: K1c), the resident decode kernel
and the probes' kernels on the card against their plain PyTorch versions,
the fallback decode engines
and the all-device encoder (torch ops) on the card against their CPU run,
the mesh pipelines on one card against their CPU run, and the entry points
with their default device.
These tests need a CUDA card of
compute capability 9.0+ and skip without one; they import no JAX, so on a
machine without it they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import io
import time

import numpy as np
import pytest
import torch

from lz4_flex_tpu_torch import frame, native
from lz4_flex_tpu_torch.experiments import fire_probe as FP
from lz4_flex_tpu_torch.experiments import gather_probe as GP
from lz4_flex_tpu_torch.frame import decompress_frame_device
from lz4_flex_tpu_torch.models import LZ4Codec
from lz4_flex_tpu_torch.ops import decode as D
from lz4_flex_tpu_torch.ops import encode as E
from lz4_flex_tpu_torch.ops import expand2 as X
from lz4_flex_tpu_torch.ops import packing
from lz4_flex_tpu_torch.ops import parse as P
from lz4_flex_tpu_torch.ops import ringdecode as R
from lz4_flex_tpu_torch.ops.decode import decode_block_device
from lz4_flex_tpu_torch.ops.sequences import parse_sequences_host
from lz4_flex_tpu_torch.utils import trace

from .torch_inputs import block_inputs, block_rows, wild_plan_fields, word_soup


def block_compress_with_dict(data: bytes, dic: bytes) -> bytes:
    """A block whose matches reach into ``dic``: the native encoder's table
    carried over the dictionary (no JAX on the card's machine)."""
    table = native.new_table()
    native.compress_block(dic, table=table)
    return native.compress_block(dic + data, input_pos=len(dic), input_stream_offset=0, table=table)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not R.ring_engine_available():
        pytest.skip("needs a CUDA card of compute capability 9.0+")
    return torch.device("cuda")


@pytest.mark.parametrize("tile_rows", [64, 256, 512])
def test_kernel_equals_reference(card, tile_rows):
    for name, data in block_inputs().items():
        plan = R.build_ring_plan(native.compress_block(data), len(data), tile_rows=tile_rows)
        ts = R.ring_plan_device_tensors(plan, card)
        before = R.stats["kernel_launches"]
        out, acc = R.ring_decode(*ts, tile_rows=tile_rows, ntot=len(data))
        assert R.stats["kernel_launches"] == before + 1
        ref, ref_acc = R.ring_decode_reference(*ts, tile_rows=tile_rows, ntot=len(data))
        assert torch.equal(out, ref), name
        assert torch.equal(acc, ref_acc), name
        assert out.reshape(-1)[: len(data)].cpu().numpy().tobytes() == data, name


@pytest.mark.parametrize("tile_rows", [64, 256, 512])
def test_kernel_equals_reference_on_wild_records(card, tile_rows):
    # lo+len > 128, addresses off both ends of the table, garbage bits and
    # garbage padding fields: no lane of another row and no byte outside the
    # table may be touched.
    plan = R.RingPlan.from_arrays(**wild_plan_fields(tile_rows))
    ts = R.ring_plan_device_tensors(plan, card)
    out, acc = R.ring_decode(*ts, tile_rows=tile_rows, ntot=plan.total_out)
    ref, ref_acc = R.ring_decode_reference(*ts, tile_rows=tile_rows, ntot=plan.total_out)
    assert torch.equal(out, ref)
    assert torch.equal(acc, ref_acc)
    assert torch.equal(R.ring_decode(*ts, tile_rows=tile_rows), ref)


def test_kernel_rejects_bad_tensors(card):
    data = word_soup(50000)
    plan = R.build_ring_plan(native.compress_block(data), len(data))
    init, f0, f1, f2, nft = R.ring_plan_device_tensors(plan, card)
    with pytest.raises(ValueError):
        R.ring_decode(init, f0.cpu(), f1, f2, nft, tile_rows=plan.tile_rows)
    with pytest.raises(ValueError):
        R.ring_decode(init, f0.transpose(1, 2).contiguous().transpose(1, 2), f1, f2, nft,
                      tile_rows=plan.tile_rows)


def test_entry_points_default_to_the_card(card):
    data = word_soup(400000, seed=3)
    comp = native.compress_block(data)
    before = R.stats["kernel_launches"]
    assert decode_block_device(comp, len(data)) == data
    arr = decode_block_device(comp, len(data), as_array=True)
    assert arr.device.type == "cuda" and arr.cpu().numpy().tobytes() == data
    assert R.stats["kernel_launches"] == before + 2
    assert decompress_frame_device(b"") == b""


def test_kernel_rejects_misaligned_tensors(card):
    data = word_soup(50000)
    plan = R.build_ring_plan(native.compress_block(data), len(data))
    init, f0, f1, f2, nft = R.ring_plan_device_tensors(plan, card)
    shifted = torch.empty(f0.numel() + 1, dtype=torch.int32, device=card)[1:].view(f0.shape)
    shifted.copy_(f0)
    with pytest.raises(ValueError, match="aligned"):
        R.ring_decode(init, shifted, f1, f2, nft, tile_rows=plan.tile_rows)


def _slots(tile_rows: int) -> int:
    """Slots of K1's circular table: the window's, the tile's and a free one."""
    return 512 // tile_rows + 2


def _check_plan(card, plan, data=None):
    ts = R.ring_plan_device_tensors(plan, card)
    tr, n = plan.tile_rows, plan.total_out
    out, acc = R.ring_decode(*ts, tile_rows=tr, ntot=n)
    ref, ref_acc = R.ring_decode_reference(*ts, tile_rows=tr, ntot=n)
    assert torch.equal(out, ref)
    assert torch.equal(acc, ref_acc)
    assert torch.equal(R.ring_decode(*ts, tile_rows=tr), ref)
    if data is not None:
        assert out.reshape(-1)[:n].cpu().numpy().tobytes() == data


@pytest.mark.parametrize("tile_rows", [64, 128, 256, 512])
def test_kernel_wraps_the_circular_table_many_times(card, tile_rows):
    data = word_soup(6 * tile_rows * 128 * _slots(tile_rows) + 999, seed=21)
    plan = R.build_ring_plan(native.compress_block(data), len(data), tile_rows=tile_rows)
    assert plan.ntiles > 5 * _slots(tile_rows)
    _check_plan(card, plan, data)


@pytest.mark.parametrize("tile_rows", [64, 128, 256, 512])
def test_kernel_one_tile_and_ragged_tile_counts(card, tile_rows):
    tile = tile_rows * 128
    for ntiles in (1, 2 * _slots(tile_rows) + 1, 3 * _slots(tile_rows) - 1):
        data = (word_soup(ntiles * tile, seed=ntiles) + b"ab" * tile)[: ntiles * tile - 77]
        plan = R.build_ring_plan(native.compress_block(data), len(data), tile_rows=tile_rows)
        assert plan.ntiles == ntiles
        _check_plan(card, plan, data)


@pytest.mark.parametrize("tile_rows", [64, 256, 512])
def test_fire_probe_exact_variants_equal_reference(card, tile_rows):
    inputs = block_inputs()
    for name in ("periodic_ring_boundary", "deep_chains", "word_soup"):
        data = inputs[name]
        plan = R.build_ring_plan(native.compress_block(data), len(data), tile_rows=tile_rows)
        ts = R.ring_plan_device_tensors(plan, card)
        ref = R.ring_decode_reference(*ts, tile_rows=tile_rows)
        for v in FP.EXACT:
            before = FP.stats[v]
            assert torch.equal(FP.fire_probe(v, *ts, tile_rows=tile_rows), ref), (name, v)
            assert FP.stats[v] == before + 1
    wild = R.RingPlan.from_arrays(**wild_plan_fields(tile_rows))
    ts = R.ring_plan_device_tensors(wild, card)
    ref = R.ring_decode_reference(*ts, tile_rows=tile_rows)
    for v in FP.EXACT:
        assert torch.equal(FP.fire_probe(v, *ts, tile_rows=tile_rows), ref), ("wild", v)


def test_fire_probe_ablations_launch(card):
    data = word_soup(300000, seed=4)
    plan = R.build_ring_plan(native.compress_block(data), len(data))
    ts = R.ring_plan_device_tensors(plan, card)
    for v in set(FP.VARIANTS) - set(FP.EXACT):
        before = FP.stats[v]
        out = FP.fire_probe(v, *ts, tile_rows=plan.tile_rows)
        torch.cuda.synchronize()
        assert out.shape == ts[0].shape and FP.stats[v] == before + 1


def _frame(data: bytes, **kw) -> bytes:
    return frame.compress(data, frame.FrameInfo(**kw))


def test_frame_decoder_device_engine_equals_cpu_run(card, monkeypatch):
    # 13 blocks of 64 KiB in batches of 4: four pipelined launches; linked
    # batches decode synchronously, one launch each.
    monkeypatch.setattr(frame.FrameDecoder, "DEVICE_BATCH_BLOCKS", 4)
    data = word_soup(800000, seed=31)
    for mode in (frame.BlockMode.Independent, frame.BlockMode.Linked):
        f = _frame(data, block_size=frame.BlockSize.Max64KB, block_mode=mode,
                   block_checksums=True, content_checksum=True)
        before = dict(R.stats)
        got = frame.FrameDecoder(io.BytesIO(f), engine="device").read_all()
        assert R.stats["kernel_launches"] == before["kernel_launches"] + 4
        assert R.stats["overflow_fused_decodes"] == before["overflow_fused_decodes"]
        assert got == data
        assert frame.FrameDecoder(io.BytesIO(f), engine="device", device="cpu").read_all() == got
    legacy = _frame(data, legacy_frame=True)
    assert frame.FrameDecoder(io.BytesIO(legacy + f), engine="device").read_all() == data + data


@pytest.mark.parametrize("name", ["word_soup", "periodic_ring_boundary", "incompressible", "rle"])
def test_candidate_planes_equal_cpu_run(card, name):
    data = block_inputs()[name]
    g = packing.pad_to(np.frombuffer(data, np.uint8).copy(), packing.size_bucket(len(data) + 4))
    on_card, on_cpu = torch.from_numpy(g).to(card), torch.from_numpy(g)
    for a, b in zip(E.candidates_core(on_card), E.candidates_core(on_cpu)):
        assert torch.equal(a.cpu(), b)
    for pool in (4, 2):
        assert torch.equal(E.best_plane_core(on_card, pool).cpu(), E.best_plane_core(on_cpu, pool))


def test_hybrid_encode_equals_cpu_run(card, monkeypatch):
    monkeypatch.setattr(E, "_PLANE_ROWS", 2)  # 3 chunk rows: two dispatches, the last ragged
    dic = word_soup(70000, seed=32)
    for data, ext in ((word_soup(300000, seed=33), b""), (word_soup(300000, seed=33), dic),
                      (word_soup(1350000, seed=34), b""), (word_soup(1000000, seed=35), dic)):
        before = E.stats["plane_quads"]
        got = E.compress_block_hybrid(data, ext)
        assert got == E.compress_block_hybrid(data, ext, device="cpu")
        streams = len(ext[-65536:]) + len(data) + 4 > E._CHUNK_W
        rows = -(-len(data) // E._CHUNK_C) if streams else 0
        assert E.stats["plane_quads"] == before + 2 * -(-rows // 2)  # the card's run and the CPU's
        assert native.decompress_block(got, len(data), ext[-65536:]) == data
        assert decode_block_device(got, len(data), ext_dict=ext[-65536:]) == data


def test_device_frame_encode_equals_cpu_run(card):
    data = word_soup(2500000, seed=36)
    fi = dict(block_size=frame.BlockSize.Max1MB, block_mode=frame.BlockMode.Linked,
              content_checksum=True)
    f = frame.compress_frame_device(data, frame.FrameInfo(**fi))
    assert f == frame.compress_frame_device(data, frame.FrameInfo(**fi), device="cpu")
    buf = io.BytesIO()
    with frame.FrameEncoder(buf, frame.FrameInfo(**fi), engine="device") as enc:
        enc.write(data)
    assert buf.getvalue() == f
    assert frame.FrameDecoder(io.BytesIO(f), engine="device").read_all() == data
    # the default config: 64 KiB independent blocks, the all-device encoder
    got = LZ4Codec().compress(data)
    assert got == LZ4Codec(device="cpu").compress(data)
    assert frame.FrameDecoder(io.BytesIO(got), engine="device").read_all() == data


@pytest.mark.parametrize("name", ["word_soup", "periodic_ring_boundary", "incompressible", "rle"])
def test_device_encoder_programs_equal_cpu_run(card, name):
    data = block_inputs()[name][:60000]
    dic = word_soup(5000, seed=38)
    width = 98304
    rows = np.zeros((2, width), np.uint8)
    rows[0, : len(data)] = np.frombuffer(data, np.uint8)
    rows[1, : len(dic) + len(data)] = np.frombuffer(dic + data, np.uint8)
    lens = np.array([[0, len(dic)], [len(data), len(dic) + len(data)]], np.int32)
    geo = dict(levels=12, nseq_pad=packing.size_bucket(width // 4 + 2, minimum=256))
    _same(*_on_both(card, lambda r, d, t: E.match_core(r, d, t, **geo), [rows, lens[0], lens[1]]))
    comp_pad = packing.size_bucket(native.compress_bound(65536))
    got, want = _on_both(card, lambda r, d, t: E.encode_chunk_core(r, r.view(torch.int32), d, t,
                                                                   comp_pad=comp_pad, **geo),
                         [rows, lens[0], lens[1]])
    _same(got, want)
    assert native.decompress_block(got[0][1, : int(got[1][1])].cpu().numpy().tobytes(), len(data),
                                   dic) == data


def test_compress_block_device_equals_cpu_run(card):
    # word_soup(1200000, seed=41) meets a fingerprint collision past its
    # first chunk boundary (the JAX package writes the same raw bytes): its
    # raw wire fails the verify walk and the guard takes the host encoder's.
    dic = word_soup(70000, seed=39)
    before = dict(E.stats)
    for data, ext in ((word_soup(300000, seed=40), b""), (word_soup(300000, seed=40), dic),
                      (word_soup(1200000, seed=41), b""), (word_soup(1000000, seed=42), dic)):
        raw = E.compress_block_device(data, ext, verify=False)
        assert raw == E.compress_block_device(data, ext, verify=False, device="cpu")
        got = E.compress_block_device(data, ext)
        assert got == E.compress_block_device(data, ext, device="cpu")
        assert (got == raw) == native.verify_block(raw, data, ext[-65536:])
        arr, n = E.compress_block_device(data, ext, as_array=True)
        assert arr.device.type == "cuda" and arr[:n].cpu().numpy().tobytes() == got
        assert decode_block_device(got, len(data), ext_dict=ext[-65536:]) == data
        assert native.verify_block(got, data, ext[-65536:])
    assert E.stats["plane_quads"] == before["plane_quads"]
    assert E.stats["verify_fallbacks"] == before["verify_fallbacks"] + 3  # the collision, 3 calls


def test_small_block_frames_equal_cpu_run(card):
    data = word_soup(900000, seed=43)
    for size in (frame.BlockSize.Max64KB, frame.BlockSize.Max256KB):
        fi = dict(block_size=size, block_mode=frame.BlockMode.Linked, block_checksums=True,
                  content_checksum=True)
        f = frame.compress_frame_device(data, frame.FrameInfo(**fi))
        assert f == frame.compress_frame_device(data, frame.FrameInfo(**fi), device="cpu")
        buf = io.BytesIO()
        with frame.FrameEncoder(buf, frame.FrameInfo(**fi), engine="device") as enc:
            enc.write(data)
        assert buf.getvalue() == f
        assert decompress_frame_device(f) == data
    rows = np.zeros((3, 98304), np.uint8)
    for i in range(3):
        rows[i, :65536] = np.frombuffer(data[i * 65536 : (i + 1) * 65536], np.uint8)
    lens = [[0, 0, 0], [65536, 65536, 65536]]
    out, total = LZ4Codec().encode_step(rows, *lens)
    assert out.device.type == "cuda"
    want = LZ4Codec(device="cpu").encode_step(rows, *lens)
    _same((out, total), want)
    assert LZ4Codec().compress_block(data[:300000]) == E.compress_block_device(data[:300000], device="cpu")


def test_encode_blocks_groups_equal_cpu_run(card, monkeypatch):
    # three rows a dispatch: 14 blocks are five groups, each uploaded and
    # read back through pinned host memory while the next one is queued
    from lz4_flex_tpu_torch.parallel import pipeline as PP

    data = word_soup(900000, seed=44)
    monkeypatch.setattr(PP, "_ENCODE_ROWS", 3)
    for linked in (False, True):
        before = E.stats["match_calls"]
        got = PP.encode_blocks(data, 65536, linked=linked)
        assert E.stats["match_calls"] == before + 5
        assert got == PP.encode_blocks(data, 65536, linked=linked, device="cpu")


@pytest.mark.parametrize("variant", GP.VARIANTS)
def test_gather_probe_equals_plain(card, variant):
    tbl, idx = (torch.from_numpy(a).to(card) for a in GP.make_inputs(GP.function_of(variant), 11))
    before = GP.stats[variant]
    got = GP.gather(variant, tbl, idx, reps=3)
    assert GP.stats[variant] == before + 1
    want = GP.PLAIN[GP.function_of(variant)](tbl, idx).reshape(GP.OUT_ROWS, GP.WIDTH)
    assert torch.equal(got, want)


def _on_both(card, fn, arrays, *args, **kw):
    """``fn`` on the card and on the CPU, on the same numpy inputs."""
    got = fn(*(torch.from_numpy(a.copy()).to(card) for a in arrays), *args, **kw)
    want = fn(*(torch.from_numpy(a.copy()) for a in arrays), *args, **kw)
    return got, want


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("name", ["deep_chains", "periodic_ring_boundary", "word_soup", "rle_overlap"])
def test_expansion_engines_equal_cpu_run(card, name):
    data = block_inputs()[name]
    comp = np.frombuffer(native.compress_block(data), np.uint8)
    seq = parse_sequences_host(comp)
    out_pad = packing.size_bucket(seq.total_out)
    nseq_pad = packing.size_bucket(seq.nseq, minimum=256)
    cw = D._pack_host(comp, packing.size_bucket(len(comp)))
    tables = [packing.pad_to(seq.out_off, nseq_pad, fill=out_pad), packing.pad_to(seq.lit_start, nseq_pad),
              packing.pad_to(seq.lit_len, nseq_pad), packing.pad_to(seq.match_off, nseq_pad, fill=1)]
    dw = np.zeros(1, np.int32)
    for fn in (D.expand_core, X.expand2_core):
        got, want = _on_both(card, fn, [cw, dw, *tables], 0, seq.total_out, out_pad=out_pad,
                             has_dict=False)
        _same(got, want)
        assert got[: seq.total_out].cpu().numpy().tobytes() == data
    s_got, s_want = _on_both(card, X.build_source_map, tables, 0, seq.total_out, out_pad=out_pad,
                             comp_pad=cw.shape[0] * 4, dict_bytes=0)
    _same(s_got, s_want)
    r_got, r_want = _on_both(card, X.resolve_cells, [s_want.numpy()], out_pad=out_pad)
    _same(r_got, r_want)


@pytest.mark.parametrize("name", ["word_soup", "rle_overlap", "incompressible"])
def test_parse_engines_equal_cpu_run(card, name):
    comp = native.compress_block(block_inputs()[name][:60000])
    pad = packing.size_bucket(len(comp) + 1)
    u8 = packing.pad_to(np.frombuffer(comp, np.uint8), pad)
    nseq_pad = packing.size_bucket(pad // 3 + 2, minimum=256)
    for fn in (P.parse_core, P.parse_walk_core):
        _same(*_on_both(card, fn, [u8], len(comp), nseq_pad=nseq_pad))
    for lanes in (4, 8):
        _same(*_on_both(card, P.parse_strided_core, [u8], len(comp), lanes=lanes))
    kw = dict(out_pad=65536, nseq_pad=nseq_pad)
    for expand in ("v1", "v2"):
        _same(*_on_both(card, D.decode_resident_core, [u8], len(comp), parse_engine="walk",
                        expand_engine=expand, **kw))
    # the doubling parse on the card is the resident kernel whatever the
    # engine: the v2 program's result; v1 writes other bytes past the total
    cpu = {e: D.decode_resident_core(torch.from_numpy(u8), len(comp), expand_engine=e, **kw)
           for e in ("v1", "v2")}
    for expand in ("v1", "v2"):
        got = D.decode_resident_core(torch.from_numpy(u8).to(card), len(comp),
                                     expand_engine=expand, **kw)
        _same(got, cpu["v2"])
        total = int(cpu["v1"][1])
        _same((got[0][:total], *got[1:]), (cpu["v1"][0][:total], *cpu["v1"][1:]))


def test_fallback_entry_points_on_card(card, monkeypatch):
    soup = word_soup(370000, seed=37)
    dic, data = soup[:70000], soup[70000:]
    comp, dcomp = native.compress_block(data), block_compress_with_dict(data, dic)
    for parse in ("host", "device"):
        for engine in ("v1", "v2"):
            arr = decode_block_device(comp, len(data), parse=parse, engine=engine, as_array=True)
            assert arr.device.type == "cuda" and arr.cpu().numpy().tobytes() == data
        assert decode_block_device(dcomp, len(data), dic, parse=parse) == data
    f = frame.compress(data[:200000], frame.FrameInfo(block_size=frame.BlockSize.Max64KB))
    rows = np.zeros((2, 65536 + 512), np.uint8)  # row 0 is empty: flagged as truncated
    small = native.compress_block(data[:60000])
    rows[1, : len(small)] = np.frombuffer(small, np.uint8)
    out, total, errs = LZ4Codec(device=card).decode_step(rows, [0, len(small)])
    assert out.device.type == "cuda" and int(total[1]) == 60000
    assert out[1, :60000].cpu().numpy().tobytes() == data[:60000]
    assert errs[0].tolist() == [False, True, False, False, False] and not bool(errs[1].any())
    # forced overflow: every ring plan overflows, and everything stays on the card
    monkeypatch.setattr(R, "NFMAX_STEPS", (1,))
    monkeypatch.setattr(R, "NFMAX_RETRY", 1)
    monkeypatch.setattr(R, "_nfmax_hint", [1])
    monkeypatch.setattr(native, "decompress_block", None)  # any host decode would raise
    before = dict(R.stats)
    assert decode_block_device(comp, len(data)) == data
    assert decode_block_device(dcomp, len(data), dic) == data
    assert decompress_frame_device(f) == data[:200000]
    one = frame.compress(data[:60000], frame.FrameInfo(block_size=frame.BlockSize.Max64KB))
    assert frame.FrameDecoder(io.BytesIO(one), engine="device").read_all() == data[:60000]
    assert R.stats["overflow_fused_decodes"] == before["overflow_fused_decodes"] + 4
    assert R.stats["kernel_launches"] == before["kernel_launches"]


def _device_events(fn) -> int:
    """The device events (kernels and copies) of one call of ``fn`` under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def test_decode_step_is_one_batched_program(card):
    """decode_step on 32 blocks of 64 KiB (one malformed) equals its CPU run
    bit for bit, and its device events do not grow with the batch: B=32
    within 1.5x of B=1."""
    soup = word_soup(32 * 65536, seed=38)
    blocks = [soup[i : i + 65536] for i in range(0, len(soup), 65536)]
    comps = [native.compress_block(b) for b in blocks]
    comps[5] = bytes([0x12, 0x41, 0x00, 0x00])  # offset zero: flagged, neighbours unchanged
    width = packing.size_bucket(max(len(c) for c in comps) + 1)
    rows = np.zeros((len(comps), width), np.uint8)
    for i, c in enumerate(comps):
        rows[i, : len(c)] = np.frombuffer(c, np.uint8)
    lens = np.array([len(c) for c in comps], np.int32)
    got = LZ4Codec(device=card).decode_step(rows, lens)
    _same(got, LZ4Codec(device="cpu").decode_step(rows, lens))
    out, total, errs = got
    assert errs[5].tolist() == [False, False, True, False, False]
    for i, b in enumerate(blocks):
        if i != 5:
            assert out[i, : int(total[i])].cpu().numpy().tobytes() == b and not bool(errs[i].any())
    codec = LZ4Codec(device=card)
    events = {b: _device_events(lambda: codec.decode_step(rows[:b], lens[:b])) for b in (1, 8, 32)}
    assert events[32] <= 1.5 * events[1], events


def _plan_arrays(plan):
    """A plan's (nf_tot, init, f0, f1, f2), copied out of the planner's pool."""
    return tuple(a.copy() for a in (plan.nf_tot, plan.lit_init, plan.rec_f0, plan.rec_f1,
                                    plan.rec_f2))


@pytest.mark.parametrize("tile_rows", [256, 512])
@pytest.mark.parametrize("groups", [1, 2, 8, 40, 140])
def test_grouped_kernel_equals_reference(card, tile_rows, groups):
    # G plans of unequal shapes padded to one and decoded by one launch of
    # K1c; 140 plans are more than the card's 132 SMs hold at once.
    from lz4_flex_tpu_torch.parallel import pipeline as PP

    inputs = list(block_inputs().values())
    datas = [inputs[g % len(inputs)] if groups <= 40 else word_soup(5000 + 997 * g, seed=g)
             for g in range(groups)]
    plans = [_plan_arrays(R.build_ring_plan(native.compress_block(d), len(d), tile_rows=tile_rows))
             for d in datas]
    ts = [torch.from_numpy(a).to(card) for a in PP.stack_ring_plans(plans, tile_rows)]
    before = dict(R.stats)
    out = R.ring_decode_grouped(*ts, tile_rows=tile_rows)
    assert R.stats["grouped_launches"] == before["grouped_launches"] + 1
    assert R.stats["kernel_launches"] == before["kernel_launches"] + 1
    assert torch.equal(out, R.ring_decode_grouped_reference(*ts, tile_rows=tile_rows))
    for g, d in enumerate(datas):
        assert out[g].reshape(-1)[: len(d)].cpu().numpy().tobytes() == d
    # K1a is the one-plan case of the same kernel
    assert torch.equal(R.ring_decode(*(t[0] for t in ts), tile_rows=tile_rows), out[0])


def test_mesh_decode_and_encode_on_one_card(card):
    from lz4_flex_tpu_torch.parallel import pipeline as PP

    data = word_soup(1500000, seed=61)
    f = frame.compress(data, frame.FrameInfo(block_size=frame.BlockSize.Max64KB))
    for n in (2, 4, 8):
        before = dict(R.stats)
        assert decompress_frame_device(f, mesh=["cuda:0"] * n) == data
        assert R.stats["grouped_launches"] == before["grouped_launches"] + 1
        assert R.stats["overflow_sharded_decodes"] == before["overflow_sharded_decodes"]
    got = PP.encode_blocks_sharded(data[:600000], 65536, mesh=["cuda:0"] * 4)
    assert got == PP.encode_blocks_sharded(data[:600000], 65536, mesh=["cpu"] * 4)
    comp, lens, offsets, ok = PP.roundtrip_step_sharded(data[:300000], 65536, mesh=["cuda:0"] * 2)
    assert bool(ok) and comp.device.type == "cuda"


# The resident decode kernel (csrc/resident_decode.cu) against its plain
# version, decode_resident_rows_reference, on the card: outputs, totals and
# flags byte for byte.

MALFORMED = [  # (payload, total, flags) read from the plain version on the CPU
    ("12410000", 7, [False, False, True, False, False]),
    ("3241424305001044", 10, [False, False, False, True, False]),
    ("524142", 5, [True, False, False, False, False]),
    ("1f41020080", 148, [False, True, False, True, False]),
]


def _rows(payloads, width=None, garbage=None):
    """(B, width) uint8 payload rows (width: the size bucket past the longest
    payload), zero past each payload unless ``garbage`` gives a byte to put
    in the 24 bytes after it, and their int32 lengths."""
    width = width or packing.size_bucket(max(max(len(p) for p in payloads), 4) + 1)
    rows = np.zeros((len(payloads), width), np.uint8)
    for i, p in enumerate(payloads):
        rows[i, : len(p)] = np.frombuffer(p, np.uint8)
        if garbage is not None:
            rows[i, len(p) : len(p) + 24] = garbage
    return rows, np.array([len(p) for p in payloads], np.int32)


def _kernel_equals_plain(card, rows, lens, **kw):
    """decode_resident_rows on the card (one launch) against the plain version
    on the card and on the CPU; returns the kernel's result on the host."""
    u8, n = torch.from_numpy(rows).to(card), torch.from_numpy(lens).to(card)
    before = R.stats["resident_launches"]
    got = D.decode_resident_rows(u8, n, **kw)
    assert R.stats["resident_launches"] == before + 1
    want = D.decode_resident_rows_reference(u8, n, **kw)
    _same(got, tuple(t.cpu() for t in want))
    if rows.shape[0] * rows.shape[1] <= 1 << 22:
        _same(got, D.decode_resident_rows_reference(torch.from_numpy(rows), torch.from_numpy(lens),
                                                    **kw))
    return tuple(t.cpu() for t in got)


def test_resident_kernel_equals_plain_on_the_cells_shape(card):
    rows, lens, text = block_rows(256, seed=14)
    out, total, flags = _kernel_equals_plain(card, rows, lens, out_pad=65536, nseq_pad=24576)
    assert out.numpy().tobytes() == text and (total == 65536).all() and not flags.any()


@pytest.mark.parametrize("nrows", [1, 17, 300])
def test_resident_kernel_in_decode_batch_groups(card, nrows):
    from lz4_flex_tpu_torch.parallel import pipeline as PP

    # the last block is short: padding
    text = word_soup(nrows * 65536 - 777, seed=nrows, vocab=50_000, zipf=1.0)
    rows, lens = _rows([native.compress_block(text[i : i + 65536])
                        for i in range(0, len(text), 65536)], width=65536)
    u8, n = torch.from_numpy(rows).to(card), torch.from_numpy(lens).to(card)
    before = R.stats["resident_launches"]
    got = PP._decode_batch(u8, n, out_pad=65536, nseq_pad=24576)
    per = PP._DECODE_POSITIONS // 65536
    assert R.stats["resident_launches"] == before + -(-nrows // per)
    parts = [D.decode_resident_rows_reference(u8[i : i + per], n[i : i + per], out_pad=65536,
                                              nseq_pad=24576) for i in range(0, nrows, per)]
    _same(got, tuple(torch.cat(t).cpu() for t in zip(*parts)))
    out, total, _ = got
    assert int(total[-1]) == len(text) - (nrows - 1) * 65536
    assert b"".join(out[i, : int(total[i])].cpu().numpy().tobytes() for i in range(nrows)) == text


def test_resident_kernel_takes_every_expand_engine(card, monkeypatch):
    # the engine picks among the torch ops only: CUDA rows always launch the kernel
    rows, lens, text = block_rows(4, seed=17)
    u8, n = torch.from_numpy(rows).to(card), torch.from_numpy(lens).to(card)
    monkeypatch.setenv("TLZ4_EXPAND", "v1")
    for engine in (None, "v1", "v2"):
        before = R.stats["resident_launches"]
        out, total, flags = D.decode_resident_rows(u8, n, out_pad=65536, nseq_pad=24576,
                                                   expand_engine=engine)
        assert R.stats["resident_launches"] == before + 1
        assert out.cpu().numpy().tobytes() == text and (total == 65536).all() and not flags.any()
    with pytest.raises(ValueError, match="unknown expand engine"):
        D.decode_resident_rows(u8, n, out_pad=65536, nseq_pad=24576, expand_engine="v3")


def test_resident_kernel_on_4mib_rows(card):
    # out_pad 4 MiB: the window is a ring in shared memory, flushed as it goes
    blocks = [word_soup(4 << 20, seed=40, vocab=50_000, zipf=1.0),
              block_inputs()["periodic_ring_boundary"] * 11,
              block_inputs()["incompressible"] * 20]
    rows, lens = _rows([native.compress_block(b[: 4 << 20]) for b in blocks])
    out, total, flags = _kernel_equals_plain(card, rows, lens, out_pad=4 << 20,
                                             nseq_pad=packing.size_bucket(rows.shape[1] // 3 + 2))
    for i, b in enumerate(blocks):
        assert out[i, : int(total[i])].numpy().tobytes() == b[: 4 << 20]
    assert not flags.any()


def test_resident_kernel_capacity_below_total(card):
    rows, lens, _ = block_rows(3, seed=15)
    _, total, flags = _kernel_equals_plain(card, rows, lens, out_pad=65536, nseq_pad=24576,
                                           capacity=60000)
    assert (total == 65536).all() and flags[:, 4].all() and not flags[:, :4].any()


def test_resident_kernel_malformed_rows(card):
    rows, lens = _rows([bytes.fromhex(h) for h, _, _ in MALFORMED], width=256)
    out, total, flags = _kernel_equals_plain(card, rows, lens, out_pad=256, nseq_pad=256)
    assert total.tolist() == [t for _, t, _ in MALFORMED]
    assert flags.tolist() == [f for _, _, f in MALFORMED]
    assert out[0, :8].tolist() == [65] * 7 + [0]
    assert out[1, :10].tolist() == [65, 66, 67, 0, 0, 65, 66, 67, 0, 68]
    assert out[2, :3].tolist() == [65, 66, 0]
    assert out[3, :4].tolist() == [65, 0, 65, 0]


def _corrupted(comp: bytes, rng) -> bytes:
    """One malformed variant of a valid block: truncated (mid-LSIC where the
    block has a run), an offset set to 0 or reaching before the block, the
    last literals overrunning the payload, a few flipped bytes, or empty."""
    c = bytearray(comp)
    seq = parse_sequences_host(comp)
    kind = rng.integers(7)
    if kind == 0:
        ff = [i for i in range(len(c)) if c[i] == 0xFF]
        return bytes(c[: ff[rng.integers(len(ff))] + 1] if ff else c[: rng.integers(len(c))])
    if kind in (1, 2) and seq.nseq > 1:
        j = int(rng.integers(seq.nseq - 1))
        at = int(seq.lit_start[j] + seq.lit_len[j])
        c[at : at + 2] = b"\0\0" if kind == 1 else b"\xff\xff"
        return bytes(c)
    if kind == 3:
        return bytes(c[: len(c) - 1 - int(rng.integers(min(len(c), int(seq.lit_len[-1]) + 2)))])
    if kind == 4:
        for i in rng.integers(0, len(c), 3):
            c[i] = int(rng.integers(256))
        return bytes(c)
    if kind == 5:
        return b""
    return bytes(rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8))


def test_resident_kernel_seeded_fuzz(card):
    rng = np.random.default_rng(1414)
    soup = word_soup(400000, seed=41)
    inputs = list(block_inputs().values())
    payloads = []
    for k in range(320):
        if k % 3:
            o = int(rng.integers(0, 300000))
            data = soup[o : o + int(rng.integers(20, 60000))]
        else:
            data = inputs[k % len(inputs)][: int(rng.integers(20, 60000))]
        payloads.append(_corrupted(native.compress_block(data), rng))
    rows, lens = _rows(payloads, garbage=0xAB)
    _kernel_equals_plain(card, rows[:160], lens[:160], out_pad=65536, nseq_pad=24576)
    # a short table (the last kept match runs on) and a low capacity
    _kernel_equals_plain(card, rows[160:], lens[160:], out_pad=65536, nseq_pad=300, capacity=4096)
    # lengths past the row, and a row of garbage
    lens2 = lens[:8].copy()
    lens2[::2] = rows.shape[1] + 5
    _kernel_equals_plain(card, rows[:8], lens2, out_pad=65536, nseq_pad=24576)


def test_decode_batch_group_is_one_launch_and_no_host_read(card):
    from torch.profiler import ProfilerActivity, profile

    from lz4_flex_tpu_torch.parallel import pipeline as PP

    rows, lens, text = block_rows(32, seed=16)
    u8, n = torch.from_numpy(rows).to(card), torch.from_numpy(lens).to(card)
    PP._decode_batch(u8, n, out_pad=65536, nseq_pad=24576)
    torch.cuda.synchronize()
    t0, before = time.time_ns(), dict(R.stats)
    with profile(activities=[ProfilerActivity.CPU]):
        out, _, _ = PP._decode_batch(u8, n, out_pad=65536, nseq_pad=24576)
    torch.cuda.synchronize()
    names = [r[0] for r in trace.records(t0)]
    assert names.count("resident.step") == 1 and "resident.sync" not in names
    assert R.stats["resident_launches"] == before["resident_launches"] + 1
    assert R.stats["resident_rows"] == before["resident_rows"] + 32
    assert out.cpu().numpy().tobytes() == text
