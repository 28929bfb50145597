"""The port's mesh layer (on the CPU) against the JAX package's, on the same
inputs, at N = 1, 2 and 8: a port mesh of N CPU entries against a JAX mesh
of N of the 8 virtual CPU devices (tests/conftest.py). The encode side is
in test_torch_mesh_encode.py.

Covers the decode scenarios of tests/test_parallel.py: the sharded decode
with the grouped ring plans as the production path (the grouped kernel's
plain version against JAX's ``decode_blocks_sharded_ring``, the Pallas
kernel in interpret mode, at G = 1, 2 and 8), its error types, an
independent frame that refers across blocks, the roundtrip step,
``fetch_global``'s forced replication and ``distributed_init`` as a no-op;
and the resident fallback under a forced overflow. Where JAX's interpret
kernel decodes wrong (ROADMAP fault 2) the port is held to the data.
Tolerance: exact everywhere."""

import numpy as np
import pytest
import torch

import jax

from lz4_flex_tpu import block as JB
from lz4_flex_tpu.block import errors as JBE
from lz4_flex_tpu.frame import errors as JFE
from lz4_flex_tpu.frame.device import decompress_frame_device as jax_decompress_frame
from lz4_flex_tpu.parallel import pipeline as JP
from lz4_flex_tpu.parallel.mesh import codec_mesh as jax_codec_mesh
from lz4_flex_tpu_torch import frame, native
from lz4_flex_tpu_torch.block import errors as PBE
from lz4_flex_tpu_torch.frame import errors as PFE
from lz4_flex_tpu_torch.frame.device import decompress_frame_device
from lz4_flex_tpu_torch.ops import ringdecode as R
from lz4_flex_tpu_torch.parallel import codec_mesh, distributed_init, fetch_global
from lz4_flex_tpu_torch.parallel import pipeline as PP

from .torch_inputs import periodic_ring_boundary, word_soup

NS = (1, 2, 8)
BS = 4096  # small blocks: 10 blocks over up to 8 entries
DATA = word_soup(40000, seed=42)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(n: int):
    """The port's mesh and JAX's, of ``n`` entries each."""
    return codec_mesh(["cpu"] * n), jax_codec_mesh(jax.devices()[:n])


def _blocks(data: bytes, bs: int = BS) -> list[bytes]:
    return [data[i : i + bs] for i in range(0, len(data), bs)]


# -- mesh -----------------------------------------------------------------------------


def test_codec_mesh_is_a_list_of_devices():
    mesh = codec_mesh(["cpu"] * 3)
    assert mesh == [torch.device("cpu")] * 3
    assert codec_mesh(mesh) == mesh
    with pytest.raises(ValueError):
        codec_mesh([])
    if not torch.cuda.is_available():
        for devices in (None, ["cuda:0"], ["cpu", "cuda"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                codec_mesh(devices)


def test_distributed_init_single_process_noop():
    assert distributed_init() is False
    assert distributed_init() is False  # idempotent


def test_fetch_global_forced_replication_matches_direct():
    parts = [torch.arange(16, dtype=torch.int32).reshape(2, 8) * (d + 1) for d in range(8)]
    got = fetch_global(parts, force_replicate=True)
    np.testing.assert_array_equal(got, fetch_global(parts))
    assert got.shape == (16, 8)
    np.testing.assert_array_equal(fetch_global(parts[0]), parts[0].numpy())


def test_stage_blocks_pads_rows_as_jax():
    for linked, pad in ((False, 8), (True, 3), (True, 1)):
        got = PP.stage_blocks(DATA, BS, linked=linked, pad_rows_to=pad)
        want = JP.stage_blocks(DATA, BS, linked=linked, pad_rows_to=pad)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]


# -- decode ---------------------------------------------------------------------------


# Periodic matches around the 32 KiB tile edges (where JAX's interpret
# kernel can decode wrong, fault 2) and a word soup, as 16 blocks: the mesh
# of 8 entries has 8 groups of two blocks.
DEC_BS = 20480
DEC_DATA = periodic_ring_boundary()[:200000] + word_soup(120000, seed=46)


@pytest.mark.parametrize("n", NS)
def test_decode_blocks_sharded_equals_jax(n):
    # the grouped plans' plain version (what the port's decode runs on CPU
    # tensors) against JAX's sharded ring decode, the Pallas kernel in
    # interpret mode: the port equals the data, and JAX wherever JAX equals
    # the data
    pm, jm = _meshes(n)
    blocks = _blocks(DEC_DATA, DEC_BS)
    payloads = [JB.compress(b) for b in blocks]
    got = PP.decode_blocks_sharded(payloads, DEC_BS, mesh=pm)
    assert got == blocks
    per = -(-len(payloads) // n)
    staged = PP.stage_ring_groups([payloads[i * per : (i + 1) * per] for i in range(n)], DEC_BS)
    live = [s for s in staged if s and s[0]]
    assert len(live) == n
    ts = [torch.from_numpy(a) for a in PP.stack_ring_plans([s[0] for s in live], R.TILE_ROWS)]
    out = R.ring_decode_grouped_reference(*ts, tile_rows=R.TILE_ROWS)
    flat = b"".join(out[k].reshape(-1)[: sum(s[1])].numpy().tobytes() for k, s in enumerate(live))
    assert flat == DEC_DATA
    want = JP.decode_blocks_sharded(payloads, DEC_BS, mesh=jm)
    assert len(want) == len(got)
    wrong = [i for i, (g, w) in enumerate(zip(got, want)) if w != g]
    assert all(i * DEC_BS < 200000 for i in wrong), wrong  # only where the periodic input lies


def test_ring_decode_is_the_production_path(monkeypatch):
    # one grouped decode a physical device, every group's plan in it; the
    # resident decoder never runs
    calls = []
    real = R.ring_decode_grouped

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(R, "ring_decode_grouped", counted)
    monkeypatch.setattr(PP, "_decode_blocks_sharded_resident", None)
    blocks = _blocks(DATA)
    payloads = [JB.compress(b) for b in blocks]
    before = R.stats["overflow_sharded_decodes"]
    nb = len(blocks)
    for n in NS:
        calls.clear()
        out = PP.decode_blocks_sharded_ring(payloads, BS, mesh=["cpu"] * n)
        assert out is not None and b"".join(out) == DATA
        assert len(calls) == 1 and calls[0][0] == -(-nb // -(-nb // n))  # the live groups
    # uneven split: fewer blocks than entries
    out3 = PP.decode_blocks_sharded_ring(payloads[:3], BS, mesh=["cpu"] * 8)
    assert out3 is not None and b"".join(out3) == b"".join(blocks[:3])
    assert PP.decode_blocks_sharded(payloads, BS, mesh=["cpu"] * 4) == blocks
    assert R.stats["overflow_sharded_decodes"] == before


def test_empty_blocks_and_groups():
    payloads = [JB.compress(b"")] * 3 + [JB.compress(DATA[:1000])]
    for n in (2, 8):
        assert PP.decode_blocks_sharded(payloads, BS, mesh=["cpu"] * n) == [b"", b"", b"", DATA[:1000]]
        assert PP._decode_blocks_sharded_resident(payloads, BS, mesh=["cpu"] * n) == [
            b"", b"", b"", DATA[:1000]]


def test_resident_fallback_under_forced_overflow(monkeypatch):
    # a one-step NFMAX ladder: every group's plan overflows, the resident
    # decoder takes the frame, and nothing decodes on the host
    monkeypatch.setattr(R, "NFMAX_STEPS", (1,))
    monkeypatch.setattr(R, "NFMAX_RETRY", 1)
    monkeypatch.setattr(R, "_nfmax_hint", [1])
    monkeypatch.setattr(native, "decompress_block", None)  # any host decode would raise
    data = word_soup(8 * 65536, seed=47)
    blocks = _blocks(data, 65536)
    payloads = [JB.compress(b) for b in blocks]
    assert PP.decode_blocks_sharded_ring(payloads, 65536, mesh=["cpu"] * 2) is None
    before = dict(R.stats)
    assert PP.decode_blocks_sharded(payloads, 65536, mesh=["cpu"] * 2) == blocks
    assert R.stats["overflow_sharded_decodes"] == before["overflow_sharded_decodes"] + 1
    assert R.stats["kernel_launches"] == before["kernel_launches"]
    f = frame.compress(data, frame.FrameInfo(block_size=frame.BlockSize.Max64KB))
    assert decompress_frame_device(f, mesh=["cpu"] * 2) == data
    assert R.stats["overflow_sharded_decodes"] == before["overflow_sharded_decodes"] + 2


@pytest.mark.parametrize("resident", [False, True])
def test_decode_errors_equal_jax(resident):
    # a match reaching before the block start, and a block decoding to more
    # than the block size: the same error types as JAX, on either engine
    bad = bytes([0x10, 0x41, 100, 0, 0x00])  # 'A', match offset 100, end token
    big = JB.compress(word_soup(3 * BS, seed=48)[: 2 * BS + 100])
    pm, jm = _meshes(2)
    fn = PP._decode_blocks_sharded_resident if resident else PP.decode_blocks_sharded
    for payloads, port_err, jax_err in (([bad], PBE.OffsetOutOfBounds, JBE.OffsetOutOfBounds),
                                        ([big], PBE.OutputTooSmall, JBE.OutputTooSmall)):
        with pytest.raises(jax_err):
            JP.decode_blocks_sharded(payloads, BS, mesh=jm)
        with pytest.raises(port_err):
            fn(payloads, BS, mesh=pm)
        assert port_err.__name__ == jax_err.__name__


def test_frame_rejects_cross_block_ref_independent():
    fi = frame.FrameInfo(block_size=frame.BlockSize.Max64KB)
    blk1 = JB.compress(b"ABCDEFGH")
    blk2 = bytes([0x10, 0x5A, 5, 0, 0x50]) + b"WXYZQ"  # offset 5 reaches into block 1
    out = bytearray(fi.write())
    for payload in (blk1, blk2):
        out += frame.BlockInfo(frame.BlockInfoKind.Compressed, len(payload)).write() + payload
    out += frame.BlockInfo(frame.BlockInfoKind.EndMark).write()
    pm, jm = _meshes(2)
    with pytest.raises(JFE.DecompressionError):
        jax_decompress_frame(bytes(out), mesh=jm)
    with pytest.raises(PFE.DecompressionError):
        decompress_frame_device(bytes(out), mesh=pm)


# -- roundtrip step ------------------------------------------------------------------


def test_roundtrip_step_sharded_equals_jax():
    pm, jm = _meshes(8)
    comp, lens, offsets, ok = PP.roundtrip_step_sharded(DATA, BS, mesh=pm)
    assert bool(ok)
    w_comp, w_lens, w_offsets, w_ok = JP.roundtrip_step_sharded(DATA, BS, mesh=jm)
    assert bool(w_ok)
    np.testing.assert_array_equal(comp.numpy(), np.asarray(w_comp))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(w_lens))
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(w_offsets))
    assert (np.cumsum(lens.numpy()) - lens.numpy() == offsets.numpy()).all()
    for n in (1, 2):
        c, l, o, k = PP.roundtrip_step_sharded(DATA, BS, mesh=["cpu"] * n)
        assert bool(k) and torch.equal(l[: len(_blocks(DATA))], lens[: len(_blocks(DATA))])


def test_grouped_tensors_are_checked():
    data = word_soup(50000, seed=51)
    plan = R.build_ring_plan(native.compress_block(data), len(data))
    arrs = (plan.nf_tot.copy(), plan.lit_init.copy(), plan.rec_f0.copy(), plan.rec_f1.copy(),
            plan.rec_f2.copy())
    init, f0, f1, f2, nft = (torch.from_numpy(a) for a in PP.stack_ring_plans([arrs] * 2, R.TILE_ROWS))
    with pytest.raises(ValueError):
        R.ring_decode_grouped(init, f0, f1, f2, nft[0])
    with pytest.raises(ValueError):
        R.ring_decode_grouped(init[:1], f0, f1, f2, nft)
    out = R.ring_decode_grouped(init, f0, f1, f2, nft)
    assert out.shape == init.shape and torch.equal(out[0], out[1])
    assert out[0].reshape(-1)[: len(data)].numpy().tobytes() == data
