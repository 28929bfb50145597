"""The port's all-device encoder (on the CPU) against the JAX package's, bit
for bit: the same seeded inputs go through ``_mix``, ``match_core`` (all
six outputs over the whole padded width), ``emit_core``, the host table
merge, ``encode_chunk_core`` batched over rows, ``gather_words_unaligned``,
``compress_block_device`` (one chunk and the resident path), 64 and 256
KiB frames (``encode_blocks``, ``compress_frame_device``,
``FrameEncoder(engine="device")``, ``LZ4Codec.compress``; the JAX side on
a one-device mesh), ``LZ4Codec.compress_block`` and ``encode_step``, the
verify guard's fallback to the host encoder, and the native functions the
guard reads. Every wire decodes back to its input through the native
decoder. Tolerance: exact everywhere.

The JAX functions run under jit at fixed padded shapes, so each compiles
once."""

import io
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_flex_tpu import block as JB
from lz4_flex_tpu import native as JN
from lz4_flex_tpu.frame import BlockMode, BlockSize, FrameInfo
from lz4_flex_tpu.frame.device import compress_frame_device as jax_compress_frame
from lz4_flex_tpu.models import LZ4Codec as JLZ4Codec
from lz4_flex_tpu.ops import encode as JE
from lz4_flex_tpu.ops import packing as JK
from lz4_flex_tpu.parallel import pipeline as JP
from lz4_flex_tpu.parallel.mesh import codec_mesh
from lz4_flex_tpu_torch import block as PB
from lz4_flex_tpu_torch import frame, native
from lz4_flex_tpu_torch.block import errors as PBE
from lz4_flex_tpu_torch.frame.device import compress_frame_device
from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec
from lz4_flex_tpu_torch.ops import encode as PE
from lz4_flex_tpu_torch.ops import packing as PK
from lz4_flex_tpu_torch.parallel import pipeline as PP
from lz4_flex_tpu_torch.spec.constants import get_maximum_output_size

from .torch_inputs import collision_input, incompressible, word_soup


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores; torch's thread pool would oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh1():
    return codec_mesh(jax.devices()[:1])


def _roundtrip(comp: bytes, data: bytes, dic: bytes = b"") -> None:
    assert native.decompress_block(comp, len(data), dic[-65536:]) == data


# -- device programs -----------------------------------------------------------


def test_mix_equals_jax():
    rng = np.random.default_rng(70)
    a = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    a = np.concatenate([a, np.repeat(edge, 5)])
    b = np.concatenate([b, np.tile(edge, 5)])
    want = np.asarray(JE._mix(jnp.asarray(a), jnp.asarray(b)))
    got = PE._mix(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_gather_words_unaligned_equals_jax():
    rng = np.random.default_rng(71)
    words = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(-20, 4 * 1000 + 20, 5000).astype(np.int32)
    want = np.asarray(JK.gather_words_unaligned(jnp.asarray(words), jnp.asarray(idx)))
    got = PK.gather_words_unaligned(torch.from_numpy(words.view(np.int32)), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


PAD = 8192  # dict ++ data of every input below, zero padded
LEVELS = JE._levels_for(PAD)
NSEQ_PAD = JK.size_bucket(PAD // 4 + 2, minimum=256)
COMP_PAD = JK.size_bucket(get_maximum_output_size(PAD))
_jax_match = jax.jit(partial(JE.match_core, levels=LEVELS, nseq_pad=NSEQ_PAD))
_jax_emit = jax.jit(partial(JE.emit_core, comp_pad=COMP_PAD))

CHUNKS = {
    **{f"len{k}": (b"abcabcabcabcab"[:k], b"") for k in range(14)},
    "a30": (b"a" * 30, b""),  # the spec-conformant tail of tests/test_ops.py
    "rle": (b"a" * 5000, b""),
    "random": (incompressible(5000, seed=72), b""),
    "random_8": (np.random.default_rng(73).integers(0, 8, 6000, dtype=np.uint8).tobytes(), b""),
    "soup": (word_soup(7000, seed=74), b""),
    "soup+dict": (word_soup(5000, seed=75), word_soup(3000, seed=76)),
    "rle+dict": (b"b" * 3000, b"ab" * 1500),
    "tiny+dict": (b"hello", word_soup(3000, seed=76)),
}


@pytest.mark.parametrize("name", sorted(CHUNKS))
def test_match_and_emit_equal_jax(name):
    data, dic = CHUNKS[name]
    buf = np.frombuffer(dic + data, np.uint8)
    d, n = len(dic), buf.shape[0]
    g = PK.pad_to(buf.copy(), PAD)
    want = [np.asarray(x) for x in _jax_match(jnp.asarray(g), jnp.int32(d), jnp.int32(n))]
    before = PE.stats["match_calls"]
    got = PE.match_core(torch.from_numpy(g)[None], torch.tensor([d]), torch.tensor([n]),
                        levels=LEVELS, nseq_pad=NSEQ_PAD)
    assert PE.stats["match_calls"] == before + 1
    for w, t in zip(want, got):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t[0].numpy(), w)

    # the host merge, then the emission at fixed shapes
    merged = JE._merge_tables([(*want, d, 0)], len(data))
    pmerged = PE._merge_tables([(*(t[0].numpy() for t in got), d, 0)], len(data))
    for f in ("ll", "ls", "off", "mlc", "match"):
        np.testing.assert_array_equal(getattr(pmerged, f), getattr(merged, f))
    assert pmerged.nseq == merged.nseq
    tables = [PK.pad_to(merged.ll, NSEQ_PAD), PK.pad_to(merged.ls, NSEQ_PAD),
              PK.pad_to(merged.off, NSEQ_PAD, fill=1), PK.pad_to(merged.mlc, NSEQ_PAD),
              PK.pad_to(merged.match, NSEQ_PAD)]
    words = PK.pad_to(np.frombuffer(data, np.uint8).copy(), PAD).view("<u4")
    w_out, w_total = _jax_emit(jnp.asarray(words), *map(jnp.asarray, tables), jnp.int32(merged.nseq))
    out, total = PE.emit_core(torch.from_numpy(words.view(np.int32).copy())[None],
                              *(torch.from_numpy(t)[None] for t in tables),
                              torch.tensor([merged.nseq]), comp_pad=COMP_PAD)
    assert out.dtype == torch.uint8 and out.shape == (1, COMP_PAD)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(w_out))
    assert int(total[0]) == int(w_total)
    _roundtrip(out[0, : int(total[0])].numpy().tobytes(), data, dic)


def _three_rows():
    """Three rows of one width, the first holding a 4000-byte dictionary."""
    width, block = 16384, 12000
    rows = np.zeros((3, width), np.uint8)
    dlen = np.array([4000, 0, 0], np.int32)
    parts = [word_soup(4000 + block, seed=77), b"q" * block, incompressible(6000, seed=78)]
    for i, p in enumerate(parts):
        rows[i, : len(p)] = np.frombuffer(p, np.uint8)
    return rows, dlen, np.array([len(p) for p in parts], np.int32), block


def _check_rows(out, total, rows, dlen, tlen) -> None:
    for i in range(rows.shape[0]):
        _roundtrip(out[i, : int(total[i])].numpy().tobytes(), rows[i, dlen[i] : tlen[i]].tobytes(),
                   rows[i, : dlen[i]].tobytes())


def test_encode_chunk_core_batched_equals_jax(monkeypatch):
    # two rows a dispatch on the port's side, so two dispatches
    rows, dlen, tlen, block = _three_rows()
    geo = PP.encode_geometry(rows.shape[1], block)
    jax_batch = jax.jit(partial(JP._encode_batch, **geo))
    w_out, w_total = jax_batch(jnp.asarray(rows), jnp.asarray(rows.view("<u4")), jnp.asarray(dlen),
                               jnp.asarray(tlen))
    monkeypatch.setattr(PP, "_ENCODE_ROWS", 2)
    before = PE.stats["match_calls"], PE.stats["emit_calls"]
    t = torch.from_numpy(rows)
    out, total = PP._encode_batch(t, t.view(torch.int32), torch.from_numpy(dlen),
                                  torch.from_numpy(tlen), **geo)
    assert (PE.stats["match_calls"], PE.stats["emit_calls"]) == (before[0] + 2, before[1] + 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(total.numpy(), np.asarray(w_total))
    _check_rows(out, total, rows, dlen, tlen)


def test_geometry_equals_jax():
    assert PE._ROW_BUCKETS == JE._ROW_BUCKETS
    for b in (1, 2, 5, 23, 255, 256, 257, 1000):
        assert PE._row_bucket(b) == JE._row_bucket(b)
    for pad in (4096, 8192, 98304, 1 << 19, 1 << 20, 3 << 19, 1 << 22):
        assert PE._levels_for(pad) == JE._levels_for(pad)


# -- block paths ----------------------------------------------------------------

DICT = word_soup(10000, seed=79)
BLOCKS = {
    "soup": (word_soup(20000, seed=80), b""),
    "soup+dict": (word_soup(20000, seed=80), DICT),
    "random": (incompressible(20000, seed=81), b""),
    "empty": (b"", b""),
}


@pytest.mark.parametrize("verify", [True, False])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_compress_block_device_equals_jax(name, verify):
    data, dic = BLOCKS[name]
    want = JE.compress_block_device(data, dic, verify=verify)
    got = PE.compress_block_device(data, dic, verify=verify, device="cpu")
    assert got == want
    _roundtrip(got, data, dic)
    arr, n = PE.compress_block_device(data, dic, verify=verify, as_array=True, device="cpu")
    assert arr.dtype == torch.uint8 and arr.device.type == "cpu" and n == len(want)
    assert arr[:n].numpy().tobytes() == want and not arr[n:].any()


def test_resident_path_equals_jax():
    # test_ops.py's large word soup: 600,000 bytes, two chunk rows (bucket
    # 2, one dispatch of four rows), merged and emitted on the device.
    rng = np.random.default_rng(0xC0111DE)
    words = [bytes(w) for w in np.array_split(np.frombuffer(
        (b"alpha beta gamma delta epsilon zeta eta theta iota kappa " * 400), np.uint8), 997)]
    data = b" ".join(words[rng.integers(0, len(words))] for _ in range(60_000))[:600_000]
    assert -(-len(data) // PE._CHUNK_C) == 2
    want = JE.compress_block_device(data, verify=False)
    before = dict(PE.stats)
    got = PE.compress_block_device(data, verify=False, device="cpu")
    assert PE.stats["match_calls"] == before["match_calls"] + 1
    assert PE.stats["emit_calls"] == before["emit_calls"] + 1
    assert PE.stats["plane_quads"] == before["plane_quads"]
    assert got == want
    _roundtrip(got, data)
    assert native.verify_block(got, data)


# -- frames and the codec ---------------------------------------------------------

FRAME_DATA = word_soup(300000, seed=82)  # 5 blocks of 64 KiB, 2 of 256 KiB (the last short)


def _port_fi(**kw) -> frame.FrameInfo:
    return frame.FrameInfo(**{k: getattr(frame, type(v).__name__)[v.name]
                              if isinstance(v, (BlockMode, BlockSize)) else v
                              for k, v in kw.items()})


@pytest.mark.parametrize("mode", [BlockMode.Independent, BlockMode.Linked])
@pytest.mark.parametrize("size", [BlockSize.Max64KB, BlockSize.Max256KB])
def test_device_frames_equal_jax(size, mode):
    kw = dict(block_size=size, block_mode=mode, block_checksums=True, content_checksum=True)
    want = jax_compress_frame(FRAME_DATA, FrameInfo(**kw), mesh=_mesh1())
    before = dict(PE.stats)
    assert compress_frame_device(FRAME_DATA, _port_fi(**kw), device="cpu") == want
    buf = io.BytesIO()
    with frame.FrameEncoder(buf, _port_fi(**kw), engine="device", device="cpu") as enc:
        for i in range(0, len(FRAME_DATA), 70001):
            enc.write(FRAME_DATA[i : i + 70001])
    assert buf.getvalue() == want
    cfg = CodecConfig(block_size=frame.BlockSize[size.name], block_mode=frame.BlockMode[mode.name],
                      block_checksums=True, content_checksum=True)
    assert LZ4Codec(cfg, device="cpu").compress(FRAME_DATA) == want
    assert frame.decompress(want) == FRAME_DATA
    assert PE.stats["plane_quads"] == before["plane_quads"]
    assert PE.stats["verify_fallbacks"] == before["verify_fallbacks"]


def test_default_codec_compress_equals_jax():
    want = JLZ4Codec(mesh=_mesh1()).compress(FRAME_DATA)
    assert LZ4Codec(device="cpu").compress(FRAME_DATA) == want
    assert LZ4Codec(CodecConfig(verify=False), device="cpu").compress(FRAME_DATA) == want


def test_encode_blocks_linked_carry_equals_jax():
    carry = word_soup(90000, seed=83)
    want, want_lens = JP.encode_blocks_sharded(FRAME_DATA, 65536, linked=True, mesh=_mesh1(),
                                               carry=carry)
    payloads, lens, window = PP.encode_blocks(FRAME_DATA, 65536, linked=True, carry=carry,
                                              device="cpu")
    assert payloads == want and lens == want_lens
    assert window == FRAME_DATA[-65536:]
    prev = carry[-65536:]
    pos = 0
    for comp, blen in zip(payloads, lens):
        _roundtrip(comp, FRAME_DATA[pos : pos + blen], prev)
        prev = (prev + FRAME_DATA[pos : pos + blen])[-65536:]
        pos += blen
    assert PP.encode_blocks(FRAME_DATA[:1000], 65536, carry=carry, device="cpu")[2] == b""


@pytest.mark.parametrize("mode", [BlockMode.Independent, BlockMode.Linked])
def test_device_frame_groups_and_streaming_batches_equal_jax(monkeypatch, mode):
    # two rows a dispatch: 4 full 64 KiB blocks and a short one are three
    # groups through encode_blocks; one write of all of it to the streaming
    # encoder is two dispatches for the full blocks, one for the tail
    kw = dict(block_size=BlockSize.Max64KB, block_mode=mode, content_checksum=True)
    want = jax_compress_frame(FRAME_DATA, FrameInfo(**kw), mesh=_mesh1())
    monkeypatch.setattr(PP, "_ENCODE_ROWS", 2)
    linked = mode == BlockMode.Linked
    before = PE.stats["match_calls"]
    payloads, lens, _ = PP.encode_blocks(FRAME_DATA, 65536, linked=linked, device="cpu")
    assert PE.stats["match_calls"] == before + 3
    assert (payloads, lens) == JP.encode_blocks_sharded(FRAME_DATA, 65536, linked=linked,
                                                        mesh=_mesh1())
    before = PE.stats["match_calls"]
    buf = io.BytesIO()
    enc = frame.FrameEncoder(buf, _port_fi(**kw), engine="device", device="cpu")
    enc.write(FRAME_DATA)
    assert PE.stats["match_calls"] == before + 2
    enc.finish()
    assert PE.stats["match_calls"] == before + 3
    assert buf.getvalue() == want
    monkeypatch.setattr(native, "verify_block", lambda *a, **kw: False)
    fallbacks = PE.stats["verify_fallbacks"]
    assert compress_frame_device(FRAME_DATA, _port_fi(**kw), device="cpu", verify=False) == want
    assert PE.stats["verify_fallbacks"] == fallbacks


def test_codec_compress_block_and_encode_step_equal_jax():
    data, dic = BLOCKS["soup+dict"]
    want = JLZ4Codec(mesh=_mesh1()).compress_block(data, dic)
    assert LZ4Codec(device="cpu").compress_block(data, dic) == want
    rows, dlen, tlen, _ = _three_rows()
    w_out, w_total = JLZ4Codec(mesh=_mesh1()).encode_step(jnp.asarray(rows), jnp.asarray(dlen),
                                                         jnp.asarray(tlen))
    out, total = LZ4Codec(device="cpu").encode_step(rows, dlen, tlen)
    assert out.dtype == torch.uint8 and total.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(total.numpy(), np.asarray(w_total))
    _check_rows(out, total, rows, dlen, tlen)


def test_stage_blocks_equals_jax():
    for linked, start in ((True, 5000), (False, 0), (True, 0)):
        got = PP.stage_blocks(FRAME_DATA[:80000], 12000, linked=linked, start=start)
        want = JP.stage_blocks(FRAME_DATA[:80000], 12000, linked=linked, start=start)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]


# -- the verify guard -----------------------------------------------------------------


def test_guard_falls_back_to_the_host_encoder(monkeypatch):
    monkeypatch.setattr(JN, "verify_block", lambda *a, **kw: False)
    monkeypatch.setattr(native, "verify_block", lambda *a, **kw: False)
    data, dic = BLOCKS["soup+dict"]
    before = PE.stats["verify_fallbacks"]
    got = PE.compress_block_device(data, dic, device="cpu")
    assert got == JE.compress_block_device(data, dic) == JB.compress_with_dict(data, dic)
    assert PE.stats["verify_fallbacks"] == before + 1
    arr, n = PE.compress_block_device(data, dic, as_array=True, device="cpu")
    assert arr[:n].numpy().tobytes() == got
    assert PE.stats["verify_fallbacks"] == before + 2
    # no check, no fallback
    assert PE.compress_block_device(data, dic, verify=False, device="cpu") != got
    # every payload of a frame, re-encoded on the host
    src = FRAME_DATA[:150000]
    fi = dict(block_size=BlockSize.Max64KB, block_mode=BlockMode.Linked)
    want = jax_compress_frame(src, FrameInfo(**fi), mesh=_mesh1())
    assert compress_frame_device(src, _port_fi(**fi), device="cpu") == want
    assert PE.stats["verify_fallbacks"] == before + 2 + 3
    payloads, lens, _ = PP.encode_blocks(src, 65536, linked=True, device="cpu")
    prev = b""
    for comp, blen in zip(payloads, lens):
        assert comp == JB.compress_with_dict(src[:blen], prev)
        prev, src = (prev + src[:blen])[-65536:], src[blen:]


def test_guard_catches_a_fingerprint_collision():
    data = collision_input()
    raw = PE.compress_block_device(data, verify=False, device="cpu")
    assert raw == JE.compress_block_device(data, verify=False)
    assert not native.verify_block(raw, data) and not JN.verify_block(raw, data)
    assert native.decompress_block(raw, len(data) + 2000) != data
    before = PE.stats["verify_fallbacks"]
    got = PE.compress_block_device(data, device="cpu")
    assert got == JE.compress_block_device(data) == JB.compress(data)
    fi = dict(block_size=BlockSize.Max64KB)
    assert (compress_frame_device(data, _port_fi(**fi), device="cpu")
            == jax_compress_frame(data, FrameInfo(**fi), mesh=_mesh1()))
    assert PE.stats["verify_fallbacks"] == before + 2
    _roundtrip(got, data)


# -- native functions and the host encoder ----------------------------------------------


def test_native_guard_functions_equal_jax():
    data, dic = word_soup(40000, seed=84), word_soup(70000, seed=85)
    for d in (b"", dic[-65536:]):
        comp = JB.compress_with_dict(data, d)
        assert native.verify_block(comp, data, d) is JN.verify_block(comp, data, d) is True
        bad = bytearray(data)
        bad[12345] ^= 1
        assert native.verify_block(comp, bytes(bad), d) is JN.verify_block(comp, bytes(bad), d) is False
        assert native.verify_block(comp[:-3], data, d) is JN.verify_block(comp[:-3], data, d) is False
    assert native.verify_block(b"", b"") is JN.verify_block(b"", b"") is False
    assert native.verify_block(b"\x00", b"") is JN.verify_block(b"\x00", b"") is True
    for use_hash5 in (False, True):
        t, jt = native.new_table(), JN.new_table()
        native.init_dict_table(t, dic, use_hash5)
        JN.init_dict_table(jt, dic, use_hash5)
        np.testing.assert_array_equal(t, jt)
        assert t.any()
        out, jout = np.zeros(60000, np.uint8), np.zeros(60000, np.uint8)
        n = native.compress_block(data, dic, table=t, use_hash5=use_hash5, out=out)
        jn = JN.compress_block(data, ext_dict=dic, table=jt, use_hash5=use_hash5, out=jout)
        assert isinstance(n, int) and n == jn
        np.testing.assert_array_equal(out, jout)
        _roundtrip(out[:n].tobytes(), data, dic)
    with pytest.raises(PBE.CompressOutputTooSmall):
        native.compress_block(data, out=np.zeros(100, np.uint8))
    with pytest.raises(ValueError):
        native.init_dict_table(np.zeros(4096, np.int64), dic, True)


@pytest.mark.parametrize("dict_len", [0, 3, 4, 1000, 65536, 90000])
def test_host_block_encoder_equals_jax(dict_len):
    data, dic = word_soup(50000, seed=86), word_soup(90000, seed=87)[:dict_len]
    assert PB.compress(data) == JB.compress(data)
    got = PB.compress_with_dict(data, dic)
    assert got == JB.compress_with_dict(data, dic)
    assert PB.compress_with_dict(np.frombuffer(data, np.uint8), bytearray(dic)) == got
    _roundtrip(got, data, dic if dict_len > 3 else b"")
    with pytest.raises(TypeError):
        PB.compress("text")
