"""The port's streaming frame codec (on the CPU) against the JAX package's.

FrameEncoder on the host engine writes the JAX host encoder's bytes for the
same writes; compress_frame_device and FrameEncoder(engine="device") write
the bytes of the JAX package on a one-device mesh (8 virtual devices would
take the all-device route for every block size) at every block size: 64 and
256 KiB blocks through the all-device encoder, larger ones through the
hybrid encoder. FrameDecoder returns the input on both engines over
the scenarios of tests/test_frame_stream_device.py, with the device engine's
pipelined and synchronous paths and its batch budgets. Tolerance: exact."""

import io
import struct

import jax
import pytest

from lz4_flex_tpu import frame as ref_frame
from lz4_flex_tpu.frame import BlockMode, BlockSize, FrameInfo
from lz4_flex_tpu.parallel.mesh import codec_mesh
from lz4_flex_tpu_torch import frame
from lz4_flex_tpu_torch.frame import FrameDecoder, FrameEncoder
from lz4_flex_tpu_torch.frame import errors as FE
from lz4_flex_tpu_torch.frame.device import compress_frame_device
from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec
from lz4_flex_tpu_torch.ops import ringdecode as R
from lz4_flex_tpu_torch.parallel.pipeline import encode_blocks

from .torch_inputs import incompressible, word_soup

SOUP = word_soup(660000, seed=41)  # ~10 blocks of 64 KiB
BIG = word_soup(2500000, seed=42)  # 3 blocks of 1 MiB, the last short
KB64 = 65536


def _pfi(**kw) -> FrameInfo:
    """A FrameInfo of the port (frame infos are mutated by encoders)."""
    return frame.FrameInfo(**{k: _port_enum(v) for k, v in kw.items()})


def _port_enum(v):
    if isinstance(v, (BlockMode, BlockSize)):
        return getattr(frame, type(v).__name__)[v.name]
    return v


def _stream(enc_cls, fi, data: bytes, chunk: int = 50_001, flush_at=None, **kw) -> bytes:
    buf = io.BytesIO()
    enc = enc_cls(buf, fi, **kw)
    for i in range(0, len(data), chunk):
        enc.write(data[i : i + chunk])
        if flush_at is not None and i <= flush_at < i + chunk:
            enc.flush()
    enc.finish()
    return buf.getvalue()


HOST_CASES = {
    "independent_64k": dict(block_size=BlockSize.Max64KB),
    "linked_64k": dict(block_size=BlockSize.Max64KB, block_mode=BlockMode.Linked),
    "checksums_linked_256k": dict(block_size=BlockSize.Max256KB, block_mode=BlockMode.Linked,
                                  block_checksums=True, content_checksum=True),
    "content_size_1m": dict(block_size=BlockSize.Max1MB, content_size=len(SOUP)),
    "auto": dict(),
    "legacy": dict(legacy_frame=True),
}


@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_encoder_equals_jax(name, flush):
    kw = HOST_CASES[name]
    flush_at = 120_000 if flush else None
    if flush and "content_size" in kw:
        flush_at = None  # the size is promised; a flush only changes block bounds
    want = _stream(ref_frame.FrameEncoder, FrameInfo(**kw), SOUP, flush_at=flush_at)
    got = _stream(FrameEncoder, _pfi(**kw), SOUP, flush_at=flush_at)
    assert got == want
    assert frame.decompress(got) == SOUP


def test_host_encoder_empty_reuse_and_one_shot():
    assert _stream(FrameEncoder, None, b"") == _stream(ref_frame.FrameEncoder, None, b"")
    # one encoder, two frames: the table, window and hashes reset between them
    fis = (_pfi(block_mode=BlockMode.Linked, content_checksum=True),
           FrameInfo(block_mode=BlockMode.Linked, content_checksum=True))
    outs = []
    for enc_cls, fi in zip((FrameEncoder, ref_frame.FrameEncoder), fis):
        buf = io.BytesIO()
        enc = enc_cls(buf, fi)
        for part in (SOUP[:300000], SOUP[300000:]):
            enc.write(part)
            enc.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert frame.decompress(outs[0]) == SOUP
    assert frame.compress(SOUP) == ref_frame.compress(SOUP)
    with frame.FrameEncoder(io.BytesIO()).auto_finish() as w:
        w.write(b"abc")


def test_one_shot_compress_of_nothing():
    # The JAX encoder reads the block size of an empty write while it is
    # still Auto and raises; the port writes the empty frame that finish()
    # writes for an encoder that saw no write.
    with pytest.raises(ValueError):
        ref_frame.compress(b"")
    f = frame.compress(b"")
    assert f == _stream(ref_frame.FrameEncoder, None, b"")
    assert frame.decompress(f) == b""


def test_host_encoder_content_size_mismatch_raises():
    enc = FrameEncoder(io.BytesIO(), _pfi(content_size=10))
    enc.write(b"abc")
    with pytest.raises(FE.ContentLengthError):
        enc.finish()


def _mesh1():
    return codec_mesh(jax.devices()[:1])


DEVICE_CASES = {
    "1m_independent": (dict(block_size=BlockSize.Max1MB), BIG),
    "1m_linked_checksums": (dict(block_size=BlockSize.Max1MB, block_mode=BlockMode.Linked,
                                 block_checksums=True, content_checksum=True), BIG),
    "4m_linked": (dict(block_size=BlockSize.Max4MB, block_mode=BlockMode.Linked,
                       content_checksum=True), BIG[:1200000]),
    "legacy": (dict(legacy_frame=True), BIG[:1200000]),
    "1m_stored": (dict(block_size=BlockSize.Max1MB), incompressible(600000, seed=43)),
}


@pytest.mark.parametrize("name", sorted(DEVICE_CASES))
def test_compress_frame_device_equals_jax(name):
    from lz4_flex_tpu.frame.device import compress_frame_device as ref_compress

    kw, data = DEVICE_CASES[name]
    want = ref_compress(data, FrameInfo(**kw), mesh=_mesh1())
    got = compress_frame_device(data, _pfi(**kw), device="cpu")
    assert got == want
    assert frame.decompress(got) == data == ref_frame.decompress(got)


@pytest.mark.parametrize("name", ["1m_linked_checksums", "4m_linked", "legacy"])
def test_device_encoder_equals_jax(name):
    kw, data = DEVICE_CASES[name]
    want = _stream(ref_frame.FrameEncoder, FrameInfo(**kw), data, flush_at=400_000,
                   engine="device", mesh=_mesh1())
    got = _stream(FrameEncoder, _pfi(**kw), data, flush_at=400_000, engine="device", device="cpu")
    assert got == want
    assert frame.decompress(got) == data


def test_codec_compress_equals_jax():
    from lz4_flex_tpu.models import CodecConfig as RefConfig
    from lz4_flex_tpu.models import LZ4Codec as RefCodec

    kw = dict(block_size=BlockSize.Max1MB, block_mode=BlockMode.Linked, content_checksum=True)
    want = RefCodec(RefConfig(**kw), mesh=_mesh1()).compress(BIG)
    codec = LZ4Codec(CodecConfig(**{k: _port_enum(v) for k, v in kw.items()}), device="cpu")
    got = codec.compress(BIG)
    assert got == want
    assert codec.decompress(got) == BIG


@pytest.mark.parametrize("size", [BlockSize.Max64KB, BlockSize.Max256KB])
def test_small_device_blocks_raise(size):
    # These blocks raised NotImplementedError until the all-device encoder
    # was ported; now every device entry point writes the JAX package's bytes.
    from lz4_flex_tpu.frame.device import compress_frame_device as ref_compress
    from lz4_flex_tpu.parallel.pipeline import encode_blocks_sharded

    want = ref_compress(SOUP, FrameInfo(block_size=size), mesh=_mesh1())
    assert compress_frame_device(SOUP, _pfi(block_size=size), device="cpu") == want
    assert _stream(FrameEncoder, _pfi(block_size=size), SOUP, engine="device", device="cpu") == want
    payloads, lens, window = encode_blocks(SOUP, size.get_size(), device="cpu")
    assert (payloads, lens) == encode_blocks_sharded(SOUP, size.get_size(), mesh=_mesh1())
    assert window == b""
    if size == BlockSize.Max64KB:
        assert LZ4Codec(device="cpu").compress(SOUP) == want  # the default config
    assert frame.decompress(want) == SOUP


def test_encode_blocks_linked_carry():
    payloads, lens, after = encode_blocks(BIG, 1 << 20, linked=True, carry=SOUP, device="cpu")
    window = SOUP[-KB64:]
    pos = 0
    for comp, blen in zip(payloads, lens):
        assert R._native.decompress_block(comp, blen, window) == BIG[pos : pos + blen]
        window = (window + BIG[pos : pos + blen])[-KB64:]
        pos += blen
    assert pos == len(BIG)
    assert after == window == BIG[-KB64:]
    assert encode_blocks(BIG[:600000], 1 << 20, carry=SOUP, device="cpu")[2] == b""


# -- FrameDecoder ------------------------------------------------------------


def _read(f: bytes, engine: str) -> bytes:
    kw = {"device": "cpu"} if engine == "device" else {}
    return FrameDecoder(io.BytesIO(f), engine=engine, **kw).read_all()


ENGINES = ["host", "device"]


def _ref_compress(data: bytes, **kw) -> bytes:
    return ref_frame.compress(data, FrameInfo(**kw))


@pytest.fixture
def ring_calls(monkeypatch):
    """Counts the ring kernel's wrapper calls (one per batch). On the CPU the
    wrapper runs the plain version, which adds nothing to the launch
    counters, so the tests count calls instead."""
    real = R.ring_decode
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(R, "ring_decode", counted)
    return calls


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", [BlockMode.Independent, BlockMode.Linked])
def test_decoder_multibatch(monkeypatch, ring_calls, engine, mode):
    monkeypatch.setattr(FrameDecoder, "DEVICE_BATCH_BLOCKS", 4)
    f = _ref_compress(SOUP, block_size=BlockSize.Max64KB, block_mode=mode)
    before = dict(R.stats)
    assert _read(f, engine) == SOUP
    # 11 blocks in batches of 4: three kernel calls, none overflowed; the
    # host's plan counters move with the plans built
    assert ring_calls[0] == (3 if engine == "device" else 0)
    host = ("plan_builds", "plan_pool_misses", "upload_bytes")
    assert {k: v for k, v in R.stats.items() if k not in host} == {
        k: v for k, v in before.items() if k not in host}
    assert R.stats["plan_builds"] - before["plan_builds"] >= ring_calls[0]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", [BlockMode.Independent, BlockMode.Linked])
def test_decoder_host_frames_with_checksums(engine, mode):
    f = _ref_compress(SOUP[:400000], block_size=BlockSize.Max64KB, block_mode=mode,
                      block_checksums=True, content_checksum=True)
    assert _read(f, engine) == SOUP[:400000]


@pytest.mark.parametrize("engine", ENGINES)
def test_decoder_checksums_content_size_and_flip(engine):
    data = SOUP[:200000]
    f = _ref_compress(data, block_size=BlockSize.Max64KB, block_checksums=True,
                      content_checksum=True, content_size=len(data))
    assert _read(f, engine) == data
    bad = bytearray(f)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(FE.FrameError):
        _read(bytes(bad), engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_decoder_flushed_short_blocks(engine):
    f = _stream(ref_frame.FrameEncoder, FrameInfo(block_size=BlockSize.Max64KB,
                                                  block_mode=BlockMode.Linked),
                SOUP[:300000], chunk=1000, flush_at=5000)
    assert _read(f, engine) == SOUP[:300000]


@pytest.mark.parametrize("engine", ENGINES)
def test_decoder_stored_blocks(engine):
    data = incompressible(70000, seed=44) + SOUP[:100000]
    for mode in (BlockMode.Independent, BlockMode.Linked):
        f = _ref_compress(data, block_size=BlockSize.Max64KB, block_mode=mode)
        assert _read(f, engine) == data


@pytest.mark.parametrize("engine", ENGINES)
def test_decoder_empty_concatenated_and_legacy(engine):
    empty = _ref_compress(b"", block_size=BlockSize.Max64KB)
    assert _read(empty, engine) == b""
    legacy = _ref_compress(SOUP[:150000], legacy_frame=True)
    assert _read(legacy, engine) == SOUP[:150000]
    a = _ref_compress(SOUP[:30000], block_size=BlockSize.Max64KB)
    b = _ref_compress(SOUP[30000:200000], block_mode=BlockMode.Linked)
    f = empty + a + legacy + b + legacy
    assert _read(f, engine) == SOUP[:30000] + SOUP[:150000] + SOUP[30000:200000] + SOUP[:150000]
    assert ref_frame.decompress(f) == _read(f, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_decoder_frame_boundary_contract(engine):
    a, b = _ref_compress(SOUP[:100000]), _ref_compress(SOUP[100000:150000])
    kw = {"device": "cpu"} if engine == "device" else {}
    dec = FrameDecoder(io.BytesIO(a + b), engine=engine, **kw)
    assert dec.readall() == SOUP[:100000]  # read returns 0 at the frame's end
    assert dec.frame_info is None
    assert dec.readall() == SOUP[100000:150000]
    assert dec.readall() == b""


def _with_empty_blocks(f: bytes, at: int, count: int = 2) -> bytes:
    """Frame ``f`` (no block checksums) with ``count`` zero-size stored
    blocks inserted before its block number ``at``."""
    pos = len(FrameInfo(block_size=BlockSize.Max64KB).write())
    for _ in range(at):
        (word,) = struct.unpack_from("<I", f, pos)
        pos += 4 + (word & 0x7FFFFFFF)
    return f[:pos] + struct.pack("<I", 0x80000000) * count + f[pos:]


def test_decoder_sync_fallback_mid_pipeline(monkeypatch):
    """A batch that launches nothing (here: two zero-size stored blocks)
    while a batch is in flight is stashed for the synchronous path and the
    in-flight batch is flushed; the flush must not drop the stash."""
    monkeypatch.setattr(FrameDecoder, "DEVICE_BATCH_BLOCKS", 2)
    real = FrameDecoder._decode_parts_device
    sync = []

    def counted(self, parts, sizes):
        sync.append(len(parts))
        return real(self, parts, sizes)

    monkeypatch.setattr(FrameDecoder, "_decode_parts_device", counted)
    f = _with_empty_blocks(_ref_compress(SOUP[:400000], block_size=BlockSize.Max64KB), at=2)
    assert _read(f, "device") == SOUP[:400000]
    assert sync == [2]  # the empty batch, taken from the stash
    assert ref_frame.FrameDecoder(io.BytesIO(f), engine="device").read_all() == SOUP[:400000]


def test_decoder_pipelined_batches(monkeypatch, ring_calls):
    monkeypatch.setattr(FrameDecoder, "DEVICE_BATCH_BLOCKS", 2)
    fi = dict(block_size=BlockSize.Max64KB, content_checksum=True)
    f = _ref_compress(SOUP[:300000], **fi) + _ref_compress(SOUP[:10000], **fi)
    dec = FrameDecoder(io.BytesIO(f), engine="device", device="cpu")
    assert dec.read_all() == SOUP[:300000] + SOUP[:10000]
    assert ring_calls[0] == 3 + 1  # 5 blocks in 2s, then 1
    assert dec._pending is None


@pytest.mark.parametrize("budget", ["DEVICE_BATCH_BYTES", "DEVICE_BATCH_DECODED_BYTES"])
def test_decoder_batch_budgets(monkeypatch, ring_calls, budget):
    # A byte budget closes a batch before the block budget does: a batch
    # closes once it holds more than 100,000 payload bytes, or at least
    # 100,000 projected decoded bytes (64 KiB per compressed block).
    monkeypatch.setattr(FrameDecoder, budget, 100000)
    f = _ref_compress(SOUP, block_size=BlockSize.Max64KB)
    assert _read(f, "device") == SOUP
    assert ring_calls[0] == (4 if budget == "DEVICE_BATCH_BYTES" else 6)


@pytest.fixture
def plan_builds(monkeypatch):
    """Plans of more than two parts overflow; records the parts of each build."""
    real = R.build_ring_plan_parts
    builds = []

    def small_only(parts, total_out, **kw):
        builds.append(len(parts))
        return (None, None) if len(parts) > 2 else real(parts, total_out, **kw)

    monkeypatch.setattr(R, "build_ring_plan_parts", small_only)
    return builds


@pytest.mark.parametrize("mode", [BlockMode.Independent, BlockMode.Linked])
def test_decoder_overflow_stays_counted(monkeypatch, ring_calls, plan_builds, mode):
    """A batch whose plan overflows splits into smaller plans, each decoded
    by the kernel, counted in overflow_splits; nothing decodes on the host,
    and each plan is built and each block size-walked once."""
    monkeypatch.setattr(FrameDecoder, "DEVICE_BATCH_BLOCKS", 4)
    measured = []
    real_measure = R._native.measure_block
    monkeypatch.setattr(R._native, "measure_block", lambda p: measured.append(1) or real_measure(p))
    f = _ref_compress(SOUP[:300000], block_size=BlockSize.Max64KB, block_mode=mode)
    before = dict(R.stats)
    assert _read(f, "device") == SOUP[:300000]
    assert len(measured) == 5  # 5 blocks in batches of 4 and 1
    assert R.stats["overflow_fused_decodes"] == before["overflow_fused_decodes"]
    if mode == BlockMode.Independent:
        # [4] overflows -> [2] [2]; then [1]
        assert plan_builds == [4, 2, 2, 1]
        assert R.stats["overflow_splits"] == before["overflow_splits"] + 1
    else:
        # the window rides ahead as one more part: [4] -> [2], [w+2] -> [w+1] [w+1]; then [w+1]
        assert plan_builds == [4, 2, 3, 2, 2, 2]
        assert R.stats["overflow_splits"] == before["overflow_splits"] + 2
    assert ring_calls[0] == len([n for n in plan_builds if n <= 2])


@pytest.mark.parametrize("mode", [BlockMode.Independent, BlockMode.Linked])
def test_decoder_single_block_overflow_raises(monkeypatch, ring_calls, mode):
    """A one-step NFMAX ladder: even one 64 KiB block's plan overflows. Every
    batch splits down to single blocks, and each block decodes through the
    expansion engine on the device (its window ahead of it in linked mode):
    nothing raises, and nothing decodes on the host."""
    monkeypatch.setattr(R, "NFMAX_STEPS", (1,))
    monkeypatch.setattr(R, "NFMAX_RETRY", 1)
    monkeypatch.setattr(R, "_nfmax_hint", [1])
    f = _ref_compress(SOUP[:300000], block_size=BlockSize.Max64KB, block_mode=mode)
    assert _read(f, "host") == SOUP[:300000]
    monkeypatch.setattr(R._native, "decompress_block", None)  # any host decode would raise
    before = dict(R.stats)
    assert _read(f, "device") == SOUP[:300000]
    # 5 blocks, one batch: [5] -> [2] [3] -> [1] [1] | [1] [2] -> [1] [1]
    assert R.stats["overflow_fused_decodes"] == before["overflow_fused_decodes"] + 5
    assert R.stats["overflow_splits"] == before["overflow_splits"] + 4
    assert ring_calls[0] == 0


def _zero_stored_frame() -> bytes:
    """A frame whose first block is a zero-size stored block."""
    fi = FrameInfo(block_size=BlockSize.Max64KB, content_checksum=True)
    body = ref_frame.compress(SOUP[:100000], fi)
    head = len(fi.write())
    return body[:head] + struct.pack("<I", 0x80000000) + body[head:]


@pytest.mark.parametrize("engine", ENGINES)
def test_decoder_zero_size_stored_block_equals_jax(engine):
    f = _zero_stored_frame()
    want = ref_frame.FrameDecoder(io.BytesIO(f), engine=engine).read_all()
    assert want == SOUP[:100000]
    assert _read(f, engine) == want
    # reads of the stream, one call at a time, agree as well
    kw = {"device": "cpu"} if engine == "device" else {}
    got_reads, want_reads = [], []
    for dec, out in ((FrameDecoder(io.BytesIO(f), engine=engine, **kw), got_reads),
                     (ref_frame.FrameDecoder(io.BytesIO(f), engine=engine), want_reads)):
        for _ in range(8):
            out.append(len(dec.read(70000)))
    assert got_reads == want_reads


def test_device_stream_roundtrip():
    # the device encoder's frames read back on the device decoder
    f = _stream(FrameEncoder, _pfi(block_size=BlockSize.Max1MB, block_mode=BlockMode.Linked,
                                   content_checksum=True), BIG, engine="device", device="cpu")
    assert _read(f, "device") == BIG
