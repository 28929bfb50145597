"""The `lz4` command line's default frame on the port (lz4 v1.9.4,
`programs/lz4io.c:LZ4IO_defaultPreferences`): 4 MiB independent blocks and a
content checksum, through ``LZ4Codec(CodecConfig(block_size=BlockSize.Max4MB,
content_checksum=True))`` on ``device="cpu"``.

Held to the benchmark's plain reference decoder and frozen encoder
(``portbench/reference/lz4_ref.py``, ``portbench/gen/frozen.py``), which
share no code with the port: decodes of frames the frozen encoder wrote,
the refusal of a frame whose stored checksum was altered, a hybrid encode
the reference decodes, the counters and the spans of this deployment."""

import io
import struct

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from lz4_flex_tpu_torch.frame import FrameDecoder, errors
from lz4_flex_tpu_torch.frame.header import BlockSize
from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec
from lz4_flex_tpu_torch.ops import encode as E
from lz4_flex_tpu_torch.ops import ringdecode as R
from lz4_flex_tpu_torch.utils import trace
from portbench.gen import frozen
from portbench.reference import lz4_ref

from .torch_inputs import word_soup

BLOCK = 4 << 20
FRAME = dict(block_size=BLOCK, block_mode="independent", block_checksums=False,
             content_checksum=True, content_size=False)
TEXT = np.frombuffer(word_soup(BLOCK + (64 << 10), seed=15, vocab=50_000, zipf=1.0), np.uint8)
# 1,300,000 bytes are 3 of the hybrid encoder's 512 KiB chunk rows
ENCODE_SIZE = 1_300_000


@pytest.fixture(scope="module")
def codec():
    return LZ4Codec(CodecConfig(block_size=BlockSize.Max4MB, content_checksum=True), device="cpu")


def _decoders(codec):
    return {"one-shot": codec.decompress,
            "streaming": lambda f: FrameDecoder(io.BytesIO(f), engine="device", device="cpu").read_all()}


def _frozen_frame(n: int) -> bytes:
    return frozen.frame(TEXT[:n], block_size=BLOCK, content_checksum=True)


def _altered(frame: bytes) -> bytes:
    (stored,) = struct.unpack_from("<I", frame, len(frame) - 4)
    return frame[:-4] + struct.pack("<I", stored ^ 0x00010001)


@pytest.mark.parametrize("n", [1 << 20, BLOCK + (64 << 10)], ids=["one-block", "two-blocks"])
def test_decode_equals_the_text_and_the_reference(codec, n):
    frame = _frozen_frame(n)
    hdr, content, sizes = lz4_ref.decode_frame(frame)
    assert content == TEXT[:n].tobytes() and hdr["content_checksum_value"] == frozen.xxh32(content)
    assert sizes == [min(BLOCK, n - i) for i in range(0, n, BLOCK)]
    before = R.stats["content_checksums"]
    assert codec.decompress(frame) == content
    assert R.stats["content_checksums"] == before + 1


@pytest.mark.parametrize("decoder", ["one-shot", "streaming"])
def test_an_altered_content_checksum_is_refused(codec, decoder):
    frame = _frozen_frame(200_000)
    decode = _decoders(codec)[decoder]
    before = R.stats["content_checksums"]
    assert decode(frame) == TEXT[:200_000].tobytes()
    with pytest.raises(errors.ContentChecksumError):
        decode(_altered(frame))
    assert R.stats["content_checksums"] == before + 2


def test_hybrid_encode_is_read_by_the_reference(codec):
    data = TEXT[:ENCODE_SIZE].tobytes()
    before = dict(E.stats)
    frame = codec.compress(data)
    hdr, content, sizes = lz4_ref.decode_frame(frame)
    assert content == data and sizes == [ENCODE_SIZE]
    assert lz4_ref.check_frame(frame, data, FRAME, frozen.xxh32(data)) == {
        "frames_bad": 0, "header_mismatch": 0, "wrong_bytes": 0}
    assert hdr["content_checksum_value"] == frozen.xxh32(data)
    grew = {k: E.stats[k] - before[k] for k in before}
    assert grew["hybrid_blocks"] == 1 and grew["hybrid_chunks"] == 3
    assert grew["plane_quads"] >= 1 and grew["match_calls"] == 0
    assert len(frame) < 0.7 * len(data)


def test_the_spans_carry_their_request_ids(codec):
    data = TEXT[:ENCODE_SIZE].tobytes()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        frame = codec.compress(data)
        assert codec.decompress(frame) == data
    recs = trace.records()
    roots = {r[0]: r[1] for r in recs if r[2] == -1 and r[1] > 0}
    assert set(roots) == {"codec.compress", "codec.decompress"}
    by_name = {}
    for name, rid, *_ in recs:
        by_name.setdefault(name, set()).add(rid)
    for name in ("enc.hybrid", "enc.planes", "enc.stitch"):
        assert by_name[name] == {roots["codec.compress"]}, name
    assert by_name["enc.walk"] == {-1}  # walks run on the pool's threads
    assert sum(1 for r in recs if r[0] == "enc.walk") == 3
    assert by_name["frame.xxh"] == {roots["codec.compress"], roots["codec.decompress"]}
    walks = [r for r in recs if r[0] == "enc.walk"]
    hybrid = next(r for r in recs if r[0] == "enc.hybrid")
    assert all(hybrid[4] <= w[4] and w[5] <= hybrid[5] for w in walks)
