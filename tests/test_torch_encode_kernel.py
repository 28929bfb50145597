"""The all-device encode kernel (csrc/encode_rows.cu) against its plain
version, ``encode_chunk_core_reference``.

On the CPU: what the wrapper refuses before any launch, and that CPU tensors
take the plain torch ops and launch nothing. On the card (skips without one;
imports no JAX, so it runs there with ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_encode_kernel.py``): the kernel's
whole (B, comp_pad) outputs and totals equal the plain version's on the same
card tensors, byte for byte, at every row geometry the frame encoders use,
padding rows and a fingerprint collision included, and one launch a group.
"""

import numpy as np
import pytest
import torch

from lz4_flex_tpu_torch import frame, native
from lz4_flex_tpu_torch.models import LZ4Codec
from lz4_flex_tpu_torch.ops import _kernels as K
from lz4_flex_tpu_torch.ops import encode as E
from lz4_flex_tpu_torch.ops import ringdecode as R
from lz4_flex_tpu_torch.parallel import pipeline as PP
from lz4_flex_tpu_torch.parallel.pipeline import encode_geometry

from .torch_inputs import block_inputs, collision_input, word_soup

GEO = encode_geometry(98304, 65536)  # the 64 KiB frame blocks' rows
KINDS = ("word_soup", "periodic_ring_boundary", "incompressible", "rle")
# (row width, dictionary bytes, block bytes): 64 KiB blocks alone and after a
# short dictionary, linked 64 KiB blocks, 256 KiB blocks
SHAPES = {
    "64k": (98304, 0, 65536),
    "64k_dict": (98304, 5000, 60000),
    "64k_linked": (196608, 65536, 65536),
    "256k": (393216, 0, 262144),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores; torch's thread pool would oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(shape: str, nrows: int, npad: int):
    """``nrows`` rows of the shape, the four kinds in turn at shifted
    offsets, the last ``npad`` of them padding rows (n = 0)."""
    width, dlen, blen = SHAPES[shape]
    inputs = block_inputs()
    rows = np.zeros((nrows, width), np.uint8)
    d = np.zeros(nrows, np.int32)
    n = np.zeros(nrows, np.int32)
    for i in range(nrows - npad):
        data = inputs[KINDS[i % len(KINDS)]]
        need = dlen + blen + 997 * i
        data = (data * -(-need // len(data)))[997 * i : need]
        rows[i, : len(data)] = np.frombuffer(data, np.uint8)
        d[i], n[i] = dlen, len(data)
    return rows, d, n


def _encode_both(rows, d, n, geo, dev):
    """The kernel (through ``encode_chunk_core``) and the plain version on
    the same tensors of ``dev``, and the launches the first took."""
    u8 = torch.from_numpy(rows).to(dev)
    dt, nt = torch.from_numpy(d).to(dev), torch.from_numpy(n).to(dev)
    before = E.stats["encode_launches"]
    got = E.encode_chunk_core(u8, u8.view(torch.int32), dt, nt, **geo)
    launches = E.stats["encode_launches"] - before
    want = E.encode_chunk_core_reference(u8, u8.view(torch.int32), dt, nt, **geo)
    return got, want, launches


@pytest.mark.parametrize("case, match", [
    ("rows int32", "2-D uint8"),
    ("rows 1-D", "2-D uint8"),
    ("width not a multiple of 4", "multiple of 4"),
    ("words int64", "words must be int32"),
    ("words of another shape", "words must be int32"),
    ("lengths int64", "lengths must be int32"),
    ("dictionary lengths of another count", "dictionary lengths must be int32"),
    ("rows not contiguous", "contiguous"),
    ("levels 1", "levels"),
    ("comp_pad 0", "comp_pad"),
    ("nseq_pad 0", "nseq_pad"),
    ("CPU tensors", "CUDA card"),
])
def test_kernel_wrapper_refuses(case, match):
    u8 = torch.zeros((2, 64), dtype=torch.uint8)
    words = torch.zeros((2, 16), dtype=torch.int32)
    d, n = torch.zeros(2, dtype=torch.int32), torch.full((2,), 40, dtype=torch.int32)
    kw = dict(levels=12, comp_pad=4096, nseq_pad=256)
    if case == "rows int32":
        u8 = u8.to(torch.int32)
    elif case == "rows 1-D":
        u8 = u8[0]
    elif case == "width not a multiple of 4":
        u8 = u8[:, :62]
    elif case == "words int64":
        words = words.long()
    elif case == "words of another shape":
        words = words[:, :8]
    elif case == "lengths int64":
        n = n.long()
    elif case == "dictionary lengths of another count":
        d = d[:1]
    elif case == "rows not contiguous":
        u8 = torch.zeros((2, 128), dtype=torch.uint8)[:, ::2]
    elif case == "levels 1":
        kw["levels"] = 1
    elif case == "comp_pad 0":
        kw["comp_pad"] = 0
    elif case == "nseq_pad 0":
        kw["nseq_pad"] = 0
    before = dict(E.stats)
    with pytest.raises(ValueError, match=match):
        E.encode_rows_kernel(u8, words, d, n, **kw)
    assert E.stats == before


def test_cpu_rows_take_the_plain_version_and_launch_nothing():
    geo = encode_geometry(8192, 4096)
    data, dic = word_soup(4096, seed=160), word_soup(2000, seed=161)
    rows = np.zeros((3, 8192), np.uint8)
    rows[0, :4096] = np.frombuffer(data, np.uint8)
    rows[1, :6096] = np.frombuffer(dic + data, np.uint8)
    d, n = np.array([0, 2000, 0], np.int32), np.array([4096, 6096, 0], np.int32)
    before = dict(E.stats)
    got, want, launches = _encode_both(rows, d, n, geo, "cpu")
    assert launches == 0 and E.stats["encode_rows"] == before["encode_rows"]
    # each version ran match_core and emit_core once
    assert E.stats["match_calls"] == before["match_calls"] + 2
    assert E.stats["emit_calls"] == before["emit_calls"] + 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    out, total = got
    assert native.decompress_block(out[1, : int(total[1])].numpy().tobytes(), 4096, dic) == data
    assert int(total[2]) == 1 and not out[2].any()  # a padding row: one empty token


@pytest.fixture
def card():
    if not R.ring_engine_available():
        pytest.skip("needs a CUDA card of compute capability 9.0+")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nrows, npad", [(1, 0), (7, 2), (32, 2)])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_equals_plain(card, shape, nrows, npad):
    rows, d, n = _rows(shape, nrows, npad)
    width, _, blen = SHAPES[shape]
    (out, total), (w_out, w_total), launches = _encode_both(rows, d, n,
                                                            encode_geometry(width, blen), card)
    assert launches == 1
    assert torch.equal(total.cpu(), w_total.cpu()) and torch.equal(out.cpu(), w_out.cpu())
    for i in range(nrows - npad):
        assert native.verify_block(out[i, : int(total[i])].cpu().numpy().tobytes(),
                                   rows[i, d[i] : n[i]], rows[i, : d[i]])


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [1, 2, 3, 4])
def test_kernel_equals_plain_at_every_cluster_size(card, monkeypatch, ranks):
    # the launch picks the CTAs a row from the row count; each count gives
    # the same bytes
    monkeypatch.setattr(K, "encode_rows_ranks", lambda nrows: ranks)
    rows, d, n = _rows("64k_dict", 7, 1)
    (out, total), (w_out, w_total), launches = _encode_both(rows, d, n, GEO, card)
    assert launches == 1
    assert torch.equal(total.cpu(), w_total.cpu()) and torch.equal(out.cpu(), w_out.cpu())


@pytest.mark.cuda
def test_kernel_meets_the_fingerprint_collision(card):
    data = collision_input()
    rows = np.zeros((1, 98304), np.uint8)
    rows[0, : len(data)] = np.frombuffer(data, np.uint8)
    d, n = np.zeros(1, np.int32), np.array([len(data)], np.int32)
    (out, total), (w_out, w_total), _ = _encode_both(rows, d, n, GEO, card)
    assert torch.equal(total.cpu(), w_total.cpu()) and torch.equal(out.cpu(), w_out.cpu())
    cpu_out, cpu_total = E.encode_chunk_core(*(torch.from_numpy(a) for a in (rows, rows.view(np.int32),
                                                                             d, n)), **GEO)
    assert torch.equal(out.cpu(), cpu_out) and torch.equal(total.cpu(), cpu_total)
    raw = out[0, : int(total[0])].cpu().numpy().tobytes()
    assert not native.verify_block(raw, data)  # the guard's case, as on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("group", [32, 8])
def test_compress_launches_once_a_group(card, monkeypatch, group):
    monkeypatch.setattr(PP, "_ENCODE_ROWS", group)
    data = word_soup(2 << 20, seed=162)
    before = dict(E.stats)
    f = LZ4Codec().compress(data)
    groups = -(-32 // group)
    assert E.stats["encode_launches"] == before["encode_launches"] + groups
    assert E.stats["encode_rows"] == before["encode_rows"] + 32
    assert E.stats["match_calls"] == before["match_calls"] + groups
    assert E.stats["emit_calls"] == before["emit_calls"] + groups
    assert frame.decompress(f) == data
