"""The resident decode kernel's wrapper on the CPU: what it refuses before any
launch, and that CPU tensors take the plain torch ops and launch nothing. The
kernel itself is held to the plain version on the card (tests/test_torch_cuda.py)."""

import pytest
import torch

from lz4_flex_tpu_torch.models import LZ4Codec
from lz4_flex_tpu_torch.ops import decode as D
from lz4_flex_tpu_torch.ops import ringdecode as R
from lz4_flex_tpu_torch.parallel import pipeline as PP

from .torch_inputs import block_rows

KW = dict(out_pad=65536, nseq_pad=24576)


def _rows(nrows=3):
    rows, lens, text = block_rows(nrows, seed=140)
    return torch.from_numpy(rows), torch.from_numpy(lens), text


@pytest.mark.parametrize("case, match", [
    ("rows int32", "2-D uint8"),
    ("rows 1-D", "2-D uint8"),
    ("lengths int64", "int32"),
    ("lengths of another count", "int32"),
    ("row not contiguous", "contiguous"),
    ("lengths not contiguous", "contiguous"),
    ("empty row width", "row width"),
    ("out_pad not a multiple of 16", "multiple of 16"),
    ("nseq_pad 0", "nseq_pad positive"),
    ("CPU tensors", "CUDA card"),
])
def test_kernel_wrapper_refuses(case, match):
    u8, n = torch.zeros((2, 64), dtype=torch.uint8), torch.ones(2, dtype=torch.int32)
    kw = dict(KW)
    if case == "rows int32":
        u8 = u8.to(torch.int32)
    elif case == "rows 1-D":
        u8 = u8[0]
    elif case == "lengths int64":
        n = n.long()
    elif case == "lengths of another count":
        n = n[:1]
    elif case == "row not contiguous":
        u8 = torch.zeros((2, 128), dtype=torch.uint8)[:, ::2]
    elif case == "lengths not contiguous":
        n = torch.ones(4, dtype=torch.int32)[::2]
    elif case == "empty row width":
        u8 = u8[:, :0]
    elif case == "out_pad not a multiple of 16":
        kw["out_pad"] = 65530
    elif case == "nseq_pad 0":
        kw["nseq_pad"] = 0
    before = dict(R.stats)
    with pytest.raises(ValueError, match=match):
        D.resident_decode_kernel(u8, n, **kw)
    assert R.stats == before


def test_cpu_rows_take_the_plain_version_and_launch_nothing():
    u8, n, text = _rows()
    before = dict(R.stats)
    got = D.decode_resident_rows(u8, n, **KW)
    want = D.decode_resident_rows_reference(u8, n, **KW)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    one = D.decode_resident_core(u8[1], int(n[1]), **KW)
    for g, w in zip(one, want):
        assert torch.equal(g, w[1])
    step = LZ4Codec(device="cpu").decode_step(u8, n)
    batch = PP._decode_batch(u8, n, **KW)
    for s, b, w in zip(step, batch, want):
        assert torch.equal(s, w) and torch.equal(b, w)
    assert R.stats["resident_launches"] == before["resident_launches"]
    assert R.stats["resident_rows"] == before["resident_rows"]
    assert got[0].numpy().tobytes() == text and (got[1] == 65536).all() and not got[2].any()


def test_unknown_expand_engine_raises_on_cpu_rows():
    u8, n, _ = _rows(1)
    with pytest.raises(ValueError, match="unknown expand engine"):
        D.decode_resident_rows(u8, n, **KW, expand_engine="v3")
