"""The port's on-device parsers and resident decode (on the CPU) against the
JAX package's, bit for bit: the same seeded payloads go through
parse_core, parse_walk_core and parse_strided_core (4 and 8 lanes) on both
sides, and their tables, counts and flags must be equal over the whole
padded length; decode_resident_core (both parse engines, both expansion
engines) and LZ4Codec.decode_step must give equal bytes, lengths and flags.
Malformed payloads raise the host parser's exception type, as in JAX, and
a seeded corruption sweep must raise the same type or give the same result
on both sides.

The JAX functions run under jit at fixed padded shapes, so each compiles
once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_flex_tpu.block import errors as JAX_E
from lz4_flex_tpu.frame import BlockSize as JBlockSize
from lz4_flex_tpu.models import CodecConfig as JCodecConfig
from lz4_flex_tpu.models import LZ4Codec as JLZ4Codec
from lz4_flex_tpu.ops import decode as JD
from lz4_flex_tpu.ops import parse as JP
from lz4_flex_tpu_torch import native
from lz4_flex_tpu_torch.block import errors as E
from lz4_flex_tpu_torch.frame import BlockSize
from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec
from lz4_flex_tpu_torch.ops import decode as TD
from lz4_flex_tpu_torch.ops import packing as TK
from lz4_flex_tpu_torch.ops import parse as TP
from lz4_flex_tpu_torch.ops.sequences import parse_sequences_host

from .torch_inputs import incompressible, word_soup

PAD = 32768  # payload bytes, zero-padded
NSEQ_PAD = TK.size_bucket(PAD // 3 + 2, minimum=256)
OUT_PAD = 65536


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and with several test workers on the same cores, torch's thread pool
    oversubscribes them (each tiny op then waits on its threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payloads() -> dict:
    comp = {
        "soup": native.compress_block(word_soup(30000, seed=61)),
        "rle": native.compress_block(b"a" * 40000 + b"ab" * 3000),
        "random_8": native.compress_block(
            np.random.default_rng(62).integers(0, 8, 20000, dtype=np.uint8).tobytes()),
        "incompressible": native.compress_block(incompressible(5000, seed=63)),
        "tiny": native.compress_block(b"hello world, hello world!"),
        "one_byte": native.compress_block(b"A"),
        "long_literal_lsic": native.compress_block(incompressible(300, seed=64) + b"z" * 2000),
    }
    malformed = {
        "literal_past_end": bytes([0x40]),
        "one_literal": bytes([0x10, 0x41]),  # test_ops.py's "missing offset": a valid final literal
        "offset_zero": bytes([0x12, 0x41, 0x00, 0x00]),
        "lsic_truncated": bytes([0xF0, 0xFF, 0xFF]),
        "lsic_to_bucket": bytes([0xF0] + [0xFF] * 4095),
    }
    return {**comp, **malformed}


PAYLOADS = _payloads()

_J_PARSE = {
    "doubling": jax.jit(JP.parse_core, static_argnames=("nseq_pad",)),
    "walk": jax.jit(JP.parse_walk_core, static_argnames=("nseq_pad",)),
}
_T_PARSE = {"doubling": TP.parse_core, "walk": TP.parse_walk_core}
_J_STRIDED = jax.jit(JP.parse_strided_core, static_argnames=("lanes",))
_J_RESIDENT = jax.jit(JD.decode_resident_core,
                      static_argnames=("out_pad", "nseq_pad", "parse_engine", "expand_engine"))


def _padded(payload: bytes) -> np.ndarray:
    return TK.pad_to(np.frombuffer(payload, np.uint8), PAD)


def _equal(got, want, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{what} output {i}")


@pytest.mark.parametrize("engine", ["doubling", "walk"])
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_parse_equals_jax(name, engine):
    p = PAYLOADS[name]
    u8 = _padded(p)
    want = _J_PARSE[engine](jnp.asarray(u8), jnp.int32(len(p)), nseq_pad=NSEQ_PAD)
    got = _T_PARSE[engine](torch.from_numpy(u8.copy()), len(p), nseq_pad=NSEQ_PAD)
    assert len(got) == 8
    _equal(got, want, f"{name} {engine}")
    try:
        seq = parse_sequences_host(p)
    except E.DecompressError:
        assert bool(got[7].any())
        return
    assert not bool(got[7].any())
    assert int(got[5]) == seq.nseq and int(got[6]) == seq.total_out
    np.testing.assert_array_equal(got[4][: seq.nseq].numpy(), seq.out_off)


@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_parse_strided_equals_jax(name, lanes):
    p = PAYLOADS[name]
    u8 = _padded(p)
    want = _J_STRIDED(jnp.asarray(u8), jnp.int32(len(p)), lanes=lanes)
    got = TP.parse_strided_core(torch.from_numpy(u8.copy()), len(p), lanes=lanes)
    assert len(got) == 10
    _equal(got, want, f"{name} lanes={lanes}")


@pytest.mark.parametrize("engine", ["doubling", "walk"])
def test_parse_errors_match_host(engine):
    """The device parser raises the host parser's exception type, as the
    JAX package's does (tests/test_ops.py:test_parse_errors_match_host), and
    returns the host parser's table where that one does not raise."""
    for raw in [b""] + [PAYLOADS[k] for k in ("literal_past_end", "one_literal", "offset_zero",
                                               "lsic_truncated", "lsic_to_bucket")]:
        try:
            want = parse_sequences_host(raw)
        except E.DecompressError as e:
            with pytest.raises(getattr(JAX_E, type(e).__name__)):
                JP.parse_sequences_device(raw, engine=engine)
            with pytest.raises(type(e)):
                TP.parse_sequences_device(raw, engine=engine, device="cpu")
            continue
        got = TP.parse_sequences_device(raw, engine=engine, device="cpu")
        assert (got.nseq, got.total_out) == (want.nseq, want.total_out) == (1, 1)


@pytest.mark.parametrize("engine", ["doubling", "walk"])
def test_parse_sequences_device_equals_host(engine):
    for name in ("soup", "rle", "tiny", "long_literal_lsic"):
        h = parse_sequences_host(PAYLOADS[name])
        d = TP.parse_sequences_device(PAYLOADS[name], engine=engine, device="cpu")
        for f in ("lit_start", "lit_len", "match_off", "match_len", "out_off"):
            np.testing.assert_array_equal(getattr(d, f), getattr(h, f), err_msg=f"{name} {f}")
        assert d.total_out == h.total_out
    with pytest.raises(ValueError):
        TP.parse_sequences_device(PAYLOADS["tiny"], engine="nope", device="cpu")


def _resident(u8: np.ndarray, n: int, parse: str, expand: str):
    kw = dict(out_pad=OUT_PAD, nseq_pad=NSEQ_PAD, parse_engine=parse, expand_engine=expand)
    want = _J_RESIDENT(jnp.asarray(u8), jnp.int32(n), **kw)
    got = TD.decode_resident_core(torch.from_numpy(u8.copy()), n, **kw)
    return got, want


@pytest.mark.parametrize("expand", ["v1", "v2"])
@pytest.mark.parametrize("parse", ["doubling", "walk"])
def test_decode_resident_equals_jax(parse, expand):
    names = ["soup", "rle", "tiny", "offset_zero"] if parse == "walk" else sorted(PAYLOADS)
    for name in names:
        p = PAYLOADS[name]
        got, want = _resident(_padded(p), len(p), parse, expand)
        _equal(got, want, f"{name} {parse} {expand}")
        out, total, errs = got
        assert out.shape == (OUT_PAD,) and errs.shape == (5,)
        if not bool(errs.any()):
            assert out[: int(total)].numpy().tobytes() == native.decompress_block(p, OUT_PAD)
    # a match before the block start, and an output past the capacity
    bad = bytes([0x14, 0x41, 0xB8, 0x0B, 0x50]) + b"ABCDE"
    got, want = _resident(_padded(bad), len(bad), parse, expand)
    _equal(got, want, "offset_oob")
    assert got[2].tolist() == [False, False, False, True, False]
    big = native.compress_block(b"q" * 70000)
    got, want = _resident(_padded(big), len(big), parse, expand)
    _equal(got, want, "output_too_small")
    assert got[2].tolist() == [False, False, False, False, True]


def test_corruption_sweep_equals_jax():
    """Flip 1-3 bytes of a compressed block (and cut every third one short),
    40 times: the port and the JAX
    package raise the same exception type from the device parse, or return
    the same table; the resident decode gives the same bytes and flags."""
    rng = np.random.default_rng(65)
    base = bytearray(native.compress_block(word_soup(20000, seed=66, vocab=60)))  # match-heavy
    outcomes = set()
    for trial in range(40):
        c = bytearray(base)
        for pos in rng.integers(0, len(c), rng.integers(1, 4)):
            c[pos] = int(rng.integers(0, 256))
        if trial % 3 == 2:
            c = c[: int(rng.integers(len(c) // 2, len(c)))]  # and cut short
        c = bytes(c)
        results = []
        for parse in (lambda: JP.parse_sequences_device(c, engine="doubling"),
                      lambda: TP.parse_sequences_device(c, device="cpu")):
            try:
                s = parse()
                results.append(("ok", s.total_out, tuple(np.asarray(getattr(s, f)).tobytes() for f in (
                    "lit_start", "lit_len", "match_off", "match_len", "out_off"))))
            except (E.DecompressError, JAX_E.DecompressError) as e:
                results.append(("raise", type(e).__name__))
        assert results[0] == results[1]
        outcomes.add(results[0][0] if results[0][0] == "ok" else results[0][1])
        got, want = _resident(_padded(c), len(c), "doubling", "v2")
        _equal(got, want, "corrupted")
    assert len(outcomes) >= 3  # the sweep reaches several error kinds and clean parses


def test_decode_step_equals_jax():
    blocks = [word_soup(65536, seed=67), b"x" * 5000 + word_soup(20000, seed=68), b"A"]
    comps = [native.compress_block(b) for b in blocks]
    comps.append(bytes([0x12, 0x41, 0x00, 0x00]))  # offset zero: flagged, not raised
    width = TK.size_bucket(max(len(c) for c in comps) + 1)
    rows = np.zeros((len(comps), width), np.uint8)
    for i, c in enumerate(comps):
        rows[i, : len(c)] = np.frombuffer(c, np.uint8)
    lens = np.array([len(c) for c in comps], np.int32)
    want = JLZ4Codec(JCodecConfig(block_size=JBlockSize.Max64KB)).decode_step(jnp.asarray(rows),
                                                                              jnp.asarray(lens))
    got = LZ4Codec(CodecConfig(block_size=BlockSize.Max64KB), device="cpu").decode_step(rows, lens)
    _equal(got, want, "decode_step")
    out, total, errs = got
    assert out.shape == (len(comps), 65536) and total.dtype == torch.int32
    for i, b in enumerate(blocks):
        assert out[i, : int(total[i])].numpy().tobytes() == b and not bool(errs[i].any())
    assert errs[3].tolist() == [False, False, True, False, False]
