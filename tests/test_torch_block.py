"""The port's block API, its top-level re-exports, ``spec.golden`` and
``spec.xxhash32`` against the JAX package's, byte for byte: the scenarios
of tests/test_block.py and tests/test_xxhash32.py on tests/torch_inputs.py
inputs (never the corpus fixtures). Every function of JAX's block API is
called with the same arguments in both packages and must return the same
bytes or count, or raise an error of the same class name with the same
fields; into-buffer counts, the ``CompressTable`` upgrade, golden against
native, xxHash32 against JAX's, the native hash and the ``xxhash``
package. Tolerance: exact everywhere."""

import inspect
import random
import struct

import numpy as np
import pytest
import xxhash

import lz4_flex_tpu
import lz4_flex_tpu_torch
from lz4_flex_tpu import block as JB
from lz4_flex_tpu import native as JN
from lz4_flex_tpu.spec import golden as JG
from lz4_flex_tpu.spec import xxhash32 as JX
from lz4_flex_tpu_torch import block as PB
from lz4_flex_tpu_torch import native as PN
from lz4_flex_tpu_torch import spec as PS
from lz4_flex_tpu_torch.spec import golden as PG
from lz4_flex_tpu_torch.spec import xxhash32 as PX

from .torch_inputs import deep_chains, incompressible, rle_overlap, word_soup

INPUTS = {
    "empty": b"",
    "one": b"a",
    "short": b"Hello people, what's up?",
    "aaas": b"aaaaaaaaaaaaaaa",
    "nulls": bytes(30000),
    "incompressible": incompressible(5000),
    "cycle": bytes(i % 256 for i in range(70000)),
    "word_soup": word_soup(60000, seed=61),
    "deep_chains": deep_chains(40000),
    "rle_overlap": rle_overlap(),
}
DICT = word_soup(90000, seed=62)  # larger than the 64 KiB window


def _outcome(fn, *args):
    """(result, None) or (None, (error class name, its fields))."""
    try:
        return fn(*args), None
    except Exception as e:  # the error is what the caller compares
        return None, (type(e).__name__, getattr(e, "expected", None), getattr(e, "actual", None))


def _same(name: str, *args):
    """``block.<name>(*args)`` in both packages: equal results or equal errors."""
    got, want = _outcome(getattr(PB, name), *args), _outcome(getattr(JB, name), *args)
    assert got == want, (name, got[1], want[1])
    return got[0]


# -- the surface ----------------------------------------------------------------------


def test_api_surface_equals_jax():
    assert PB.__all__ == JB.__all__
    assert lz4_flex_tpu_torch.__all__ == lz4_flex_tpu.__all__
    assert PS.__all__ == ["constants", "golden", "XxHash32", "xxh32"]
    for name in JB.__all__:
        want, got = getattr(JB, name), getattr(PB, name)
        if inspect.isfunction(want):
            assert inspect.signature(got) == inspect.signature(want), name
        elif isinstance(want, type):
            assert got.__name__ == want.__name__
            assert [c.__name__ for c in got.__mro__] == [c.__name__ for c in want.__mro__]
    for name in lz4_flex_tpu.__all__:
        if name not in ("block", "frame", "__version__"):
            assert getattr(lz4_flex_tpu_torch, name) is getattr(PB, name)
    for name in ("compress", "compress_with_dict", "decompress_block"):
        assert inspect.signature(getattr(PG, name)) == inspect.signature(getattr(JG, name))


# -- one-shot -------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_one_shot_functions_equal_jax(name):
    data = INPUTS[name]
    comp = _same("compress", data)
    assert _same("decompress", comp, len(data)) == data
    assert _same("decompress", comp, len(data) + 100) == data
    pre = _same("compress_prepend_size", data)
    assert pre == struct.pack("<I", len(data)) + comp
    assert _same("decompress_size_prepended", pre) == data
    assert _same("uncompressed_size", pre) == (len(data), comp)
    assert _same("compress", np.frombuffer(data, np.uint8)) == comp  # an ndarray input


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_golden_equals_native_and_jax(name):
    data = INPUTS[name]
    comp = PB.compress(data)
    assert PG.compress(data) == comp == JG.compress(data)
    assert PG.decompress_block(comp, len(data)) == data
    tail = data[:5000]
    assert PG.compress_with_dict(tail, DICT[-65536:]) == PB.compress_with_dict(tail, DICT)
    assert PG.compress_with_dict(tail, DICT[-65536:]) == JG.compress_with_dict(tail, DICT[-65536:])


@pytest.mark.parametrize("ext", [DICT, DICT[:20], bytes([10, 12, 14]), b""],
                         ids=["over_window", "short", "three_bytes", "none"])
def test_dictionary_functions_equal_jax(ext):
    for data in (INPUTS["word_soup"][:20000], bytes([10, 12, 14, 16, 18] * 4), b"a" * 29):
        comp = _same("compress_with_dict", data, ext)
        assert _same("decompress_with_dict", comp, len(data), ext) == data
        pre = _same("compress_prepend_size_with_dict", data, ext)
        assert _same("decompress_size_prepended_with_dict", pre, ext) == data
        if len(ext) > 3:  # a usable dictionary
            out_p, out_j = bytearray(2 * len(data) + 8), bytearray(2 * len(data) + 8)
            n = PB.decompress_into_with_dict(comp, out_p, ext)
            assert n == JB.decompress_into_with_dict(comp, out_j, ext) == len(data)
            assert out_p == out_j


def test_conformant_last_block_equals_jax():
    aaas = b"a" * 15
    for n in (12, 13, 14, 15):
        assert _same("compress", aaas[:n]) == JB.compress(aaas[:n])
    for n in (11, 12, 13):
        _same("compress_with_dict", aaas[:n], aaas)


# -- into buffers -----------------------------------------------------------------------


def test_compress_into_counts_equal_jax():
    for data in (INPUTS["word_soup"], INPUTS["incompressible"], b""):
        for name, extra in (("compress_into", ()), ("compress_into_with_dict", (DICT,))):
            cap = PB.get_maximum_output_size(len(data))
            assert cap == JB.get_maximum_output_size(len(data))
            out_p, out_j = np.full(cap, 0xAA, np.uint8), np.full(cap, 0xAA, np.uint8)
            n = getattr(PB, name)(data, out_p, *extra)
            assert n == getattr(JB, name)(data, out_j, *extra)
            assert np.array_equal(out_p, out_j)
            back = PB.decompress_with_dict(out_p[:n].tobytes(), len(data), *(extra or (b"",)))
            assert back == data
            # too small, read-only, and an array of another type
            for bad in (bytearray(4), bytes(cap), np.zeros(cap, np.int32)):
                _same(name, data, bad, *extra)


def test_compress_table_upgrade_equals_jax():
    tp, tj = PB.CompressTable(), JB.CompressTable()
    assert not tp.is_large and PB.CompressTable.large().is_large and not PB.CompressTable.small().is_large
    for data in (b"hello world, hello world, hello!", bytes(range(256)) * 300,
                 INPUTS["word_soup"][:1000]):
        cap = PB.get_maximum_output_size(len(data))
        out_p, out_j = bytearray(cap), bytearray(cap)
        n = PB.compress_into_with_table(data, out_p, tp)
        assert n == JB.compress_into_with_table(data, out_j, tj)
        assert out_p == out_j and tp.is_large == tj.is_large
        assert PB.decompress(bytes(out_p[:n]), len(data)) == data
    assert tp.is_large  # upgraded by the 76,800-byte input, and stays large
    big = bytes(range(256)) * 300
    out = bytearray(PB.get_maximum_output_size(len(big)))
    n = PB.compress_into_with_table(big, out, PB.CompressTable.small())
    assert bytes(out[:n]) == PB.compress(big)
    _same("compress_into_with_table", big, bytearray(8), PB.CompressTable())


def test_decompress_into_counts_equal_jax():
    data = INPUTS["word_soup"]
    comp = PB.compress(data)
    for size in (len(data), len(data) + 100, len(data) - 1, 0):
        out_p, out_j = np.full(size, 0xFF, np.uint8), np.full(size, 0xFF, np.uint8)
        assert _outcome(PB.decompress_into, comp, out_p) == _outcome(JB.decompress_into, comp, out_j)
        assert np.array_equal(out_p, out_j)
    for bad in (bytes(len(data)), np.zeros(len(data), np.uint16)):
        _same("decompress_into", comp, bad)


def test_native_decompress_block_out_pos_equals_jax():
    data = INPUTS["word_soup"][:10000]
    comp = PN.compress_block(data)
    for size, pos, cap in ((20000, 0, 10000), (20000, 777, 10000), (10500, 777, 10000),
                           (20000, 500, 200)):
        out_p, out_j = np.full(size, 0x5A, np.uint8), np.full(size, 0x5A, np.uint8)
        got = _outcome(lambda: PN.decompress_block(comp, cap, out=out_p, out_pos=pos))
        want = _outcome(lambda: JN.decompress_block(comp, cap, out=out_j, out_pos=pos))
        assert got == want
        assert np.array_equal(out_p, out_j)
    assert PN.decompress_block(comp, len(data)) == data  # without out: unchanged


# -- errors ---------------------------------------------------------------------------


ERROR_CASES = [
    ("decompress", bytes([0x30, ord("a"), ord("4"), ord("9")]), 3),
    ("decompress", b"", 255),
    ("decompress", b"\xf0", 255),
    ("decompress", b"\x0f\x00", 255),
    ("decompress", b"\x0f\x01\x00", 255),
    ("decompress", bytes([0x40, ord("a"), 1, 0]), 4),
    ("decompress", bytes([0x20, 97, 97, 1, 0]), 1),
    ("decompress", bytes([0x10, 97, 1, 0]), 4),
    ("decompress", bytes([0x0E, 255, 0] + [0] * 17), 256),
    ("decompress_with_dict", bytes([0x0E, 255, 0, 0x70] + [0] * 7), 256, bytes(250)),
    ("decompress", bytes([0x0E, 0, 0, 0x70] + [0] * 7), 256),
    ("uncompressed_size", b"\x01\x02"),
    ("decompress_size_prepended", b"\x01"),
]


@pytest.mark.parametrize("case", ERROR_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(ERROR_CASES)])
def test_errors_equal_jax(case):
    _same(*case)


def test_garbage_and_mutations_equal_jax():
    rng = random.Random(1234)
    comp = bytearray(PB.compress(INPUTS["word_soup"][:2000]))
    for _ in range(300):
        data = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 100)))
        _same("decompress", data, 512)
        _same("decompress_with_dict", data, 512, b"some dictionary bytes here")
        mutated = bytearray(comp)
        for _ in range(rng.randrange(1, 4)):
            mutated[rng.randrange(len(mutated))] = rng.randrange(256)
        _same("decompress", bytes(mutated), 2000)


# -- xxHash32 -------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 3, 4, 15, 16, 17, 31, 32, 100, 1000, 65536])
@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF])
def test_xxh32_equals_jax_native_and_xxhash(n, seed):
    data = incompressible(n, seed=n * 31 + seed)
    want = xxhash.xxh32(data, seed=seed).intdigest()
    assert PX.xxh32(data, seed) == PS.xxh32(data, seed) == want
    assert JX.xxh32(data, seed) == want
    assert PN.xxh32(data, seed) == want


def test_xxhash32_streaming_equals_jax_and_native():
    rng = random.Random(42)
    data = incompressible(10_000, seed=43)
    hp, hj, hn = PX.XxHash32(0), JX.XxHash32(0), PN.NativeXxHash32(0)
    i = 0
    while i < len(data):
        step = min(rng.randrange(1, 97), len(data) - i)
        for h in (hp, hj, hn):
            h.write(data[i : i + step])
        i += step
        # digest() is readable mid-stream without disturbing the state
        assert hp.digest() == hj.digest() == hn.digest() == xxhash.xxh32(data[:i]).intdigest()
