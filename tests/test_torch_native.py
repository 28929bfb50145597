"""The port's native bindings against the JAX package's: the two libraries
are built from byte-identical sources, so measure, parse, host decode,
encode and xxHash32 agree exactly, and corrupt input raises errors of the
same class names."""

import numpy as np
import pytest

from lz4_flex_tpu import block
from lz4_flex_tpu import native as ref_native
from lz4_flex_tpu_torch import native

from .torch_inputs import block_inputs, word_soup

INPUTS = block_inputs()


def test_native_source_is_a_copy():
    with open(ref_native._SRC, "rb") as a, open(native._SRC, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_measure_parse_decode_equal(name):
    data = INPUTS[name]
    comp = block.compress(data)
    assert native.measure_block(comp) == ref_native.measure_block(comp) == len(data)
    got = native.parse_sequences(comp)
    want = ref_native.parse_sequences(comp)
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g, w)
    assert got[5] == want[5] == len(data)
    assert native.decompress_block(comp, len(data)) == data
    assert native.compress_block(data) == ref_native.compress_block(data)


def test_dict_encode_decode_equal():
    dic = word_soup(70000, seed=3)
    data = word_soup(50000, seed=3)[1000:] + word_soup(20000, seed=4)
    comp = native.compress_block(data, dic[-65536:])
    assert comp == ref_native.compress_block(data, ext_dict=dic[-65536:])
    assert native.decompress_block(comp, len(data), dic[-65536:]) == data
    assert block.decompress_with_dict(comp, len(data), dic[-65536:]) == data


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 1000, 65537])
def test_xxh32_equal(n):
    data = word_soup(n, seed=n) if n else b""
    for seed in (0, 1, 0x9E3779B1):
        assert native.xxh32(data, seed) == ref_native.xxh32(data, seed)
    h = native.NativeXxHash32(5)
    for i in range(0, n, 7):
        h.write(data[i : i + 7])
    assert h.digest() == ref_native.xxh32(data, 5)


def _corrupt_cases():
    good = block.compress(word_soup(5000, seed=2))
    return {
        "zero_offset": np.array([0x10, 65, 0, 0], np.uint8),
        "offset_oob": np.array([0x10, 65, 100, 0], np.uint8),
        "lsic_truncated": np.array([0xF0, 0xFF], np.uint8),
        "literal_oob": np.array([0x45], np.uint8),
        "literal_oob_long": np.array([0xF0, 10, 65], np.uint8),
        "truncated": np.frombuffer(good[: len(good) // 2], np.uint8),
    }


@pytest.mark.parametrize("case", sorted(_corrupt_cases()))
def test_error_classes_match(case):
    comp = _corrupt_cases()[case]

    def name_of(fn):
        try:
            fn()
        except Exception as e:  # the class name is what is compared
            return type(e).__name__
        return None

    for port_fn, ref_fn in (
        (lambda: native.measure_block(comp), lambda: ref_native.measure_block(comp)),
        (lambda: native.parse_sequences(comp), lambda: ref_native.parse_sequences(comp)),
        (lambda: native.decompress_block(comp, 10000), lambda: ref_native.decompress_block(comp, 10000)),
    ):
        assert name_of(port_fn) == name_of(ref_fn)
    assert name_of(lambda: native.decompress_block(comp, 10000)) is not None
