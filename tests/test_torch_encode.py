"""The port's hybrid encoder (on the CPU) against the JAX package's: the
candidate planes of ``candidates_core``, ``best_plane_core`` and
``_best_plane_quad`` are bit-equal, and ``compress_block_hybrid`` writes the
same wire bytes on the single-chunk and the streaming path, which decode back
through the native decoder and the system liblz4. Tolerance: exact
everywhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_flex_tpu import block
from lz4_flex_tpu.ops import encode as JE
from lz4_flex_tpu_torch import native
from lz4_flex_tpu_torch.ops import encode as PE
from lz4_flex_tpu_torch.ops import packing

from . import c_oracle
from .torch_inputs import incompressible, periodic_ring_boundary, rle_overlap, word_soup

INPUTS = {
    "soup": word_soup(150000, seed=11),
    "rle": b"a" * 70000,
    "rle_overlap": rle_overlap(),
    "periodic": periodic_ring_boundary()[:200000],
    "incompressible": incompressible(100000, seed=12),
    "tiny": b"abcdefg",
    "one": b"a",
}
DICT = word_soup(80000, seed=13)
# The JAX functions run jitted, as the JAX package runs them (eager
# dispatch compiles every op of the loop on its own and takes ~10x longer).
_jax_plane = jax.jit(JE.best_plane_core, static_argnums=(1, 2))


def _padded(data: bytes, dic: bytes = b"") -> np.ndarray:
    g = np.frombuffer(dic[-65536:] + data, np.uint8)
    return packing.pad_to(g.copy(), packing.size_bucket(max(g.shape[0] + 4, 8)))


def _check_roundtrip(comp: bytes, data: bytes, dic: bytes = b"") -> None:
    dic = dic[-65536:]
    assert native.decompress_block(comp, len(data), dic) == data
    if c_oracle.load() is not None:
        assert c_oracle.c_decompress_block(comp, len(data), dic) == data


@pytest.mark.parametrize("name", sorted(INPUTS) + ["soup+dict"])
def test_candidates_equal_jax(name):
    g = _padded(INPUTS["soup"], DICT) if name == "soup+dict" else _padded(INPUTS[name])
    want = [np.asarray(a) for a in JE._candidates_kernel(jnp.asarray(g))]
    before = PE.stats["candidate_calls"]
    got = PE.candidates_core(torch.from_numpy(g))
    assert PE.stats["candidate_calls"] == before + 1
    for w, t in zip(want, got):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy().view(np.uint32), w)


@pytest.mark.parametrize("pool", [4, 2])
@pytest.mark.parametrize("name", ["soup", "rle_overlap", "periodic", "incompressible", "tiny"])
def test_best_plane_equal_jax(name, pool):
    # The port anchors a candidate at every position: the JAX default, stride 1.
    g = _padded(INPUTS[name])
    want = np.asarray(_jax_plane(jnp.asarray(g), pool, 1))
    got = PE.best_plane_core(torch.from_numpy(g), pool)
    assert got.dtype == torch.int16 and got.shape == (g.shape[0] // pool,)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)


def test_best_plane_quad_equal_jax():
    # Three chunk rows sliced from one resident stream (the last ragged
    # against the stream's end), one batched sort on the port's side.
    g = np.frombuffer(word_soup(1200000, seed=14), np.uint8)
    gpad = packing.pad_to(g.copy(), packing.size_bucket(g.shape[0] + 8))
    starts = [0, 393212, gpad.shape[0] - JE._CHUNK_W]
    want = np.asarray(JE._best_plane_quad(jnp.asarray(gpad), jnp.asarray(np.array(starts, np.int32))))
    before = PE.stats["plane_quads"]
    got = PE._best_plane_quad(torch.from_numpy(gpad), starts)
    assert PE.stats["plane_quads"] == before + 1
    assert got.shape == (3, PE._CHUNK_W // PE._PLANE_POOL)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)


def test_geometry_equals_jax():
    assert (PE._CHUNK_W, PE._CHUNK_C) == (JE._CHUNK_W, JE._CHUNK_C) == (524288, 458748)
    assert (PE._PLANE_POOL, PE._PLANE_ROWS) == (JE._PLANE_POOL, JE._PLANE_ROWS)
    assert JE._PLANE_STRIDE == 1  # the only stride the port has


@pytest.mark.parametrize("name", sorted(INPUTS) + ["empty", "soup+dict", "tiny+dict"])
def test_hybrid_single_chunk_equal_jax(name):
    if name == "empty":
        data, dic = b"", b""
    elif name.endswith("+dict"):
        data, dic = INPUTS[name[: -len("+dict")]], DICT
    else:
        data, dic = INPUTS[name], b""
    got = PE.compress_block_hybrid(data, dic, device="cpu")
    assert got == JE.compress_block_hybrid(data, ext_dict=dic)
    _check_roundtrip(got, data, dic)


STREAMS = {
    # 3 chunk rows: with _PLANE_ROWS = 2, two dispatches, the last ragged
    "soup_3_rows": (word_soup(1350000, seed=15), b""),
    "soup_dict": (word_soup(1000000, seed=16), DICT),
    # matchless chunks leave pending literal runs for the stitch
    "incompressible": (incompressible(JE._CHUNK_C + 70000, seed=17), b""),
    "mixed": (incompressible(300000, seed=18) + word_soup(400000, seed=18)
              + incompressible(300000, seed=19), b""),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_hybrid_streaming_equal_jax(monkeypatch, name):
    data, dic = STREAMS[name]
    monkeypatch.setattr(JE, "_PLANE_ROWS", 2)
    monkeypatch.setattr(PE, "_PLANE_ROWS", 2)
    nrows = -(-len(data) // PE._CHUNK_C)
    assert nrows >= 2
    before = PE.stats["plane_quads"]
    got = PE.compress_block_hybrid(data, dic, device="cpu")
    assert PE.stats["plane_quads"] == before + -(-nrows // 2)
    assert got == JE.compress_block_hybrid(data, ext_dict=dic)
    _check_roundtrip(got, data, dic)


def test_hybrid_streaming_default_rows_equal_jax():
    data = word_soup(1100000, seed=20)
    got = PE.compress_block_hybrid(data, device="cpu")
    assert got == JE.compress_block_hybrid(data)
    assert block.decompress(got, len(data)) == data
    assert len(got) < len(native.compress_block(data))


def test_hybrid_takes_bytes_bytearrays_and_arrays():
    data = INPUTS["soup"]
    want = PE.compress_block_hybrid(data, device="cpu")
    assert PE.compress_block_hybrid(np.frombuffer(data, np.uint8), device="cpu") == want
    assert PE.compress_block_hybrid(bytearray(data), device="cpu") == want
