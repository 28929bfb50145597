"""The port's expansion engines and packing helpers (on the CPU) against the
JAX package's, bit for bit: the same seeded inputs and the same sequence
tables (from the port's native parser) go through both. Maps (int32 source
indices), tables and bytes must be equal over their whole padded length;
the output bytes must also equal the data. The cases follow
tests/test_expand2.py and tests/test_ops.py, on inputs made in the repo.

The JAX functions run under jit at one fixed padded shape per case kind, so
each compiles once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_flex_tpu import block
from lz4_flex_tpu.block import errors as JAX_E
from lz4_flex_tpu.ops import decode as JD
from lz4_flex_tpu.ops import expand2 as JE
from lz4_flex_tpu.ops import packing as JK
from lz4_flex_tpu_torch import native
from lz4_flex_tpu_torch.block import errors as E
from lz4_flex_tpu_torch.ops import decode as TD
from lz4_flex_tpu_torch.ops import expand2 as TE
from lz4_flex_tpu_torch.ops import packing as TK
from lz4_flex_tpu_torch.ops.sequences import _parse_sequences_py, parse_sequences_host

from .torch_inputs import incompressible, word_soup

OUT_PAD = 65536
COMP_PAD = 65536
NSEQ_PAD = 16384
DICT_PAD = 16384


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and with several test workers on the same cores, torch's thread pool
    oversubscribes them (each tiny op then waits on its threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fragmented(n: int, seed: int) -> bytes:
    """Words of a soup shuffled: many short matches, so many fragments per
    16-byte cell (tier 2 of materialize_cells)."""
    words = word_soup(40000, seed=seed).split()
    rng = np.random.default_rng(seed)
    return b" ".join(words[i] for i in rng.integers(0, len(words), n // 5))[:n]


CASES = {
    "rle_zero": (b"\x00" * 30000, b""),
    "ab": (b"ab" * 9000, b""),
    "abc_xyzw": (b"abc" * 5000 + b"xyzw" * 2500, b""),
    "cycle_then_run": (bytes(range(256)) * 16 + b"A" * 5000, b""),
    "tiny_A": (b"A", b""),
    "tiny_hello": (b"hello world, hello world!", b""),
    "tiny_x13": (b"x" * 13, b""),
    "random_1000": (np.random.default_rng(42).integers(0, 8, 1000, dtype=np.uint8).tobytes(), b""),
    "random_20000": (np.random.default_rng(43).integers(0, 8, 20000, dtype=np.uint8).tobytes(), b""),
    "soup": (word_soup(50000, seed=51), b""),
    "fragmented": (_fragmented(40000, 52), b""),
    "dict_crossing": (word_soup(20000, seed=53)[2048:], word_soup(20000, seed=53)[:4096]),
    "match_into_dict_tail": ((b"0123456789" * 800)[-100:] + b"fresh bytes" + (b"0123456789" * 800)[-100:],
                             b"0123456789" * 800),
    "dict_soup": (word_soup(30000, seed=54), word_soup(16000, seed=54)),
}


def _tables(name):
    data, dic = CASES[name]
    comp = np.frombuffer(native.compress_block(data, dic), np.uint8)
    seq = parse_sequences_host(comp)
    assert seq.total_out == len(data)
    d = np.frombuffer(dic, np.uint8)
    arrays = [
        TD._pack_host(comp, COMP_PAD),
        TD._pack_host(d, DICT_PAD if dic else 4),
        TK.pad_to(seq.out_off, NSEQ_PAD, fill=OUT_PAD),
        TK.pad_to(seq.lit_start, NSEQ_PAD),
        TK.pad_to(seq.lit_len, NSEQ_PAD),
        TK.pad_to(seq.match_off, NSEQ_PAD, fill=1),
    ]
    return data, dic, arrays, seq.total_out


def _jax(arrays):
    return [jnp.asarray(a.view(np.uint32) if i < 2 else a) for i, a in enumerate(arrays)]


def _torch(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


_J_EXPAND = {
    "v1": jax.jit(JD.expand_core, static_argnames=("out_pad", "has_dict")),
    "v2": jax.jit(JE.expand2_core, static_argnames=("out_pad", "has_dict")),
}
_T_EXPAND = {"v1": TD.expand_core, "v2": TE.expand2_core}
_J_MAP = jax.jit(JE.build_source_map, static_argnames=("out_pad", "comp_pad", "dict_bytes"))
_J_RESOLVE = jax.jit(JE.resolve_cells, static_argnames=("out_pad",))
_J_MATERIALIZE = jax.jit(JE.materialize_cells, static_argnames=("out_pad", "guard_words"))


@pytest.mark.parametrize("engine", ["v1", "v2"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_expand_equals_jax(name, engine):
    data, dic, arrays, total = _tables(name)
    kw = dict(out_pad=OUT_PAD, has_dict=bool(dic))
    want = np.asarray(_J_EXPAND[engine](*_jax(arrays), jnp.int32(len(dic)), jnp.int32(total), **kw))
    got = _T_EXPAND[engine](*_torch(arrays), len(dic), total, **kw)
    assert got.dtype == torch.uint8 and got.shape == (OUT_PAD,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:total].numpy().tobytes() == data


def _guarded_words(words: np.ndarray, dwords: np.ndarray, has_dict: bool) -> np.ndarray:
    parts = [np.zeros(4, np.int32), words] + ([dwords] if has_dict else []) + [np.zeros(12, np.int32)]
    return np.concatenate(parts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_expand2_stages_equal_jax(name):
    """build_source_map, resolve_cells and materialize_cells one by one, each
    fed the same input on both sides."""
    data, dic, arrays, total = _tables(name)
    dict_bytes = DICT_PAD if dic else 0
    tables = arrays[2:]
    s_j = _J_MAP(*[jnp.asarray(a) for a in tables], jnp.int32(len(dic)), jnp.int32(total),
                 out_pad=OUT_PAD, comp_pad=COMP_PAD, dict_bytes=dict_bytes)
    s_t = TE.build_source_map(*_torch(tables), len(dic), total, out_pad=OUT_PAD, comp_pad=COMP_PAD,
                              dict_bytes=dict_bytes)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))

    r_j = np.asarray(_J_RESOLVE(s_j, out_pad=OUT_PAD))
    r_t = TE.resolve_cells(torch.from_numpy(np.asarray(s_j).copy()), out_pad=OUT_PAD)
    np.testing.assert_array_equal(r_t.numpy(), r_j)
    assert (r_j < 0).all()

    wg = _guarded_words(arrays[0], arrays[1], bool(dic))
    m_j = _J_MATERIALIZE(jnp.asarray(r_j), jnp.asarray(wg.view(np.uint32)), out_pad=OUT_PAD,
                         guard_words=4)
    m_t = TE.materialize_cells(torch.from_numpy(r_j.copy()), torch.from_numpy(wg), out_pad=OUT_PAD,
                               guard_words=4)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert m_t[:total].numpy().tobytes() == data


def test_fragmented_soup_reaches_tier_two():
    _, _, arrays, total = _tables("fragmented")
    s = TE.build_source_map(*_torch(arrays[2:]), 0, total, out_pad=OUT_PAD, comp_pad=COMP_PAD,
                            dict_bytes=0)
    k = (-TE.resolve_cells(s, out_pad=OUT_PAD) - 1).reshape(-1, 16)
    d = k - torch.arange(OUT_PAD, dtype=torch.int32).reshape(-1, 16)
    rank, _ = TE._cell_ranks(d, torch.ones_like(d, dtype=torch.bool))
    assert int((rank.amax(dim=1) >= 8).sum()) > 0  # cells of more than K=8 fragments


def test_row_gather_equals_jax():
    rng = np.random.default_rng(5)
    for n, width in ((100, 16), (96, 16), (37, 6)):
        op = rng.integers(-1000, 1000, n, dtype=np.int32)
        starts = rng.integers(-20, n + 20, 64, dtype=np.int32)
        want = np.asarray(JE._row_gather(jnp.asarray(op), jnp.asarray(starts), width))
        got = TE._row_gather(torch.from_numpy(op), torch.from_numpy(starts), width)
        np.testing.assert_array_equal(got.numpy(), want)


def test_packing_helpers_equal_jax():
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, 4096, dtype=np.uint8)
    u8[100:140] = 0xFF  # LSIC runs, one ending at the buffer's end
    u8[-7:] = 0xFF
    w_j = np.asarray(JK.bytes_to_words(jnp.asarray(u8)))
    w_t = TK.bytes_to_words(torch.from_numpy(u8))
    np.testing.assert_array_equal(w_t.numpy().view(np.uint32), w_j)
    np.testing.assert_array_equal(TK.words_to_bytes(w_t).numpy(),
                                  np.asarray(JK.words_to_bytes(jnp.asarray(w_j))))
    idx = rng.integers(-50, 4096 + 50, 1000, dtype=np.int32)
    np.testing.assert_array_equal(TK.gather_bytes(w_t, torch.from_numpy(idx)).numpy(),
                                  np.asarray(JK.gather_bytes(jnp.asarray(w_j), jnp.asarray(idx))))
    for n in (1000, 4096, 8192):  # 8192 takes the JAX tiled form
        x = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        for kind in ("sum", "max", "min"):
            for reverse in (False, True):
                want = np.asarray(JK.tiled_scan(kind, jnp.asarray(x), reverse=reverse))
                got = TK.tiled_scan(kind, torch.from_numpy(x), reverse=reverse)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{kind} {reverse}")
    for got, want in zip(TK.lsic_tables(torch.from_numpy(u8)), JK.lsic_tables(jnp.asarray(u8))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_drop_equals_jax():
    rng = np.random.default_rng(7)
    base = rng.integers(-100, 100, 50, dtype=np.int32)
    idx = rng.permutation(np.arange(-60, 60, dtype=np.int32))[:70]
    vals = rng.integers(-1000, 1000, 70, dtype=np.int32)
    for op in ("add", "max", "set"):
        want = np.asarray(getattr(jnp.asarray(base).at[jnp.asarray(idx)], op)(jnp.asarray(vals), mode="drop"))
        got = TK.scatter_drop(torch.from_numpy(base), torch.from_numpy(idx), torch.from_numpy(vals), op)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=op)


@pytest.mark.parametrize("name", ["soup", "ab", "tiny_hello"])
def test_sequence_tables_equal_python_oracle(name):
    data, dic, _, _ = _tables(name)
    comp = native.compress_block(data, dic)
    a, b = parse_sequences_host(comp), _parse_sequences_py(comp)
    for f in ("lit_start", "lit_len", "match_off", "match_len", "out_off"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.total_out == b.total_out == len(data)


def _frame_parts(linked: bool):
    """A frame body of 64 KiB blocks (one of them stored) as the frame
    decoder hands it over, and its data."""
    data = word_soup(131072, seed=55) + incompressible(65536, seed=56) + word_soup(40000, seed=57)
    parts, pos = [], 0
    while pos < len(data):
        raw = data[pos : pos + 65536]
        c = block.compress_with_dict(raw, data[max(0, pos - 65536) : pos]) if linked else block.compress(raw)
        parts.append((c, True) if len(c) < len(raw) else (raw, False))
        pos += len(raw)
    assert any(not is_comp for _, is_comp in parts)
    return parts, data


@pytest.mark.parametrize("linked", [False, True])
def test_decode_parts_fused_equals_jax(linked):
    parts, data = _frame_parts(linked)
    want = JD.decode_parts_fused(parts, independent=not linked, max_block_size=65536)
    got = TD.decode_parts_fused(parts, independent=not linked, max_block_size=65536, device="cpu")
    assert got == want == data
    arr = TD.decode_parts_fused(parts, independent=not linked, device="cpu", as_array=True,
                                engine="v1")
    assert arr.dtype == torch.uint8 and arr.numpy().tobytes() == data
    with pytest.raises(E.OutputTooSmall):
        TD.decode_parts_fused(parts, independent=not linked, max_block_size=1000, device="cpu")
    assert TD.decode_parts_fused([], device="cpu") == b""


def test_decode_parts_fused_cross_block_reference_raises():
    parts, _ = _frame_parts(linked=True)
    with pytest.raises(JAX_E.OffsetOutOfBounds):
        JD.decode_parts_fused(parts, independent=True)
    with pytest.raises(E.OffsetOutOfBounds):
        TD.decode_parts_fused(parts, independent=True, device="cpu")
