"""The port's batched resident decode (``parallel.pipeline._decode_batch``,
one batched program over its rows) against the JAX package's, a ``vmap``,
bit for bit on the CPU: outputs, lengths and (B, 5) flags must be equal,
and each row must equal the port's own run of that row alone (B=1).

Sixteen payload rows of at most 16 KiB (outputs up to 32 KiB: at out_pad
32,768 v2's workset of max(1024, cells / 4) cells can overflow) go through
batches of 1, 3 and 16 rows, with both expansion engines and with the
default capacity and one below out_pad. The rows: an empty block, a row
of only literals, a long run, deep match chains that overflow both
engines' worksets (so they finish in the dense fallback), valid rows of
several kinds, and one row for each of the five error flags; the batches
of 3 put each malformed row between two valid ones.

``vmap`` gives a row the result it has alone, whatever its batch, so the
JAX side decodes all sixteen rows in one batch for each engine and
capacity (one compile per engine: the capacity is traced) and every batch
of the port is held to those rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_flex_tpu.parallel import pipeline as JPP
from lz4_flex_tpu_torch import native
from lz4_flex_tpu_torch.ops import packing as TK
from lz4_flex_tpu_torch.ops.sequences import parse_sequences_host
from lz4_flex_tpu_torch.parallel import pipeline as TPP

from .torch_inputs import incompressible, mutated_copies, word_soup

WIDTH = 16384  # payload row bytes, each row zero-padded
OUT_PAD = 32768
NSEQ_PAD = TK.size_bucket(WIDTH // 3 + 2, minimum=256)
CAPACITY = 20000  # below out_pad: the long rows flag output_too_small

# Valid blocks, raw.
BLOCKS = {
    "empty": b"",
    "literals": incompressible(9000, seed=81),
    "long_run": b"a" * 30000,
    "deep_chains": mutated_copies(32000, seed=82),
    "soup": word_soup(16000, seed=83),
    "soup_match_heavy": word_soup(5000, seed=84, vocab=60),
    "tiny": b"hello world, hello world!",
    "one_byte": b"A",
    "long_literal_lsic": incompressible(300, seed=85) + b"z" * 2000,
    "runs_and_noise": (b"x" * 200 + incompressible(64, seed=86)) * 40,
    "random_8": np.random.default_rng(87).integers(0, 8, 12000, dtype=np.uint8).tobytes(),
}
# Malformed payloads, one for each error flag, in flag order.
MALFORMED = {
    "literal_oob": bytes([0x40]),
    "truncated": bytes([0xF0, 0xFF, 0xFF]),
    "offset_zero": bytes([0x12, 0x41, 0x00, 0x00]),
    "offset_oob": bytes([0x14, 0x41, 0xB8, 0x0B, 0x50]) + b"ABCDE",
    "output_too_small": native.compress_block(b"q" * 40000),
}
PAYLOADS = {**{k: native.compress_block(v) for k, v in BLOCKS.items()}, **MALFORMED}
NAMES = sorted(PAYLOADS)


def _rows(names):
    rows = np.zeros((len(names), WIDTH), np.uint8)
    for i, k in enumerate(names):
        rows[i, : len(PAYLOADS[k])] = np.frombuffer(PAYLOADS[k], np.uint8)
    return rows, np.array([len(PAYLOADS[k]) for k in names], np.int32)


def _batches(b: int):
    """The row batches of size ``b``: every row alone; each malformed row
    between two valid ones and the valid rows in threes; all sixteen in a
    seeded order."""
    if b == 1:
        return [[k] for k in NAMES]
    if b == 3:
        valid = sorted(BLOCKS)
        out = [[valid[i], bad, valid[-1 - i]] for i, bad in enumerate(MALFORMED)]
        return out + [valid[i : i + 3] for i in range(0, len(valid) - 2, 3)]
    return [list(np.random.default_rng(88).permutation(NAMES))]


_J_DECODE = {e: jax.jit(lambda r, n, c: JPP._decode_batch(r, n, out_pad=OUT_PAD, nseq_pad=NSEQ_PAD,
                                                          capacity=c))
             for e in ("v1", "v2")}


def _port(names, capacity):
    rows, lens = _rows(names)
    out = TPP._decode_batch(torch.from_numpy(rows), torch.from_numpy(lens), out_pad=OUT_PAD,
                            nseq_pad=NSEQ_PAD, capacity=capacity)
    return [t.numpy() for t in out]


@pytest.fixture(scope="module")
def references():
    """references(engine, capacity): each row's JAX result (from one batch
    of all rows) and the port's run of that row alone, by name; made once
    a module run for each engine and capacity. The caller sets
    TLZ4_EXPAND to ``engine`` first."""
    made = {}

    def get(engine: str, capacity):
        if (engine, capacity) not in made:
            rows, lens = _rows(NAMES)
            cap = OUT_PAD if capacity is None else capacity  # traced: one compile an engine
            out = _J_DECODE[engine](jnp.asarray(rows), jnp.asarray(lens), jnp.int32(cap))
            made[engine, capacity] = (
                {k: tuple(np.asarray(t)[i] for t in out) for i, k in enumerate(NAMES)},
                {k: tuple(t[0] for t in _port([k], capacity)) for k in NAMES})
        return made[engine, capacity]

    return get


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (small tensors, several
    test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("capacity", [None, CAPACITY])
@pytest.mark.parametrize("engine", ["v1", "v2"])
@pytest.mark.parametrize("b", [1, 3, 16])
def test_decode_batch_equals_jax_and_rows_alone(b, engine, capacity, references, monkeypatch):
    monkeypatch.setenv("TLZ4_EXPAND", engine)  # both packages read it when they run
    jax_rows, alone = references(engine, capacity)
    cap = OUT_PAD if capacity is None else capacity
    for names in _batches(b):
        out, total, errs = _port(names, capacity)
        assert out.shape == (b, OUT_PAD) and total.shape == (b,) and errs.shape == (b, 5)
        assert total.dtype == np.int32 and errs.dtype == np.bool_
        for i, k in enumerate(names):
            got = (out[i], total[i], errs[i])
            for ref, what in ((jax_rows[k], "JAX"), (alone[k], "the row alone")):
                for g, w, field in zip(got, ref, ("output", "length", "flags")):
                    np.testing.assert_array_equal(
                        g, w, err_msg=f"{k} {field} in {names} ({engine}, capacity {capacity}) "
                                      f"against {what}")
            if k in MALFORMED:
                assert errs[i, list(MALFORMED).index(k)], (k, errs[i])
            elif len(BLOCKS[k]) > cap:
                assert errs[i].tolist() == [False] * 4 + [True], (k, errs[i])
            else:
                assert not errs[i].any(), (k, errs[i])
                assert out[i, : total[i]].tobytes() == BLOCKS[k]


def test_groups_of_rows_equal_one_dispatch(references, monkeypatch):
    """A batch past the dispatch cap is decoded in groups of rows, in order,
    with the same results: here 3 rows a group, the last group of 1."""
    monkeypatch.setenv("TLZ4_EXPAND", "v2")
    monkeypatch.setattr(TPP, "_DECODE_POSITIONS", 3 * OUT_PAD)
    jax_rows, _ = references("v2", None)
    out, total, errs = _port(NAMES, None)
    for i, k in enumerate(NAMES):
        for g, w in zip((out[i], total[i], errs[i]), jax_rows[k]):
            np.testing.assert_array_equal(g, w, err_msg=k)


def _doubled(s: np.ndarray, rounds: int) -> np.ndarray:
    """``rounds`` per-byte pointer-doubling hops of a source map (s >= 0
    unresolved): no cell round resolves faster."""
    for _ in range(rounds):
        s = np.where(s >= 0, s[np.clip(s, 0, s.shape[0] - 1)], s)
    return s


@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_deep_chains_overflow_the_workset(engine):
    """The deep_chains row leaves more unresolved cells (v2) or positions
    (v1) after the dense rounds than the workset holds, so the batches
    above take the dense fallback for that row and the workset for the
    others."""
    seq = parse_sequences_host(np.frombuffer(PAYLOADS["deep_chains"], np.uint8))
    if engine == "v2":
        from lz4_flex_tpu_torch.ops.expand2 import build_source_map

        tables = [TK.pad_to(seq.out_off, NSEQ_PAD, fill=OUT_PAD),
                  TK.pad_to(seq.lit_start, NSEQ_PAD), TK.pad_to(seq.lit_len, NSEQ_PAD),
                  TK.pad_to(seq.match_off, NSEQ_PAD, fill=1)]
        s = build_source_map(*(torch.from_numpy(t) for t in tables), 0, seq.total_out,
                             out_pad=OUT_PAD, comp_pad=WIDTH, dict_bytes=0).numpy()
        unresolved = int((_doubled(s, 3).reshape(-1, 16) >= 0).any(1).sum())
        workset = max(1024, OUT_PAD // 16 // 4)
    else:
        # v1's map: a match byte's source is p - offset, a literal resolved
        s = np.full(OUT_PAD, -1, np.int64)
        for oo, ll, mo, ml in zip(seq.out_off, seq.lit_len, seq.match_off, seq.match_len):
            p = np.arange(oo + ll, oo + ll + ml)
            s[p] = p - mo
        unresolved = int((_doubled(s, 2) >= 0).sum())
        workset = max(4096, OUT_PAD // 8)
    assert unresolved > workset, (unresolved, workset)


def _ops(names) -> int:
    """The torch ops one ``_decode_batch`` call of these rows dispatches
    from Python (the profiler's top-level events)."""
    from torch.profiler import ProfilerActivity, profile

    rows, lens = _rows(names)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TPP._decode_batch(torch.from_numpy(rows), torch.from_numpy(lens), out_pad=OUT_PAD,
                          nseq_pad=NSEQ_PAD)
    return sum(e.cpu_parent is None for e in prof.events())


def test_one_program_for_the_batch():
    """No op runs once a row: four rows (the deep chains' fallback, a long
    run, a soup, a malformed row) four times over dispatch exactly the ops
    of one copy, and no more than 1.5x the ops of the costliest row alone
    (the loops run as many rounds as the slowest row)."""
    mix = ["deep_chains", "long_run", "soup", "offset_zero"]
    once = _ops(mix)
    assert _ops(mix * 4) == once
    assert once <= 1.5 * max(_ops([k]) for k in mix)
