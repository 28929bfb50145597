"""``correct``: sound runs pass; each control fails; and a run whose timed
path is broken underneath comes out not correct, once for each fault the
cell can have."""

import numpy as np
import pytest
import torch

from conftest import CELLS, small_cell
from portbench import control


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(run_small, name):
    r = run_small(name, 2**31 + 77)
    assert r["correct"] and r["failed"] == 0 and r["checks"]["compared"]["value"] > 0
    assert all(c["limit"] is None or c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_fails(name, seed):
    """The reference with one guarantee broken, in the program's place."""
    checks = control.control_checks(small_cell(name), seed, "cpu")
    assert any(v > 0 for v in checks.values()), checks


def _flip(b: bytes) -> bytes:
    b = bytearray(b)
    b[len(b) // 2] ^= 0x20
    return bytes(b)


def _break_to_bytes(mp):
    from lz4_flex_tpu_torch.ops import ringdecode

    orig = ringdecode._to_bytes
    mp.setattr(ringdecode, "_to_bytes", lambda t: _flip(orig(t)))


def _encode_staged_with(mp, change):
    from lz4_flex_tpu_torch.parallel import pipeline

    orig = pipeline._encode_staged
    mp.setattr(pipeline, "_encode_staged", lambda *a, **k: change(orig(*a, **k)))


def _encode_blocks_flipped(mp):
    """A payload altered after the program's verify guard (a byte flipped
    inside ``_encode_staged`` is caught and re-encoded by that guard)."""
    from lz4_flex_tpu_torch.parallel import pipeline

    orig = pipeline.encode_blocks

    def flipped(*a, **k):
        payloads, lens, window = orig(*a, **k)
        return [_flip(payloads[0])] + payloads[1:], lens, window

    mp.setattr(pipeline, "encode_blocks", flipped)


def _encode_on_the_host(mp):
    """Every block encoded by the host encoder where the device encoder
    should run: right frames, and no ``match_core`` dispatch."""
    from lz4_flex_tpu_torch.block import compress_with_dict
    from lz4_flex_tpu_torch.parallel import pipeline

    def host(rows, dlen, tlen, device, geo):
        return [compress_with_dict(r[d:n], r[:d]) for r, d, n in zip(rows, dlen.tolist(), tlen.tolist())]

    mp.setattr(pipeline, "_encode_staged", host)


def _decode_batch_with(mp, change):
    from lz4_flex_tpu_torch.parallel import pipeline

    orig = pipeline._decode_batch
    mp.setattr(pipeline, "_decode_batch", lambda rows, clen, **k: change(rows, orig(rows, clen, **k)))


def _half(res):
    out, lens, err = (t.clone() for t in res)
    h = out.shape[0] // 2
    out[h:] = 0
    lens[h:] = 0
    return out, lens, err


def _unchanged(rows, res):
    out, lens, err = res
    state = torch.zeros_like(out)
    state[:, : rows.shape[1]] = rows[:, : out.shape[1]]
    return state, lens, err


def _flip_tensor(res):
    out = res[0].clone()
    out[0, out.shape[1] // 3] ^= 0x20
    return (out,) + tuple(res[1:])


FAULTS = {
    "lz4f-64k.decode": {"answer altered": _break_to_bytes},
    "lz4f-64k.encode": {
        "answer altered": _encode_blocks_flipped,
        "a token altered before the verify guard": lambda mp: _encode_staged_with(
            mp, lambda p: [_flip(p[0])] + p[1:]),
        "the device encode bypassed": _encode_on_the_host,
        "half of the blocks left out": lambda mp: _encode_staged_with(mp, lambda p: p[: max(1, len(p) // 2)]),
    },
    "lz4f-64k.batch_decode": {
        "answer altered": lambda mp: _decode_batch_with(mp, lambda rows, res: _flip_tensor(res)),
        "half of the batch left out": lambda mp: _decode_batch_with(mp, lambda rows, res: _half(res)),
        "state returned unchanged": lambda mp: _decode_batch_with(mp, _unchanged),
    },
}


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS[c]])
def test_a_broken_timed_path_is_not_correct(run_small, monkeypatch, name, fault):
    FAULTS[name][fault](monkeypatch)
    r = run_small(name, 2**31 + 99)
    assert not r["correct"], r["checks"]


def test_a_request_that_raises_is_failed(run_small, monkeypatch):
    from lz4_flex_tpu_torch.ops import ringdecode

    calls = {"n": 0}
    orig = ringdecode.ring_decode

    def sometimes(*a, **k):
        calls["n"] += 1
        if calls["n"] % 2 == 0:  # the warm-up call passes; the window's first raises
            raise RuntimeError("injected")
        return orig(*a, **k)

    monkeypatch.setattr(ringdecode, "ring_decode", sometimes)
    r = run_small("lz4f-64k.decode", 5, seconds=0.5)
    assert r["failed"] > 0 and not r["correct"]
    assert np.isclose(r["checks"]["failed"]["value"], r["failed"])
