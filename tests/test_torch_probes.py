"""The probes' plain versions on the CPU (lz4_flex_tpu_torch/experiments).

Each gather function's plain version equals a numpy restatement at small
sizes and the TPU probes' own function bodies (experiments/*.py, run on
numpy arrays in place of Pallas refs) at theirs; the fire probe's exact
variants equal ``ring_decode_reference`` and the data on the port's test
plans. Tolerance: exact (integer data)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from lz4_flex_tpu_torch import native
from lz4_flex_tpu_torch.experiments import fire_probe as FP
from lz4_flex_tpu_torch.experiments import gather_probe as GP
from lz4_flex_tpu_torch.ops import ringdecode as R

from .torch_inputs import block_inputs, wild_plan_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUNCTIONS = ("flat", "lane", "rowsel", "rowgather", "rowscatter")


def _numpy_gather(fn: str, tbl: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Element-by-element restatement of each gather function."""
    rows, width = tbl.shape
    flat = tbl.reshape(-1)
    if fn == "flat":
        return np.array([flat[i] for i in idx.reshape(-1)], tbl.dtype).reshape(idx.shape)
    out = np.empty((idx.shape[0], width), tbl.dtype)
    for i in range(idx.shape[0]):
        for l in range(width):
            if fn == "lane":
                out[i, l] = tbl[i, idx[i, l]]
            elif fn == "rowsel":
                out[i, l] = tbl[idx[i], l]
            elif fn == "rowgather":
                out[i, l] = flat[idx[i] + l]
            else:
                out[idx[i], l] = tbl[i, l]
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_gather_plain_equals_numpy(fn, seed):
    tbl, idx = GP.make_inputs(fn, seed, tbl_rows=24, out_rows=8, width=16)
    got = GP.PLAIN[fn](torch.from_numpy(tbl), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, _numpy_gather(fn, tbl, idx))


@pytest.mark.parametrize("variant", GP.VARIANTS)
def test_gather_wrapper_on_cpu_runs_the_plain_version(variant):
    fn = GP.function_of(variant)
    tbl, idx = GP.make_inputs(fn, 3)
    before = GP.stats[variant]
    got = GP.gather(variant, torch.from_numpy(tbl), torch.from_numpy(idx))
    assert got.shape == (GP.OUT_ROWS, GP.WIDTH) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.reshape(GP.OUT_ROWS, -1).numpy(),
                                  _numpy_gather(fn, tbl, idx).reshape(GP.OUT_ROWS, -1))
    assert GP.stats[variant] == before  # the plain version is no launch


def test_gather_wrapper_checks_its_inputs():
    tbl, idx = (torch.from_numpy(a) for a in GP.make_inputs("rowsel", 0))
    with pytest.raises(ValueError):
        GP.gather("rowsel_warp", tbl.int(), idx)
    with pytest.raises(ValueError):
        GP.gather("rowsel_warp", tbl, idx.long())
    with pytest.raises(ValueError):
        GP.gather("flat_byte", tbl, idx)  # flat takes one index per output byte
    with pytest.raises(ValueError):
        GP.gather("rowsel_dma", tbl, idx)


def _load_experiment(name: str, monkeypatch, tmp_path):
    # The TPU probes set a JAX cache directory when imported; point it into
    # the test's own directory and restore the environment afterwards.
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    spec = importlib.util.spec_from_file_location(
        f"tpu_probe_{name}", os.path.join(REPO, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_body(body, *ins, out_shape):
    """Run a Pallas kernel body on numpy arrays standing in for its refs."""
    out = np.zeros((1,) + out_shape, np.int32)
    body(*ins, out)
    return out[0]


def test_gather_plain_equals_pallas_gather_forms(monkeypatch, tmp_path):
    g = _load_experiment("pallas_gather_forms", monkeypatch, tmp_path)
    rng = np.random.default_rng(4)
    tbl = rng.integers(0, 2**31, (1, g.R, g.C)).astype(np.int32)
    idx = rng.integers(0, g.R * g.C, (1, g.OR, g.C)).astype(np.int32)
    lane = rng.integers(0, g.C, (1, g.OR, g.C)).astype(np.int32)
    rows = rng.integers(0, g.R, (1, g.OR, g.C)).astype(np.int32)
    t = torch.from_numpy(tbl[0])
    shape = (g.OR, g.C)
    for body in (g.g1_kernel, g.g4_kernel):  # G1 flat 1-D and G4 2-D (q, m) = divmod(idx, C)
        np.testing.assert_array_equal(_run_body(body, tbl, idx, out_shape=shape),
                                      GP.flat_plain(t, torch.from_numpy(idx[0])).numpy())
    np.testing.assert_array_equal(_run_body(g.g2_kernel, tbl, lane, out_shape=shape),
                                  GP.lane_plain(t, torch.from_numpy(lane[0])).numpy())
    np.testing.assert_array_equal(_run_body(g.g3_kernel, tbl, rows, out_shape=shape),
                                  GP.rowsel_plain(t, torch.from_numpy(rows[0, :, 0])).numpy())


def test_gather_plain_equals_pallas_rowsel_forms(monkeypatch, tmp_path):
    m1 = _load_experiment("pallas_rowsel_forms", monkeypatch, tmp_path)
    m2 = _load_experiment("pallas_rowsel2", monkeypatch, tmp_path)
    m3 = _load_experiment("pallas_rowsel3", monkeypatch, tmp_path)
    rng = np.random.default_rng(5)
    R_, C, OR = m1.R, m1.C, m1.OR
    tbl = rng.integers(0, 250, (1, R_, C)).astype(np.int32)
    q = rng.integers(0, R_ - 1, (1, 8, OR // 8)).astype(np.int32)
    sh = rng.integers(0, C, (1, 8, OR // 8)).astype(np.int32)
    t, qv = torch.from_numpy(tbl[0]), torch.from_numpy(q[0].reshape(-1))
    want_rows = GP.rowsel_plain(t, qv).numpy()
    shape = (OR, C)
    # H1 take_along_axis, H2 take, H3 one-hot matmul; round 2's O1 uses R=256
    for body in (m1.h1_kernel, m1.h2_kernel, m1.h3_kernel):
        np.testing.assert_array_equal(_run_body(body, tbl, q, out_shape=shape), want_rows)
    q256 = q % 255
    np.testing.assert_array_equal(
        _run_body(m2.o1_kernel, tbl, q256, out_shape=shape),
        GP.rowsel_plain(t, torch.from_numpy(q256[0].reshape(-1))).numpy())
    # H4 and round 2's T3: two rows and a lane rotate = an unaligned row
    starts = torch.from_numpy((q[0].reshape(-1) * C + sh[0].reshape(-1)).astype(np.int32))
    want_unaligned = GP.rowgather_plain(t, starts).numpy()
    np.testing.assert_array_equal(_run_body(m1.h4_kernel, tbl, q, sh, out_shape=shape),
                                  want_unaligned)
    tT = np.ascontiguousarray(tbl.transpose(0, 2, 1))
    np.testing.assert_array_equal(_run_body(m2.t3_kernel, tT, q, sh, out_shape=shape),
                                  want_unaligned)
    np.testing.assert_array_equal(_run_body(m2.t2_kernel, tT, q, out_shape=shape), want_rows)
    # round 3: lane-replicated and full-width index feeds
    qr = np.repeat(q.reshape(1, OR, 1), 128, axis=2)
    for body in (m3.o1_kernel, m3.o3_kernel):
        np.testing.assert_array_equal(_run_body(body, tbl, qr, out_shape=shape), want_rows)
    qf = np.zeros((1, C, R_), np.int32)
    qf[0, :, :OR] = q.reshape(1, OR)
    np.testing.assert_array_equal(_run_body(m3.t2_kernel, tT, qf, out_shape=shape), want_rows)


@pytest.mark.parametrize("tile_rows", [64, 256, 512])
def test_fire_probe_exact_variants_equal_reference(tile_rows):
    for name in ("rle_overlap", "periodic_ring_boundary", "word_soup"):
        data = block_inputs()[name]
        plan = R.build_ring_plan(native.compress_block(data), len(data), tile_rows=tile_rows)
        ts = R.ring_plan_device_tensors(plan, "cpu")
        ref = R.ring_decode_reference(*ts, tile_rows=tile_rows)
        assert ref.reshape(-1)[: len(data)].numpy().tobytes() == data
        for v in FP.EXACT:
            assert torch.equal(FP.fire_probe(v, *ts, tile_rows=tile_rows), ref), (name, v)


def test_fire_probe_on_wild_records_and_ablations():
    plan = R.RingPlan.from_arrays(**wild_plan_fields(256))
    ts = R.ring_plan_device_tensors(plan, "cpu")
    ref = R.ring_decode_reference(*ts, tile_rows=256)
    for v in FP.EXACT:
        assert torch.equal(FP.fire_probe(v, *ts, tile_rows=256), ref)
    for v in set(FP.VARIANTS) - set(FP.EXACT):
        with pytest.raises(ValueError, match="ablation"):
            FP.fire_probe(v, *ts, tile_rows=256)
    with pytest.raises(ValueError):
        FP.fire_probe("base", *ts, tile_rows=512)
    with pytest.raises(ValueError):
        FP.fire_probe("v3", *ts, tile_rows=256)


def test_fire_probe_fit_and_bound():
    # two plans of a known per-tile and per-fire cost give them back
    a, b = FP.fit(320, 854, 320 * 2.5e-3 + 854 * 2.3e-3, 320, 6429, 320 * 2.5e-3 + 6429 * 2.3e-3)
    assert a == pytest.approx(2.5) and b == pytest.approx(2.3)
    data = block_inputs()["word_soup"]
    plan = R.build_ring_plan(native.compress_block(data), len(data))
    fires = int(plan.nf_tot.sum())
    want = plan.lit_init.nbytes + fires * 256 * 12 + plan.nf_tot.nbytes + plan.ntiles * plan.tile_rows * 128
    assert FP.plan_bytes(plan) == want
    assert FP.bound_ms(plan) == pytest.approx(want / 3.35e12 * 1e3)


def test_bench_word_soup_is_deterministic():
    a = FP.bench_word_soup(5000)
    assert a == FP.bench_word_soup(5000) and len(a) == 5000
    assert a != FP.bench_word_soup(5000, vocab=500)
