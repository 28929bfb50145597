"""Fire probe: the ring decoder's fire loop on real plans, in variants.

    python -m lz4_flex_tpu_torch.experiments.fire_probe     # needs a CUDA card

The Hopper counterpart of the TPU fire-step probes (experiments/fire_step.py,
fire_ablate.py, fire_ablate3.py, fire_ablate5.py, batchfire.py,
batchfire2.py). csrc/fire_probe.cu holds one kernel per variant: the first
design of K1 (``base``), the same body with 512 and 256 threads, the second
design (``v2``, the production K1a with 30 fire warps, and ``v2_t512`` with
16), and ablations of ``base`` and of ``v2`` whose output is wrong by
design. :func:`run` times every variant on
the 10 MiB bench soup and on the match-heavy soup at 256- and 512-row tiles,
and fits each variant's time as ``tiles * per_tile + fires * per_fire`` over
the two plans of one tile height.
"""

from __future__ import annotations

import random
import statistics
import time

import numpy as np
import torch

from .. import native
from ..ops import _kernels
from ..ops import ringdecode as R

MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
SOURCE = "lz4_flex_tpu_torch/csrc/fire_probe.cu"

#: Variants in the order of the enum in csrc/fire_probe.cu.
VARIANTS = (
    "base", "nofields", "nomod", "nogather", "noscatter", "onebarrier",
    "noshift", "noseed", "noemit", "base_t512", "base_t256", "v2", "v2_t512",
    "v2_nofires", "v2_notable", "v2_nobarrier",
)
#: Variants that compute the ring decode exactly (ring_decode_reference is
#: their plain version); the others are ablations, for timing only.
EXACT = ("base", "base_t512", "base_t256", "v2", "v2_t512")
#: The TPU probe (``pallas_call`` site) that asked each variant's question.
REPLACES = {
    "base": "experiments/fire_step.py:134",
    "nofields": "experiments/fire_ablate5.py:156",
    "nomod": "experiments/fire_ablate3.py:208",
    "nogather": "experiments/fire_ablate.py:173",
    "noscatter": "experiments/fire_ablate.py:173",
    "onebarrier": "experiments/fire_ablate3.py:330",
    "noshift": "experiments/fire_ablate5.py:156",
    "noseed": "experiments/fire_ablate5.py:156",
    "noemit": "experiments/fire_ablate5.py:156",
    "base_t512": "experiments/batchfire.py:142",
    "base_t256": "experiments/batchfire2.py:146",
    "v2": "lz4_flex_tpu/ops/ringdecode.py:392",
    "v2_t512": "lz4_flex_tpu/ops/ringdecode.py:392",
    "v2_nofires": "experiments/fire_ablate5.py:156",
    "v2_notable": "experiments/fire_ablate5.py:156",
    "v2_nobarrier": "experiments/fire_ablate5.py:156",
}

#: Launches per variant (each launch of its kernel adds one).
stats = {v: 0 for v in VARIANTS}


def bench_word_soup(n: int, vocab: int = 20000) -> bytes:
    """bench.py's self-contained corpus: a random.Random(1) vocabulary of
    ``vocab`` words (20000 there), picked with random.Random(0xD1C8E25)."""
    rng = random.Random(1)
    words = [
        "".join(chr(rng.randrange(97, 123)) for _ in range(rng.randrange(2, 11)))
        for _ in range(vocab)
    ]
    words = list(dict.fromkeys(words))
    rng = random.Random(0xD1C8E25)
    out, size = [], 0
    while size < n:
        w = words[rng.randrange(len(words))]
        out.append(w)
        size += len(w) + 1
    return " ".join(out).encode()[:n]


def fire_probe(variant: str, init, f0, f1, f2, nf_tot, *, tile_rows: int = R.TILE_ROWS):
    """Run one variant over an uploaded plan; returns the (ntiles*tile_rows,
    128) uint8 tiles. On CUDA tensors this launches the variant's kernel and
    nothing else; on CPU tensors an exact variant runs
    ``ring_decode_reference`` and an ablation raises ValueError."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown fire probe variant {variant!r}")
    R.check_plan_tensors(init, f0, f1, f2, nf_tot, tile_rows)
    if init.device.type != "cuda":
        if variant not in EXACT:
            raise ValueError(f"{variant} is an ablation: it has no plain version")
        return R.ring_decode_reference(init, f0, f1, f2, nf_tot, tile_rows=tile_rows)
    R.check_kernel_layout(init=init, f0=f0, f1=f1, f2=f2, nf_tot=nf_tot)
    out = torch.empty(init.shape, dtype=torch.uint8, device=init.device)
    if nf_tot.shape[0]:
        lib = _kernels.lib("fire_probe")
        with torch.cuda.device(init.device):
            err = lib.tlz4_fire_probe(
                VARIANTS.index(variant), init.data_ptr(), f0.data_ptr(), f1.data_ptr(),
                f2.data_ptr(), nf_tot.data_ptr(), out.data_ptr(),
                f0.shape[0], f0.shape[1], tile_rows, torch.cuda.current_stream().cuda_stream,
            )
        _kernels.check_launch(err, f"fire_probe {variant}", lib.tlz4_fire_probe_error_string)
        stats[variant] += 1
    return out


def kernel_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events around each call.
    With ``flush`` (a CUDA tensor), it is overwritten before every timed call
    so that the call starts with a cold L2."""
    for _ in range(warmup):
        fn()
    times = []
    for i in range(iters):
        if flush is not None:
            flush.fill_(i & 255)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def plan_bytes(plan) -> int:
    """Bytes the ring decode must move through device memory: the literal
    image, the records of the fires it runs, nf_tot, and the output."""
    fires = int(np.minimum(plan.nf_tot, plan.rec_f0.shape[1]).sum())
    return (plan.lit_init.nbytes + fires * plan.rb * 12 + plan.nf_tot.nbytes
            + plan.ntiles * plan.tile_rows * 128)


def plan_work(plan) -> tuple[int, int, int]:
    """(fires, live records, bytes the records write) of a plan: the work a
    fire loop does, padding records left out."""
    tr = plan.tile_rows
    live_fire = np.arange(plan.rec_f0.shape[1])[None, :] < plan.nf_tot[:, None]
    f1, f2 = plan.rec_f1[live_fire], plan.rec_f2[live_fire]
    live = ((f2 >> 7) & (2 * tr - 1)) < tr
    lo = (f1 >> 14) & 127
    n = np.minimum(lo + (f2 & 127) + 1, 128) - lo
    return int(live_fire.sum()), int(live.sum()), int(n[live].sum())


def bound_ms(plan) -> float:
    """The least time the card could take: :func:`plan_bytes` over the
    published HBM rate (the decode does no arithmetic worth a bound)."""
    return plan_bytes(plan) / HBM_BYTES_PER_S * 1e3


def probe_corpora() -> dict:
    """The probe's two 10 MiB corpora: bench.py's synthesis (barely
    compresses: few fires per tile) and its 500-word variant (match-heavy)."""
    return {"bench soup": bench_word_soup(10 * MIB),
            "match-heavy soup": bench_word_soup(10 * MIB, vocab=500)}


def fit(t1: int, f1: int, ms1: float, t2: int, f2: int, ms2: float) -> tuple[float, float]:
    """(us per tile, us per fire) of ``ms = tiles*a + fires*b`` through two plans."""
    det = t1 * f2 - t2 * f1
    a = (ms1 * f2 - ms2 * f1) / det
    b = (t1 * ms2 - t2 * ms1) / det
    return a * 1e3, b * 1e3


def run(card: str = "", *, corpora=None, tile_rows=(256, 512), iters: int = 20,
        log=print) -> dict:
    """Time every variant on each corpus at each tile height, hold the exact
    ones against ``ring_decode_reference`` on the card, and fit the per-tile
    and per-fire costs. Returns ``{"rows": [...], "fits": {...},
    "floor": {...}, "plain_ms": {...}}``; each row is one (variant, tile
    height, corpus) with ``ms``, ``max_abs_err`` (None for an ablation),
    ``bound_ms``, ``tiles`` and ``fires``."""
    if _kernels.lib("fire_probe").tlz4_fire_probe_variants() != len(VARIANTS):
        raise RuntimeError("VARIANTS does not match the enum in csrc/fire_probe.cu")
    corpora = probe_corpora() if corpora is None else corpora
    rows, fits, floor, plain_ms = [], {}, {}, {}
    for tr in tile_rows:
        shapes = {}
        for cname, data in corpora.items():
            plan = R.build_ring_plan(native.compress_block(data), len(data), tile_rows=tr)
            ts = R.ring_plan_device_tensors(plan, "cuda")
            fires, records, nbytes = plan_work(plan)
            shapes[cname] = (plan.ntiles, fires, records)
            log(f"  fire_probe TR={tr} {cname}: tiles={plan.ntiles} fires={fires} "
                f"live_records={records} record_bytes={nbytes} NF={plan.rec_f0.shape[1]}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = R.ring_decode_reference(*ts, tile_rows=tr)
            torch.cuda.synchronize()
            plain_ms[(tr, cname)] = (time.perf_counter() - t0) * 1e3
            if ref.reshape(-1)[: len(data)].cpu().numpy().tobytes() != data:
                raise SystemExit(f"fire_probe: the plain version decoded {cname} wrong")
            bnd = bound_ms(plan)
            for v in VARIANTS:
                err = None
                if v in EXACT:
                    got = fire_probe(v, *ts, tile_rows=tr)
                    err = int((got.int() - ref.int()).abs().max())
                ms = kernel_ms(lambda: fire_probe(v, *ts, tile_rows=tr), iters=iters, warmup=2)
                rows.append(dict(variant=v, tile_rows=tr, corpus=cname, tiles=plan.ntiles,
                                 fires=fires, ms=ms, max_abs_err=err, bound_ms=bnd))
                log(f"  fire_probe TR={tr} {cname:16s} {v:10s} ms={ms:.4f} "
                    f"max_abs_err={'-' if err is None else err} tiles={plan.ntiles} "
                    f"fires={fires} bound_ms={bnd:.5f} [{card}]")
                if err:
                    raise SystemExit(f"fire_probe: {v} differs from the plain version on "
                                     f"{cname} TR={tr} (max_abs_err {err})")
            del ts, ref
        (c1, (t1, f1, r1)), (c2, (t2, f2, r2)) = list(shapes.items())[:2]
        by = {(r["variant"], r["corpus"]): r["ms"] for r in rows if r["tile_rows"] == tr}
        for v in VARIANTS:
            fits[(tr, v)] = fit(t1, f1, by[(v, c1)], t2, f2, by[(v, c2)])
            per_fire, per_rec = fit(f1, r1, by[(v, c1)], f2, r2, by[(v, c2)])
            log(f"  fire_probe fit TR={tr} {v:12s} per_tile_us={fits[(tr, v)][0]:.4f} "
                f"per_fire_us={fits[(tr, v)][1]:.4f}; or per_fire_us={per_fire:.4f} "
                f"per_live_record_ns={per_rec * 1e3:.4f} [{card}]")
        # Where the second design's time goes, from its ablations.
        for cname in shapes:
            v2 = {v: by[(v, cname)] for v in VARIANTS if v.startswith("v2")}
            log(f"  fire_probe v2 split TR={tr} {cname}: total {v2['v2']:.4f} ms = tile pipeline "
                f"{v2['v2_nofires']:.4f} + fire skeleton {v2['v2_notable'] - v2['v2_nofires']:.4f} "
                f"(barriers {v2['v2_notable'] - v2['v2_nobarrier']:.4f}) + table work "
                f"{v2['v2'] - v2['v2_notable']:.4f} ms [{card}]")
        # The serial chain's floor: every tile and fire pays at least one
        # barrier and one dependent shared-memory pass. The barrier is what
        # dropping one barrier per fire saved; the pass is the cheaper of
        # what dropping the gather or the scatter saved.
        per_fire = {v: fits[(tr, v)][1] for v in VARIANTS}
        barrier_us = per_fire["base"] - per_fire["onebarrier"]
        pass_us = min(per_fire["base"] - per_fire["nogather"], per_fire["base"] - per_fire["noscatter"])
        for cname, (nt, nfire, _) in shapes.items():
            floor[(tr, cname)] = (nt + nfire) * (barrier_us + pass_us) / 1e3
            log(f"  fire_probe floor TR={tr} {cname}: (tiles {nt} + fires {nfire}) x "
                f"(barrier {barrier_us:.4f} us + shared-memory pass {pass_us:.4f} us) = "
                f"{floor[(tr, cname)]:.4f} ms [{card}]")
    return {"rows": rows, "fits": fits, "floor": floor, "plain_ms": plain_ms}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fire_probe: needs a CUDA card")
    run(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
