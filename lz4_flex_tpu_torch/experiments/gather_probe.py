"""Gather probe: gathers and row moves from a table in shared memory.

    python -m lz4_flex_tpu_torch.experiments.gather_probe   # needs a CUDA card

The Hopper counterpart of the TPU probes experiments/pallas_gather_forms.py,
pallas_rowsel_forms.py, pallas_rowsel2.py, pallas_rowsel3.py and
rowgather_forms.py. csrc/gather_probe.cu runs each function in the forms
worth comparing on this card (a byte per thread, 16 bytes per thread, a warp
per row) on a 96 KiB table resident in shared memory, in one CTA, as K1 runs.
Each function has its plain PyTorch version here (tensor indexing); every
variant is exact. :func:`run` holds each variant against its plain version
on the card and times it beside its shared-memory bound.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from ..ops import _kernels
from .fire_probe import kernel_ms

SOURCE = "lz4_flex_tpu_torch/csrc/gather_probe.cu"
TBL_ROWS = 768  # 96 KiB of 128-byte rows
OUT_ROWS = 128  # 16 KiB out
WIDTH = 128
REPS = 256  # passes per launch when timed
SMEM_BYTES_PER_CLOCK = 128  # per SM and direction

#: Variants in the order of the enum in csrc/gather_probe.cu.
VARIANTS = (
    "flat_byte", "flat_vec16", "lane_byte", "lane_warp",
    "rowsel_byte", "rowsel_vec16", "rowsel_warp",
    "rowgather_byte", "rowgather_vec16", "rowgather_warp",
    "rowscatter_byte", "rowscatter_vec16", "rowscatter_warp",
)
#: The TPU probe (``pallas_call`` site) of each function.
REPLACES = {
    "flat": "experiments/pallas_gather_forms.py:69",
    "lane": "experiments/pallas_gather_forms.py:69",
    "rowsel": "experiments/pallas_rowsel_forms.py:76",
    "rowgather": "experiments/rowgather_forms.py:160",
    "rowscatter": "experiments/rowgather_forms.py:160",
}

#: Launches per variant (each launch of its kernel adds one).
stats = {v: 0 for v in VARIANTS}


def function_of(variant: str) -> str:
    return variant.split("_")[0]


# ---- plain versions: any table height, any number of output rows -----------


def flat_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[e] = tbl.flatten()[idx[e]] (the shape of idx)."""
    return tbl.reshape(-1)[idx.long()]


def lane_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, l] = tbl[i, idx[i, l]] for the first idx.shape[0] rows."""
    return torch.gather(tbl[: idx.shape[0]], 1, idx.long())


def rowsel_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = tbl[idx[i], :]."""
    return tbl[idx.long()]


def rowgather_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, l] = tbl.flatten()[idx[i] + l], rows of the table's width
    starting at arbitrary byte offsets."""
    cols = torch.arange(tbl.shape[1], device=tbl.device)
    return tbl.reshape(-1)[idx.long()[:, None] + cols]


def rowscatter_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[idx[i], :] = tbl[i, :] for i < len(idx); idx is a permutation."""
    out = torch.empty((idx.shape[0], tbl.shape[1]), dtype=tbl.dtype, device=tbl.device)
    out[idx.long()] = tbl[: idx.shape[0]]
    return out


PLAIN = {"flat": flat_plain, "lane": lane_plain, "rowsel": rowsel_plain,
         "rowgather": rowgather_plain, "rowscatter": rowscatter_plain}

#: One PyTorch call that computes each function (given int64 indices), timed
#: beside the kernels as a yardstick; no single call gathers unaligned rows.
LIBRARY = {
    "flat": lambda tbl, i64: torch.take(tbl, i64),
    "lane": lambda tbl, i64: torch.gather(tbl[: i64.shape[0]], 1, i64),
    "rowsel": lambda tbl, i64: torch.index_select(tbl, 0, i64),
    "rowgather": None,
    "rowscatter": lambda tbl, i64: tbl[: i64.shape[0]].index_copy(0, i64, tbl[: i64.shape[0]]),
}


def make_inputs(function: str, seed: int = 0, *, tbl_rows: int = TBL_ROWS,
                out_rows: int = OUT_ROWS, width: int = WIDTH):
    """A random uint8 table (tbl_rows, width) and the function's int32
    indices for out_rows output rows, as numpy arrays made from ``seed``."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 256, (tbl_rows, width), dtype=np.uint8)
    n = tbl_rows * width
    if function == "flat":
        idx = rng.integers(0, n, (out_rows, width))
    elif function == "lane":
        idx = rng.integers(0, width, (out_rows, width))
    elif function == "rowsel":
        idx = rng.integers(0, tbl_rows, out_rows)
    elif function == "rowgather":
        idx = rng.integers(0, n - width + 1, out_rows)
    elif function == "rowscatter":
        idx = rng.permutation(out_rows)
    else:
        raise ValueError(f"unknown gather function {function!r}")
    return tbl, idx.astype(np.int32)


def gather(variant: str, tbl: torch.Tensor, idx: torch.Tensor, *, reps: int = 1) -> torch.Tensor:
    """Run one variant; returns the (OUT_ROWS, 128) uint8 result. On CUDA
    tensors this launches the variant's kernel (``reps`` passes) and nothing
    else; on CPU tensors it runs the function's plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown gather probe variant {variant!r}")
    fn = function_of(variant)
    want_idx = (OUT_ROWS, WIDTH) if fn in ("flat", "lane") else (OUT_ROWS,)
    if tbl.dtype != torch.uint8 or tuple(tbl.shape) != (TBL_ROWS, WIDTH):
        raise ValueError(f"tbl must be uint8 ({TBL_ROWS}, {WIDTH}), got {tbl.dtype} {tuple(tbl.shape)}")
    if idx.dtype != torch.int32 or tuple(idx.shape) != want_idx:
        raise ValueError(f"{fn} takes int32 indices of shape {want_idx}, got {idx.dtype} {tuple(idx.shape)}")
    if tbl.device != idx.device:
        raise ValueError("tbl and idx lie on different devices")
    if tbl.device.type != "cuda":
        return PLAIN[fn](tbl, idx)
    from ..ops.ringdecode import check_kernel_layout

    check_kernel_layout(tbl=tbl, idx=idx)
    out = torch.empty((OUT_ROWS, WIDTH), dtype=torch.uint8, device=tbl.device)
    lib = _kernels.lib("gather_probe")
    with torch.cuda.device(tbl.device):
        err = lib.tlz4_gather_probe(VARIANTS.index(variant), tbl.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), reps, torch.cuda.current_stream().cuda_stream)
    _kernels.check_launch(err, f"gather_probe {variant}", lib.tlz4_gather_probe_error_string)
    stats[variant] += 1
    return out


def smem_bound_ms(sm_clock_mhz: float) -> float:
    """Least time of one pass: it reads 16 KiB from the table and writes the
    16 KiB output through shared memory, at 128 B per clock of one SM in each
    direction (the 16-byte forms measure faster than 128 B per clock for
    reads and writes together, so the two are not counted as one stream)."""
    return OUT_ROWS * WIDTH / (SMEM_BYTES_PER_CLOCK * sm_clock_mhz * 1e6) * 1e3


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout
    return float(out.strip().splitlines()[0])


def run(card: str = "", *, iters: int = 10, reps: int = REPS, log=print) -> dict:
    """Hold every variant against its plain version on the card and time
    one pass of it: (launch of ``reps`` passes - launch of one) / (reps - 1),
    which leaves out the launch and the table fill. Returns ``{variant:
    {"ms", "launch_ms", "plain_ms", "library_ms", "max_abs_err",
    "bound_ms"}}``, all per pass but ``launch_ms``; raises SystemExit on a
    mismatch."""
    if _kernels.lib("gather_probe").tlz4_gather_probe_variants() != len(VARIANTS):
        raise RuntimeError("VARIANTS does not match the enum in csrc/gather_probe.cu")
    clock = max_sm_clock_mhz()
    log(f"  gather_probe: table {TBL_ROWS}x{WIDTH} B in shared memory, passes of "
        f"{OUT_ROWS}x{WIDTH} B, max SM clock {clock:.0f} MHz [{card}]")
    res = {}
    for seed, v in enumerate(VARIANTS):
        fn = function_of(v)
        tbl_np, idx_np = make_inputs(fn, seed)
        tbl = torch.from_numpy(tbl_np).cuda()
        idx = torch.from_numpy(idx_np).cuda()
        got = gather(v, tbl, idx)
        ref = PLAIN[fn](tbl, idx).reshape(OUT_ROWS, WIDTH)
        err = int((got.int() - ref.int()).abs().max())
        if err:
            raise SystemExit(f"gather_probe: {v} differs from its plain version (max_abs_err {err})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            PLAIN[fn](tbl, idx)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) / iters * 1e3
        one = kernel_ms(lambda: gather(v, tbl, idx, reps=1), iters=iters, warmup=2)
        many = kernel_ms(lambda: gather(v, tbl, idx, reps=reps), iters=iters, warmup=2)
        ms = (many - one) / (reps - 1)
        lib_ms = None
        if LIBRARY[fn] is not None:
            i64 = idx.long()
            if not torch.equal(LIBRARY[fn](tbl, i64).reshape(OUT_ROWS, WIDTH), ref):
                raise SystemExit(f"gather_probe: the library call for {v} disagrees")
            lib_ms = kernel_ms(lambda: LIBRARY[fn](tbl, i64), iters=iters, warmup=2)
        res[v] = dict(ms=ms, launch_ms=many, plain_ms=plain_ms, library_ms=lib_ms,
                      max_abs_err=err, bound_ms=smem_bound_ms(clock))
        log(f"  gather_probe {v:17s} pass_ms={ms:.6f} bound_ms={res[v]['bound_ms']:.6f} "
            f"launch_ms({reps} passes)={many:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} max_abs_err={err} [{card}]")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe: needs a CUDA card")
    run(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
