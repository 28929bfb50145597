#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises and the exit code is not 0):

1. Probe and build: require CUDA, print the card's name and power limit,
   build the native host library (g++) and the ring kernel (nvcc) from the
   checkout's sources, in parallel, and print the build seconds.
2. Kernel vs plain version: on plans of at most 1 MiB at 256- and 512-row
   tiles, the ring kernel (K1a) and its checksum variant (K1b) on the card
   against ``ring_decode_reference`` on the same tensors: byte-equal output,
   equal checksum lanes, and both equal to the data and the host checksum.
3. Main path at full size: a 10 MiB word soup (the synthesis of bench.py's
   self-contained corpus) through ``decode_block_device``,
   ``decompress_frame_device`` and ``LZ4Codec.decompress`` (a frame of 64 KiB
   independent blocks with block checksums, and one of 4 MiB linked blocks
   with a content checksum), and through ``ring_decode(..., ntot=...)`` as
   an on-device consumer. Each path runs with the launch counters set to 0
   just before it and read just after: the kernel must have run and no plan
   may have overflowed to the host decoder. Each frame's plan is then held
   against the plain version as in phase 2.
4. Times on the 10 MiB plan, each line with the card's name and power limit:
   plan build, upload, kernel (CUDA events, median), end to end, the plain
   version and the native host decoder; the 10 MiB plan at 256- and 512-row
   tiles is held against the plain version as in phase 2; then one JSON line
   ``{"kernels": ...}`` whose ``max_abs_err`` covers every comparison.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import random
import statistics
import struct
import subprocess
import sys
import threading
import time

MIB = 1 << 20
REPLACES = "lz4_flex_tpu/ops/ringdecode.py:392"
SOURCE = "lz4_flex_tpu_torch/csrc/ring_decode.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published


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


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")

    from lz4_flex_tpu_torch import native
    from lz4_flex_tpu_torch.frame import decompress_frame_device
    from lz4_flex_tpu_torch.frame.header import BlockInfo, BlockInfoKind, BlockMode, BlockSize, FrameInfo
    from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec
    from lz4_flex_tpu_torch.ops import _kernels
    from lz4_flex_tpu_torch.ops import ringdecode as R
    from lz4_flex_tpu_torch.ops.decode import decode_block_device
    from lz4_flex_tpu_torch.utils.checksum import xxh32

    # ---- 1. probe and build ------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"capability {torch.cuda.get_device_capability()} count {torch.cuda.device_count()}")
    if not R.ring_engine_available():
        raise SystemExit("chip_smoke: the ring kernel needs compute capability 9.0+")

    built, errors = {}, []

    def build(name, fn):
        t0 = time.perf_counter()
        try:
            built[name] = (fn(), time.perf_counter() - t0)
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)

    threads = [threading.Thread(target=build, args=a) for a in
               (("native", native._build), ("ring_decode", _kernels.build_ring_decode))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, (path, secs) in built.items():
        print(f"build {name}: {secs:.2f} s -> {path}")
    with open(built["ring_decode"][0] + ".log") as log:
        for line in log:
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())
    native._lib()
    _kernels.ring_lib()

    def lanes_u32(acc) -> np.ndarray:
        return acc.cpu().numpy().astype(np.int64) & 0xFFFFFFFF

    def lane_sum(acc) -> int:
        return int(lanes_u32(acc).sum() & 0xFFFFFFFF)

    max_err = {"ring_decode": 0, "ring_decode+checksum": 0}

    def compare(plan, want: bytes, label: str, ts=None) -> None:
        """K1a and K1b against the plain version on one uploaded plan."""
        if ts is None:
            ts = R.ring_plan_device_tensors(plan, "cuda")
        tr, n = plan.tile_rows, plan.total_out
        out = R.ring_decode(*ts, tile_rows=tr)
        out_c, acc = R.ring_decode(*ts, tile_rows=tr, ntot=n)
        ref, ref_acc = R.ring_decode_reference(*ts, tile_rows=tr, ntot=n)
        torch.cuda.synchronize()
        e_a = int((out.int() - ref.int()).abs().max())
        e_b = max(int((out_c.int() - ref.int()).abs().max()),
                  int(np.abs(lanes_u32(acc) - lanes_u32(ref_acc)).max()))
        max_err["ring_decode"] = max(max_err["ring_decode"], e_a)
        max_err["ring_decode+checksum"] = max(max_err["ring_decode+checksum"], e_b)
        got = out.reshape(-1)[:n].cpu().numpy().tobytes()
        ok = (e_a == 0 and e_b == 0 and got == want
              and lane_sum(acc) == lane_sum(ref_acc) == R.ring_checksum_expected(want))
        print(f"  {label:28s} TR={tr} bytes={n} fires={int(plan.nf_tot.sum())} "
              f"NF={plan.rec_f0.shape[1]} max_abs_err={e_a}/{e_b} {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            raise SystemExit(f"chip_smoke: kernel and plain version disagree on {label} TR={tr}")

    # ---- 2. kernel vs plain version ---------------------------------------
    print("phase 2: kernel vs plain version (plans <= 1 MiB; tolerance: byte-exact, "
          "max_abs_err must be 0)", flush=True)
    rng = np.random.default_rng(13)
    periodic = []
    for period in (1, 2, 3, 5, 31, 64, 127, 128):
        pat = bytes(rng.integers(97, 123, period, dtype=np.uint8))
        periodic += [pat * (40000 // period), bytes(rng.integers(0, 256, 700, dtype=np.uint8))]
    soup = bench_word_soup(MIB, vocab=2000)  # ratio ~0.65: a match-heavy plan
    blocks = {
        "rle a*N": b"a" * MIB,
        "ab*N": b"ab" * (MIB // 2),
        "periodic ring boundary": b"".join(periodic),
        "nulls": bytes(MIB),
        "incompressible": bytes(rng.integers(0, 256, MIB, dtype=np.uint8)),
        "word soup": soup,
    }
    linked_parts, tail, linked_data = [], b"", b""
    for i in range(0, MIB, 65536):
        raw = soup[i : i + 65536] if i != 5 * 65536 else bytes(rng.integers(0, 256, 65536, dtype=np.uint8))
        if i == 5 * 65536:
            linked_parts.append((raw, False))  # a stored block inside the linked body
        else:
            linked_parts.append((native.compress_block(raw, tail), True))
        linked_data += raw
        tail = linked_data[-65536:]
    dic = bench_word_soup(65536 + 4096, vocab=2000)[-65536:]
    dict_data = bench_word_soup(3 * MIB, vocab=2000)[2 * MIB : 2 * MIB + 512 * 1024]
    for tr in (256, 512):
        for label, data in blocks.items():
            plan = R.build_ring_plan(native.compress_block(data), len(data), tile_rows=tr)
            compare(plan, data, label)
        plan, _ = R.build_ring_plan_parts(linked_parts, len(linked_data), tile_rows=tr)
        compare(plan, linked_data, "linked multi-block body")
        plan, _ = R.build_ring_plan_parts(
            [(dic, False), (native.compress_block(dict_data, dic), True)],
            len(dic) + len(dict_data), tile_rows=tr)
        compare(plan, dic + dict_data, "dict-prefixed body")

    # ---- 3. main path at full size -----------------------------------------
    print("phase 3: main path, 10 MiB word soup", flush=True)
    data = bench_word_soup(10 * MIB)
    n = len(data)
    comp = native.compress_block(data)
    print(f"  corpus {n} bytes, one block of {len(comp)} bytes (ratio {len(comp) / n:.4f})")

    def write_frame(block_size: BlockSize, linked: bool, block_checksums: bool,
                    content_checksum: bool):
        """The frame, and its body as the (payload, is_compressed) parts
        that the frame decoder hands to the ring planner."""
        fi = FrameInfo(block_size=block_size,
                       block_mode=BlockMode.Linked if linked else BlockMode.Independent,
                       block_checksums=block_checksums, content_checksum=content_checksum)
        bs = block_size.get_size()
        out, parts = bytearray(fi.write()), []
        for i in range(0, n, bs):
            raw = data[i : i + bs]
            c = native.compress_block(raw, data[max(0, i - 65536) : i] if linked else b"")
            info, payload = ((BlockInfo(BlockInfoKind.Compressed, len(c)), c) if len(c) < len(raw)
                             else (BlockInfo(BlockInfoKind.Uncompressed, len(raw)), raw))
            parts.append((payload, info.kind == BlockInfoKind.Compressed))
            out += info.write() + payload
            if block_checksums:
                out += struct.pack("<I", xxh32(payload))
        out += BlockInfo(BlockInfoKind.EndMark).write()
        if content_checksum:
            out += struct.pack("<I", xxh32(data))
        return bytes(out), parts

    launches = {"ring_decode": 0, "ring_decode+checksum": 0}

    def main_path(label: str, fn) -> None:
        for k in R.stats:
            R.stats[k] = 0
        fn()
        torch.cuda.synchronize()
        s = dict(R.stats)
        launches["ring_decode"] += s["kernel_launches"] - s["checksum_launches"]
        launches["ring_decode+checksum"] += s["checksum_launches"]
        print(f"  {label:44s} ok, counts {s}", flush=True)
        if s["kernel_launches"] == 0 or s["overflow_host_decodes"] != 0:
            raise SystemExit(f"chip_smoke: {label} did not run through the kernel: {s}")

    def expect(got: bytes, label: str) -> None:
        if got != data:
            raise SystemExit(f"chip_smoke: {label} output differs from the input")

    main_path("decode_block_device", lambda: expect(decode_block_device(comp, n), "block"))
    frames = {
        "64 KiB independent, block checksums": (
            write_frame(BlockSize.Max64KB, False, True, False), False,
            CodecConfig(block_size=BlockSize.Max64KB, block_checksums=True)),
        "4 MiB linked, content checksum": (
            write_frame(BlockSize.Max4MB, True, False, True), True,
            CodecConfig(block_size=BlockSize.Max4MB, block_mode=BlockMode.Linked,
                        content_checksum=True)),
    }
    for label, ((f, parts), linked, cfg) in frames.items():
        main_path(f"decompress_frame_device ({label})",
                  lambda: expect(decompress_frame_device(f), label))
        main_path(f"LZ4Codec.decompress ({label})",
                  lambda: expect(LZ4Codec(cfg).decompress(f), label))
        plan, _ = R.build_ring_plan_parts(parts, n, independent=not linked)
        compare(plan, data, "frame, " + label.split(",")[0])

    def consumer() -> None:
        plan = R.build_ring_plan(comp, n)
        out, acc = R.ring_decode(*R.ring_plan_device_tensors(plan, "cuda"),
                                 tile_rows=plan.tile_rows, ntot=n)
        expect(out.reshape(-1)[:n].cpu().numpy().tobytes(), "consumer")
        if lane_sum(acc) != R.ring_checksum_expected(data):
            raise SystemExit("chip_smoke: in-kernel checksum differs from the host's")

    main_path("ring_decode(ntot=...) on-device consumer", consumer)

    # ---- 4. times -------------------------------------------------------------
    print(f"phase 4: times on the 10 MiB plan [{card}]", flush=True)

    def host_ms(fn, iters: int) -> float:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def kernel_ms(fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def cuda_host_ms(fn, iters: int) -> float:
        def run():
            fn()
            torch.cuda.synchronize()
        return host_ms(run, iters)

    results = {}
    for tr in (R.TILE_ROWS, 512):
        plan_ms = host_ms(lambda: R.build_ring_plan(comp, n, tile_rows=tr), 10)
        plan = R.build_ring_plan(comp, n, tile_rows=tr)
        h2d_ms = cuda_host_ms(lambda: R.ring_plan_device_tensors(plan, "cuda"), 10)
        ts = R.ring_plan_device_tensors(plan, "cuda")
        torch.cuda.synchronize()
        ms_a = kernel_ms(lambda: R.ring_decode(*ts, tile_rows=tr))
        ms_b = kernel_ms(lambda: R.ring_decode(*ts, tile_rows=tr, ntot=n))
        plain_a = cuda_host_ms(lambda: R.ring_decode_reference(*ts, tile_rows=tr), 3)
        plain_b = cuda_host_ms(lambda: R.ring_decode_reference(*ts, tile_rows=tr, ntot=n), 3)
        compare(plan, data, "10 MiB block (main path)", ts=ts)
        fires = int(plan.nf_tot.sum())
        moved = (plan.lit_init.nbytes + fires * plan.rb * 12 + plan.nf_tot.nbytes
                 + plan.ntiles * tr * 128)
        bound_a = moved / HBM_BYTES_PER_S * 1e3
        bound_b = (moved + 128 * 4) / HBM_BYTES_PER_S * 1e3
        if tr == R.TILE_ROWS:
            ts_main = ts
        results[tr] = dict(ms_a=ms_a, ms_b=ms_b, plain_a=plain_a, plain_b=plain_b,
                           bound_a=bound_a, bound_b=bound_b)
        print(f"  TR={tr} tiles={plan.ntiles} fires={fires} NF={plan.rec_f0.shape[1]} "
              f"bytes_moved={moved} [{card}]")
        print(f"  TR={tr} plan_build_ms={plan_ms:.4f} h2d_ms={h2d_ms:.4f} "
              f"kernel_ms={ms_a:.4f} kernel_checksum_ms={ms_b:.4f} "
              f"kernel_MiB/s={n / MIB / (ms_a / 1e3):.1f} bound_ms={bound_a:.5f} "
              f"plain_ms={plain_a:.2f} plain_checksum_ms={plain_b:.2f} [{card}]", flush=True)
    # bench.py's synthetic vocabulary barely compresses (ratio ~0.97); a
    # small vocabulary gives the kernel a match-heavy plan of the same size.
    rich = bench_word_soup(10 * MIB, vocab=500)
    rcomp = native.compress_block(rich)
    rplan = R.build_ring_plan(rcomp, len(rich))
    rts = R.ring_plan_device_tensors(rplan, "cuda")
    r_ms = kernel_ms(lambda: R.ring_decode(*rts, tile_rows=rplan.tile_rows))
    if R.ring_decode(*rts, tile_rows=rplan.tile_rows).reshape(-1)[: len(rich)].cpu().numpy().tobytes() != rich:
        raise SystemExit("chip_smoke: the match-heavy soup decoded wrong")
    r_e2e = host_ms(lambda: decode_block_device(rcomp, len(rich)), 10)
    print(f"  match-heavy soup (vocabulary 500, ratio {len(rcomp) / len(rich):.4f}): "
          f"TR={rplan.tile_rows} fires={int(rplan.nf_tot.sum())} kernel_ms={r_ms:.4f} "
          f"decode_block_device_ms={r_e2e:.3f} [{card}]", flush=True)
    e2e_ms = host_ms(lambda: decode_block_device(comp, n), 10)
    host_dec_ms = host_ms(lambda: native.decompress_block(comp, n), 10)
    measure_ms = host_ms(lambda: native.measure_block(comp), 10)
    flat = R.ring_decode(*ts_main, tile_rows=R.TILE_ROWS).reshape(-1)[:n]
    d2h_ms = cuda_host_ms(lambda: flat.cpu().numpy().tobytes(), 10)
    print(f"  decode_block_device end to end (TR={R.TILE_ROWS}): {e2e_ms:.3f} ms = "
          f"{n / MIB / (e2e_ms / 1e3):.1f} MiB/s; of it host size walk of the input "
          f"{measure_ms:.3f} ms, output to bytes on the host {d2h_ms:.3f} ms [{card}]")
    print(f"  native host decoder on the same block: {host_dec_ms:.3f} ms = "
          f"{n / MIB / (host_dec_ms / 1e3):.1f} MiB/s (yardstick; no single PyTorch call "
          f"computes a ring decode, so library_ms is null) [{card}]")

    main = results[R.TILE_ROWS]
    kernels = [
        {"name": "ring_decode", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": launches["ring_decode"], "max_abs_err": max_err["ring_decode"],
         "ms": main["ms_a"], "plain_ms": main["plain_a"], "bound_ms": main["bound_a"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "ring_decode+checksum", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches["ring_decode+checksum"],
         "max_abs_err": max_err["ring_decode+checksum"], "ms": main["ms_b"],
         "plain_ms": main["plain_b"], "bound_ms": main["bound_b"], "bound_by": "bytes",
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
