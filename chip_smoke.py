#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises and the exit code is not 0):

1. Probe and build: require CUDA, print the card's name and power limit,
   build the native host library (g++), the ring kernel, the resident decode
   kernel and the probes (nvcc) from the checkout's sources, in parallel, and
   print the build seconds.
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
   may have overflowed (``overflow_fused_decodes`` and ``overflow_splits``
   stay 0). Each frame's plan is then held against the plain version as in
   phase 2.
4. Times on the 10 MiB plan, each line with the card's name and power limit:
   plan build, upload, kernel (CUDA events, median; warm and with a cold L2),
   end to end, the plain version and the native host decoder; K1 and the
   first design of K1 (the fire probe's ``base``) in turns (base, K1, K1,
   base) on the bench soup at 256- and 512-row tiles and on the match-heavy
   soup; the 10 MiB plan at 256- and 512-row tiles is held against the plain
   version as in phase 2.
5. Probes (lz4_flex_tpu_torch/experiments): every variant of the fire probe
   on both soups at 256- and 512-row tiles, with the exact ones held against
   the plain version and each variant's per-tile and per-fire cost; every
   gather form held against its plain version and timed per pass beside its
   shared-memory bound. Their launch counters are set to 0 just before.
6. Streaming decode: ``FrameDecoder(engine="device").read_all()`` on phase
   3's two frames, a legacy frame of 8 MiB blocks and a concatenation of two
   frames, each byte-exact, with K1 launched once per batch (the batches
   counted from the frame by the decoder's budgets) and no overflow (no
   fused decode, no split batch); its time beside ``decompress_frame_device``
   and the host engine's. The first batch's plan of the 64 KiB and the
   legacy frame (the shapes this path launches) is held against the plain
   version as in phase 2.
7. Encode: the candidate planes on the card held bit-equal to the same torch
   ops on the CPU (phase 2's inputs and the first quad of the 10 MiB soup);
   ``compress_block_hybrid`` on both 10 MiB soups, ``LZ4Codec.compress`` (4
   MiB linked blocks) and ``FrameEncoder(engine="device")`` (1 MiB blocks),
   each decoded back to its input by the native decoder and the device
   decoders, with the plane counter set to 0 before each; stage times
   (plane quad and its sort, upload, plane copy to the host, chunk walks,
   stitch) and end to end beside ``native.compress_block``.
8. Fallback decode engines (torch ops, the ring path's overflow fallback):
   on phase 2's six blocks, its linked and dict-prefixed bodies and the
   first MiB of the 10 MiB soup, the v1 and v2 expansions, v2's three
   stages, the doubling parse and ``decode_parts_fused`` on the card held
   bit-equal to the same functions on the CPU. On the 10 MiB soup,
   byte-exact: ``decode_block_device(parse="host")`` with v1 and v2 and
   ``parse="device"``, ``decode_parts_fused`` on phase 3's two frame bodies
   and ``LZ4Codec.decode_step`` on a batch of 32 blocks of 64 KiB, with no
   K1 launch. The batched programs (the JAX package's ``vmap`` over rows:
   ``parse_rows``, ``expand_core`` and ``expand2_core`` on (B, ...)
   tables, ``decode_resident_rows``) on 8 rows of 64 KiB with one malformed
   row held bit-equal to their CPU run, each row equal to it decoded alone;
   ``decode_step`` on device tensors at B=1, 8, 32 and 160 (the whole soup)
   byte-exact, with its time, device events, peak device memory and bytes
   bound; each call must be one launch of the resident kernel by its
   counter, and 20 calls at B=32 under one profiler window must show the
   card about one resident kernel event a call and no other. The resident
   kernel alone at the batch cell's shape (B = 16, 87 and 256 rows of
   64 KiB blocks of Zipf word soup) against ``decode_resident_rows_reference``
   on the same tensors: byte-exact, timed beside it. Stage
   times (map build, resolution, materialization, parse)
   and end to end beside the ring engine and the native host decoder. The
   walk and strided parses on one 64 KiB block, timed and held against the
   doubling parse and their CPU run. Then a one-step NFMAX ladder forces
   every plan to overflow: ``decode_block_device`` without and with a
   dictionary, ``decompress_frame_device`` and a one-block
   ``FrameDecoder`` batch must each decode byte-exact through one fused
   decode, with no K1 launch and the host decoder refusing every call.
9. All-device encode: ``match_core``, ``emit_core``, ``encode_chunk_core``
   (on the card the kernel ``csrc/encode_rows.cu``), ``_match_quad`` and
   ``_merge_emit`` on the card
   held bit-equal to the same functions on the CPU, on the arguments they
   were called with (the first 256 KiB of each of phase 2's blocks as one
   chunk and as 64 KiB frame blocks; the first dispatch of the default
   codec's frame, the first quad and the merge of the resident encode of
   the 10 MiB soup, and the single-chunk encode of 300 KiB with a
   dictionary). Full size on the 10 MiB soup, each decoded back to its
   input by the native decoder and the port's device decoders:
   ``LZ4Codec().compress`` (160 independent 64 KiB blocks), 64 KiB linked
   with a content checksum, 256 KiB with block checksums,
   ``FrameEncoder(engine="device")`` at 64 KiB, ``LZ4Codec.compress_block``
   on the whole soup (resident: 23 chunk rows, 6 quads) and on 300 KiB with
   a dictionary, and ``encode_step`` on 32 rows of 98,304 bytes; each with
   the encode counters set to 0 just before it: the device programs ran,
   no candidate plane ran, and the verify guard never fell back. The
   encode kernel on the default frame's first dispatch (32 rows of 98,304
   bytes) against its plain version ``encode_chunk_core_reference`` on the
   same tensors: byte-exact, timed beside it, and one kernel event a call
   over 20 calls under one profiler window. Stage
   times, end to end beside ``compress_block_hybrid`` and
   ``native.compress_block``, peak device memory, device busy share and
   top kernels.
10. The mesh layer on one card, a mesh's entries repeating ``cuda:0`` (N
   device groups on the card), and the CLI. At N=1 every mesh entry point
   (``encode_blocks_sharded`` at 64 KiB and 1 MiB, ``compress_frame_device``,
   ``decompress_frame_device`` of the default codec's 160-block frame,
   ``LZ4Codec``, ``FrameEncoder(engine="device")``) gives the bytes of the
   run without a mesh, decoded back by the native decoder. At N=4 and 8,
   ``decode_blocks_sharded`` and ``decompress_frame_device`` of that frame
   each launch K1c once (counters set to 0 just before), with no overflow
   and no resident fallback; each group's plan through K1c is held against
   ``ring_decode_grouped_reference`` (byte-exact); 1 MiB blocks take
   ``compress_block_device`` per block, N=4's bytes equal N=8's and decode
   back. A forced overflow at N=2 (8 blocks of 64 KiB) decodes byte-exact
   through ``_decode_blocks_sharded_resident`` with no K1 launch and the host
   decoder refusing; ``roundtrip_step_sharded`` at N=2 returns ok. Times: K1a
   on the frame as one plan and K1c at G=1, 4 and 8 in turns (CUDA events,
   median of 20) beside their bytes bounds, the plan-build wall at G=1, 4
   and 8, and end to end beside the one-card path. The CLI with ``--engine
   device`` as subprocesses: a 4 MiB pipe and file roundtrip, its frames
   equal to ``compress_frame_device``'s and read back by the host engine.
11. The examples and a two-process mesh. The five examples as ``python -m
   lz4_flex_tpu_torch.examples.<name>`` subprocesses: ``compress`` then
   ``decompress`` and ``compress_block`` then ``decompress_block`` on the 4
   MiB input of phase 10 (each equal to the host codec's bytes and back to
   the input), and ``device_pipeline`` on the 10 MiB bench soup (its line
   names the size of ``LZ4Codec``'s 64 KiB linked frame, which decodes back
   in this process with K1 launched). Then two processes of this script
   (``--mesh-worker``) join a group through ``distributed_init``, both on
   ``cuda:0``, the pipelines' gathers running over its gloo group. At global
   meshes of 2x2 and 2x4 entries, on phase 9's 160-block default frame,
   ``decompress_frame_device(mesh=)`` and ``compress_frame_device(mesh=)``
   on every rank equal the one-process N=4 and N=8 bytes; each process
   launches K1c once a decode (counters set to 0 just before), with no
   overflow; each rank's groups through K1c are held against
   ``ring_decode_grouped_reference`` (byte-exact). A forced overflow on rank
   1 alone (8 blocks) sends both ranks to the resident decoder, byte-exact,
   with no K1 launch, timed on its first call in the process and again; a
   corrupted block in rank 1's span raises
   ``OffsetOutOfBounds`` on both ranks. The two-process wall times print
   beside phase 10's one-process N=4 and N=8 times. A worker that fails,
   times out or disagrees fails the run.
   Then one JSON line ``{"kernels": ...}`` whose ``max_abs_err`` covers every
   comparison and whose K1 and K1c launches count every path of phases 3,
   6, 7 and 9-11; its ``resident_decode:B=<rows>`` entries are phase 8's
   timings of the resident kernel, their launches counted around them.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import threading
import time

MIB = 1 << 20
REPLACES = "lz4_flex_tpu/ops/ringdecode.py:392"
SOURCE = "lz4_flex_tpu_torch/csrc/ring_decode.cu"
L2_FLUSH_BYTES = 64 * MIB  # written between launches for a cold-L2 time (L2: 50 MB)
MESH_WORKER = "--mesh-worker"  # the argument that makes this script one rank of phase 11
MESH_WORLD = 2  # processes of phase 11's group
MESH_LOCAL = (2, 4)  # mesh entries a process: global meshes of 4 and 8
MESH_BAD_BLOCK = 100  # a block of rank 1's span at either mesh, corrupted in phase 11


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")

    from lz4_flex_tpu_torch import frame as F
    from lz4_flex_tpu_torch import native
    from lz4_flex_tpu_torch.experiments import fire_probe as FP
    from lz4_flex_tpu_torch.experiments import gather_probe as GP
    from lz4_flex_tpu_torch.experiments.fire_probe import bench_word_soup, kernel_ms
    from lz4_flex_tpu_torch.frame import decompress_frame_device
    from lz4_flex_tpu_torch.frame.header import BlockInfo, BlockInfoKind, BlockMode, BlockSize, FrameInfo
    from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec
    from lz4_flex_tpu_torch.ops import _kernels, packing
    from lz4_flex_tpu_torch.ops import decode as D
    from lz4_flex_tpu_torch.ops import encode as E
    from lz4_flex_tpu_torch.ops import expand2 as X
    from lz4_flex_tpu_torch.ops import parse as P
    from lz4_flex_tpu_torch.ops import ringdecode as R
    from lz4_flex_tpu_torch.ops.decode import decode_block_device
    from lz4_flex_tpu_torch.ops.sequences import parse_sequences_host
    from lz4_flex_tpu_torch.parallel import pipeline as PP
    from lz4_flex_tpu_torch.spec.constants import LZ4F_LEGACY_MAGIC_NUMBER
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
        except Exception as e:  # re-raised below, after all builds end
            errors.append(e)

    cuda_stems = ("ring_decode", "resident_decode", "fire_probe", "gather_probe")
    threads = [threading.Thread(target=build, args=("native", native._build))] + [
        threading.Thread(target=build, args=(stem, lambda stem=stem: _kernels.build(stem)))
        for stem in cuda_stems]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, (path, secs) in built.items():
        print(f"build {name}: {secs:.2f} s -> {path}")
    for stem in cuda_stems:
        with open(built[stem][0] + ".log") as log:
            lines = log.read().splitlines()
        spills = [ln for ln in lines
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))]
        print(f"ptxas {stem}: {sum('Compiling entry' in ln for ln in lines)} kernels, "
              f"{len(spills)} with spills")
        for ln in lines:
            if stem == "ring_decode" and ("Compiling entry" in ln or "registers" in ln or "spill" in ln):
                print("ptxas:", ln.strip())
            elif ln in spills:
                print("ptxas spill:", ln.strip())
    native._lib()
    for stem in cuda_stems:
        _kernels.lib(stem)

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

    launches = {"ring_decode": 0, "ring_decode+checksum": 0, "ring_decode_grouped": 0}

    def main_path(label: str, fn) -> dict:
        for k in R.stats:
            R.stats[k] = 0
        fn()
        torch.cuda.synchronize()
        s = dict(R.stats)
        launches["ring_decode"] += s["kernel_launches"] - s["checksum_launches"] - s["grouped_launches"]
        launches["ring_decode+checksum"] += s["checksum_launches"]
        launches["ring_decode_grouped"] += s["grouped_launches"]
        print(f"  {label:44s} ok, counts {s}", flush=True)
        if (s["kernel_launches"] == 0 or s["overflow_fused_decodes"] or s["overflow_splits"]
                or s["overflow_sharded_decodes"]):
            raise SystemExit(f"chip_smoke: {label} did not run through the kernel: {s}")
        return s

    def same(got: bytes, want: bytes, label: str) -> None:
        if got != want:
            raise SystemExit(f"chip_smoke: {label} output differs from its input")

    def expect(got: bytes, label: str) -> None:
        same(got, data, label)

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

    def cuda_host_ms(fn, iters: int) -> float:
        def run():
            fn()
            torch.cuda.synchronize()
        return host_ms(run, iters)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def in_turns(label: str, ts, tr: int) -> dict:
        """K1 and its first design (the fire probe's ``base``) in turns:
        base, K1, K1, base, each the median of 20 launches."""
        fns = {"base": lambda: FP.fire_probe("base", *ts, tile_rows=tr),
               "K1": lambda: R.ring_decode(*ts, tile_rows=tr)}
        got = {"base": [], "K1": []}
        for name in ("base", "K1", "K1", "base"):
            got[name].append(kernel_ms(fns[name]))
        b, k = statistics.mean(got["base"]), statistics.mean(got["K1"])
        print(f"  in turns, {label} TR={tr}: base {got['base'][0]:.4f}, K1 {got['K1'][0]:.4f}, "
              f"K1 {got['K1'][1]:.4f}, base {got['base'][1]:.4f} ms; K1/base {k / b:.4f} [{card}]",
              flush=True)
        return {"base": b, "K1": k}

    results = {}
    for tr in (R.TILE_ROWS, 512):
        plan_ms = host_ms(lambda: R.build_ring_plan(comp, n, tile_rows=tr), 10)
        plan = R.build_ring_plan(comp, n, tile_rows=tr)
        h2d_ms = cuda_host_ms(lambda: R.ring_plan_device_tensors(plan, "cuda"), 10)
        ts = R.ring_plan_device_tensors(plan, "cuda")
        torch.cuda.synchronize()
        ms_a = kernel_ms(lambda: R.ring_decode(*ts, tile_rows=tr))
        ms_b = kernel_ms(lambda: R.ring_decode(*ts, tile_rows=tr, ntot=n))
        cold_a = kernel_ms(lambda: R.ring_decode(*ts, tile_rows=tr), flush=flush)
        turns = in_turns("bench soup", ts, tr)
        plain_a = cuda_host_ms(lambda: R.ring_decode_reference(*ts, tile_rows=tr), 3)
        plain_b = cuda_host_ms(lambda: R.ring_decode_reference(*ts, tile_rows=tr, ntot=n), 3)
        compare(plan, data, "10 MiB block (main path)", ts=ts)
        bound_a = FP.bound_ms(plan)
        bound_b = (FP.plan_bytes(plan) + 128 * 4) / FP.HBM_BYTES_PER_S * 1e3
        if tr == R.TILE_ROWS:
            ts_main = ts
        results[tr] = dict(ms_a=ms_a, ms_b=ms_b, plain_a=plain_a, plain_b=plain_b,
                           bound_a=bound_a, bound_b=bound_b)
        print(f"  TR={tr} tiles={plan.ntiles} fires={int(plan.nf_tot.sum())} "
              f"NF={plan.rec_f0.shape[1]} bytes_moved={FP.plan_bytes(plan)} [{card}]")
        print(f"  TR={tr} plan_build_ms={plan_ms:.4f} h2d_ms={h2d_ms:.4f} "
              f"kernel_ms={ms_a:.4f} kernel_cold_l2_ms={cold_a:.4f} "
              f"kernel_checksum_ms={ms_b:.4f} checksum/plain={ms_b / ms_a:.4f} "
              f"kernel_MiB/s={n / MIB / (ms_a / 1e3):.1f} bound_ms={bound_a:.5f} "
              f"first_design_ms={turns['base']:.4f} "
              f"plain_ms={plain_a:.2f} plain_checksum_ms={plain_b:.2f} [{card}]", flush=True)
    # bench.py's synthetic vocabulary barely compresses (ratio ~0.97); a
    # small vocabulary gives the kernel a match-heavy plan of the same size.
    rich = bench_word_soup(10 * MIB, vocab=500)
    rcomp = native.compress_block(rich)
    rplan = R.build_ring_plan(rcomp, len(rich))
    rts = R.ring_plan_device_tensors(rplan, "cuda")
    r_ms = kernel_ms(lambda: R.ring_decode(*rts, tile_rows=rplan.tile_rows))
    r_cold = kernel_ms(lambda: R.ring_decode(*rts, tile_rows=rplan.tile_rows), flush=flush)
    r_turns = in_turns("match-heavy soup", rts, rplan.tile_rows)
    if R.ring_decode(*rts, tile_rows=rplan.tile_rows).reshape(-1)[: len(rich)].cpu().numpy().tobytes() != rich:
        raise SystemExit("chip_smoke: the match-heavy soup decoded wrong")
    r_e2e = host_ms(lambda: decode_block_device(rcomp, len(rich)), 10)
    print(f"  match-heavy soup (vocabulary 500, ratio {len(rcomp) / len(rich):.4f}): "
          f"TR={rplan.tile_rows} tiles={rplan.ntiles} fires={int(rplan.nf_tot.sum())} "
          f"kernel_ms={r_ms:.4f} kernel_cold_l2_ms={r_cold:.4f} "
          f"first_design_ms={r_turns['base']:.4f} decode_block_device_ms={r_e2e:.3f} [{card}]",
          flush=True)
    del rts
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

    # ---- 5. probes ------------------------------------------------------------
    print(f"phase 5: fire probe and gather probe (tolerance for exact variants: "
          f"byte-exact) [{card}]", flush=True)
    for counts in (FP.stats, GP.stats):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    fres = FP.run(card, corpora={"bench soup": data, "match-heavy soup": rich})
    gres = GP.run(card)
    probe_launches = {**{f"fire_probe:{k}": v for k, v in FP.stats.items()},
                      **{f"gather_probe:{k}": v for k, v in GP.stats.items()}}
    print(f"  probes took {time.perf_counter() - t0:.1f} s, launches {probe_launches}")
    if not all(probe_launches.values()):
        raise SystemExit("chip_smoke: a probe variant was never launched")

    # ---- 6. streaming decode ----------------------------------------------------
    print(f"phase 6: FrameDecoder(engine='device') on the 10 MiB bench soup "
          f"(tolerance: byte-exact) [{card}]", flush=True)

    def batches(parts, block_size: int, legacy: bool) -> list[int]:
        """The blocks of each batch the device engine cuts a frame body
        into: a batch closes at 32 blocks, past 8 MiB of payload, at 32 MiB
        of projected output (FrameDecoder's budgets), or at the frame's end."""
        D = F.FrameDecoder
        sizes, i = [], 0
        while i < len(parts):
            k = total = projected = 0
            while (i < len(parts) and k < D.DEVICE_BATCH_BLOCKS and total <= D.DEVICE_BATCH_BYTES
                   and projected < D.DEVICE_BATCH_DECODED_BYTES):
                payload, is_comp = parts[i]
                total += len(payload)
                projected += 8 * MIB if legacy else (block_size if is_comp else len(payload))
                k, i = k + 1, i + 1
            sizes.append(k)
        return sizes

    def device_busy(fn, label: str, top: int = 0) -> int:
        """One call of ``fn`` under torch.profiler: the union of the card's
        kernel and copy intervals against the host's wall time of the call
        (the profiler's own host cost inflates the wall, so the share is a
        lower bound), and with ``top`` the kernels that took the most.
        Returns the count of device events (kernels and copies)."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if not spans:
            print(f"  {label}: device busy share not measured (the profiler saw no device "
                  f"event) [{card}]")
            return 0
        busy, end = 0.0, float("-inf")
        for s, e in spans:
            if e > end:
                busy += e - max(s, end)
                end = e
        print(f"  {label}: device busy {busy / 1e3:.3f} ms of {wall:.3f} ms wall under the "
              f"profiler (share {busy / 1e3 / wall:.3f}, {len(spans)} device events) [{card}]")
        kern = sorted((a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda a: -a.self_device_time_total)
        for a in kern[:top]:
            print(f"    {a.self_device_time_total / 1e3:9.3f} ms  x{a.count:<5d} {a.key[:90]}")
        return len(spans)

    def device_event_names(fn, calls: int) -> dict:
        """``calls`` calls of ``fn`` under one torch.profiler window, the card
        synchronised after each: the device events (kernels and copies) the
        profiler saw, counted by name."""
        from collections import Counter

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
        return Counter(e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)

    legacy_f, legacy_parts = bytearray(struct.pack("<I", LZ4F_LEGACY_MAGIC_NUMBER)), []
    for i in range(0, n, 8 * MIB):
        c = native.compress_block(data[i : i + 8 * MIB])
        legacy_parts.append((c, True))
        legacy_f += struct.pack("<I", len(c)) + c
    legacy_f = bytes(legacy_f)
    (f64, parts64), (f4m, parts4m) = (v[0] for v in frames.values())
    b64 = batches(parts64, 64 * 1024, False)
    bleg = batches(legacy_parts, 8 * MIB, True)
    nb64, nbleg = len(b64), len(bleg)
    # The first batch's plan of each independent frame, as the decoder
    # builds it (the 4 MiB linked frame is one batch: phase 3's plan).
    for label, first in (("first batch, 64 KiB frame", parts64[: b64[0]]),
                         ("first batch, legacy frame", legacy_parts[: bleg[0]])):
        total = sum(R.part_sizes(first))
        plan, _ = R.build_ring_plan_parts(first, total, independent=True)
        compare(plan, data[:total], f"{label} ({len(first)} blocks)")
    streams = {
        "64 KiB independent, block checksums": (f64, nb64, data),
        "4 MiB linked, content checksum": (f4m, len(batches(parts4m, 4 * MIB, False)), data),
        "legacy, 8 MiB blocks": (legacy_f, nbleg, data),
        "64 KiB frame + legacy frame": (f64 + legacy_f, nb64 + nbleg, data + data),
    }
    for label, (f, nb, want) in streams.items():
        def stream_dec(f=f, engine="device"):
            return F.FrameDecoder(io.BytesIO(f), engine=engine).read_all()

        s = main_path(f"FrameDecoder device ({label})",
                      lambda: same(stream_dec(), want, label))
        if s["kernel_launches"] != nb:
            raise SystemExit(f"chip_smoke: {label}: {s['kernel_launches']} launches "
                             f"for {nb} batches")
        same(stream_dec(engine="host"), want, label)
        dev_ms = host_ms(stream_dec, 5)
        one_ms = host_ms(lambda: decompress_frame_device(f), 5)
        hst_ms = host_ms(lambda: stream_dec(engine="host"), 5)
        mib = len(want) / MIB
        print(f"  {label}: {nb} batches; FrameDecoder device {dev_ms:.3f} ms = "
              f"{mib / (dev_ms / 1e3):.1f} MiB/s, decompress_frame_device {one_ms:.3f} ms = "
              f"{mib / (one_ms / 1e3):.1f} MiB/s, FrameDecoder host {hst_ms:.3f} ms = "
              f"{mib / (hst_ms / 1e3):.1f} MiB/s [{card}]", flush=True)
        if nb > 1:
            device_busy(stream_dec, f"FrameDecoder device ({label})")
            device_busy(lambda: decompress_frame_device(f), f"decompress_frame_device ({label})")

    # ---- 7. encode and round trip -----------------------------------------------
    print(f"phase 7: hybrid encode (candidate planes: torch ops; tolerance: bit-exact "
          f"against the same ops on the CPU) [{card}]", flush=True)

    def plane_err(a, b) -> int:
        return int(((a.cpu().int() & 0xFFFF) - (b.int() & 0xFFFF)).abs().max())

    plane_max_err = 0
    for label, blk in blocks.items():
        g = packing.pad_to(np.frombuffer(blk, np.uint8).copy(), packing.size_bucket(len(blk) + 4))
        on_card, on_cpu = torch.from_numpy(g).cuda(), torch.from_numpy(g)
        errs = [int((a.cpu().long() - b.long()).abs().max())
                for a, b in zip(E.candidates_core(on_card), E.candidates_core(on_cpu))]
        errs.append(plane_err(E.best_plane_core(on_card, 4), E.best_plane_core(on_cpu, 4)))
        plane_max_err = max(plane_max_err, *errs)
        print(f"  {label:24s} {len(g)} positions: d12/d34/plane max_abs_err {errs}")
    G = np.frombuffer(data, np.uint8)
    bucket, starts, limits, groups = E._stream_rows(n, 0, n)
    ghost = packing.pad_to(G.copy(), bucket)
    gpad = torch.from_numpy(ghost).cuda()
    quad = E._best_plane_quad(gpad, groups[0])
    e = plane_err(quad, E._best_plane_quad(torch.from_numpy(ghost), groups[0]))
    plane_max_err = max(plane_max_err, e)
    print(f"  first quad of the 10 MiB soup ({len(starts)} chunk rows, {len(groups)} quads): "
          f"max_abs_err {e}")
    if plane_max_err:
        raise SystemExit("chip_smoke: the candidate planes on the card differ from the CPU's")

    def encode_path(label: str, fn, quads: int | None = None):
        for k in E.stats:
            E.stats[k] = 0
        out = fn()
        torch.cuda.synchronize()
        s = dict(E.stats)
        print(f"  {label:44s} counts {s}", flush=True)
        if s["plane_quads"] == 0 or (quads is not None and s["plane_quads"] != quads):
            raise SystemExit(f"chip_smoke: {label} did not compute its planes on the card: {s}")
        return out, s

    plane_launches = 0
    hybrid = {}
    for label, src in (("bench soup", data), ("match-heavy soup", rich)):
        comp_h, s = encode_path(f"compress_block_hybrid ({label})",
                                lambda: E.compress_block_hybrid(src), len(groups))
        plane_launches += s["plane_quads"]
        same(native.decompress_block(comp_h, len(src)), src, f"hybrid wire ({label})")
        main_path(f"decode_block_device of the hybrid wire ({label})",
                  lambda: same(decode_block_device(comp_h, len(src)), src, label))
        hybrid[label] = comp_h
    cfg4 = CodecConfig(block_size=BlockSize.Max4MB, block_mode=BlockMode.Linked,
                       content_checksum=True)
    f_codec, s = encode_path("LZ4Codec.compress (4 MiB linked)", lambda: LZ4Codec(cfg4).compress(data))
    plane_launches += s["plane_quads"]
    main_path("LZ4Codec.decompress of it", lambda: expect(LZ4Codec(cfg4).decompress(f_codec), "codec"))
    main_path("FrameDecoder device of it",
              lambda: expect(F.FrameDecoder(io.BytesIO(f_codec), engine="device").read_all(), "codec"))

    def stream_enc():
        buf = io.BytesIO()
        with F.FrameEncoder(buf, FrameInfo(block_size=BlockSize.Max1MB), engine="device") as enc:
            for i in range(0, n, 3 * MIB + 12345):
                enc.write(data[i : i + 3 * MIB + 12345])
        return buf.getvalue()

    f_enc, s = encode_path("FrameEncoder device (1 MiB independent)", stream_enc)
    plane_launches += s["plane_quads"]
    main_path("FrameDecoder device of it",
              lambda: expect(F.FrameDecoder(io.BytesIO(f_enc), engine="device").read_all(), "enc"))
    expect(F.decompress(f_enc), "FrameEncoder device, host read")

    # stage times of the streaming encode on the 10 MiB bench soup
    plane_ms = kernel_ms(lambda: E._best_plane_quad(gpad, groups[0]), iters=10)
    rows = torch.stack([gpad[s : s + E._CHUNK_W] for s in groups[0]])
    w4 = E._u32_bits(E._words(rows))
    sort_ms = kernel_ms(lambda: torch.sort(w4, dim=-1, stable=True), iters=10)
    pinned = torch.empty(quad.shape, dtype=quad.dtype, pin_memory=True)
    d2h_ms = cuda_host_ms(lambda: pinned.copy_(quad), 10)
    up_ms = cuda_host_ms(lambda: torch.from_numpy(ghost).cuda(), 10)
    planes = [E._best_plane_quad(gpad, g).cpu().numpy().view(np.uint16) for g in groups]
    walk_times, stitch_times = [], []
    for _ in range(5):
        walks = E._ChunkWalks(G, 0, n, starts, limits)
        t0 = time.perf_counter()
        for q, p in enumerate(planes):
            walks.submit(q * E._PLANE_ROWS, p)
        walks.wait()
        t1 = time.perf_counter()
        staged = walks.stitch()
        walk_times.append((t1 - t0) * 1e3)
        stitch_times.append((time.perf_counter() - t1) * 1e3)
    same(staged, hybrid["bench soup"], "staged streaming encode")
    plane_bound = len(groups[0]) * (E._CHUNK_W + 2 * E._CHUNK_W // E._PLANE_POOL) / FP.HBM_BYTES_PER_S * 1e3
    print(f"  device program best_plane quad ({len(groups[0])} rows of {E._CHUNK_W} B): "
          f"{plane_ms:.4f} ms (CUDA events, median of 10), of it the sort {sort_ms:.4f} ms "
          f"({sort_ms / plane_ms:.3f}); bytes bound {plane_bound:.5f} ms; launches on the "
          f"main path {plane_launches}; max_abs_err {plane_max_err} [{card}]")
    print(f"  streaming stages: upload {up_ms:.3f} ms, plane d2h {d2h_ms:.3f} ms a quad, "
          f"walks {statistics.median(walk_times):.3f} ms ({len(starts)} chunks, "
          f"{os.cpu_count()} host cores), stitch "
          f"{statistics.median(stitch_times):.3f} ms [{card}]", flush=True)
    for label, src in (("bench soup", data), ("match-heavy soup", rich)):
        hyb_ms = host_ms(lambda: E.compress_block_hybrid(src), 5)
        nat = native.compress_block(src)
        nat_ms = host_ms(lambda: native.compress_block(src), 5)
        m = len(src) / MIB
        print(f"  {label}: compress_block_hybrid {hyb_ms:.3f} ms = {m / (hyb_ms / 1e3):.1f} MiB/s, "
              f"ratio {len(hybrid[label]) / len(src):.4f}; native.compress_block {nat_ms:.3f} ms = "
              f"{m / (nat_ms / 1e3):.1f} MiB/s, ratio {len(nat) / len(src):.4f} [{card}]",
              flush=True)
        device_busy(lambda: E.compress_block_hybrid(src), f"compress_block_hybrid ({label})",
                    top=6 if src is data else 0)
    codec_ms = host_ms(lambda: LZ4Codec(cfg4).compress(data), 3)
    print(f"  LZ4Codec.compress (4 MiB linked) {codec_ms:.3f} ms = "
          f"{n / MIB / (codec_ms / 1e3):.1f} MiB/s, ratio {len(f_codec) / n:.4f} [{card}]")

    # ---- 8. fallback decode engines ------------------------------------------------
    print(f"phase 8: fallback decode engines (torch ops; tolerance: bit-exact against the same "
          f"functions on the CPU, byte-exact against the data) [{card}]", flush=True)
    t_phase8 = time.perf_counter()

    def engine_inputs(c: bytes):
        """One block's inputs to the engines, padded as the entry points
        pad them: (table, out_pad, nseq_pad, words, tables, payload padded
        for the parse)."""
        cu8 = np.frombuffer(c, np.uint8)
        seq = parse_sequences_host(cu8)
        out_pad = packing.size_bucket(max(seq.total_out, 4))
        nseq_pad = packing.size_bucket(max(seq.nseq, 4), minimum=256)
        tables = [packing.pad_to(seq.out_off, nseq_pad, fill=out_pad),
                  packing.pad_to(seq.lit_start, nseq_pad), packing.pad_to(seq.lit_len, nseq_pad),
                  packing.pad_to(seq.match_off, nseq_pad, fill=1)]
        words = D._pack_host(cu8, packing.size_bucket(max(len(c), 4)))
        return seq, out_pad, nseq_pad, words, tables, packing.pad_to(cu8, packing.size_bucket(len(c) + 1))

    def on_both(fn, arrays, *args, **kw):
        """``fn`` on the card and on the CPU over the same numpy inputs."""
        got = fn(*(torch.from_numpy(a.copy()).cuda() for a in arrays), *args, **kw)
        want = fn(*(torch.from_numpy(a.copy()) for a in arrays), *args, **kw)
        return got, want

    def err(got, want) -> int:
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        return max(int((g.cpu().long() - w.long()).abs().max()) if w.numel() else 0
                   for g, w in pairs)

    no_dict = np.zeros(1, np.int32)
    eng_err = 0
    for label, blk in [*blocks.items(), ("10 MiB soup, first MiB", data[:MIB])]:
        c = native.compress_block(blk)
        seq, out_pad, nseq_pad, words, tables, u8 = engine_inputs(c)
        total = seq.total_out
        kw = dict(out_pad=out_pad, has_dict=False)
        v1 = on_both(D.expand_core, [words, no_dict, *tables], 0, total, **kw)
        v2 = on_both(X.expand2_core, [words, no_dict, *tables], 0, total, **kw)
        smap = on_both(X.build_source_map, tables, 0, total, out_pad=out_pad,
                       comp_pad=words.shape[0] * 4, dict_bytes=0)
        res = on_both(X.resolve_cells, [smap[1].numpy()], out_pad=out_pad)
        guarded = np.concatenate([np.zeros(4, np.int32), words, np.zeros(12, np.int32)])
        mat = on_both(X.materialize_cells, [res[1].numpy(), guarded], out_pad=out_pad, guard_words=4)
        prs = on_both(P.parse_core, [u8], len(c),
                      nseq_pad=packing.size_bucket(len(u8) // 3 + 2, minimum=256))
        errs = [err(*x) for x in (v1, v2, smap, res, mat, prs)]
        eng_err = max(eng_err, *errs)
        exact = all(x[0][:total].cpu().numpy().tobytes() == blk for x in (v1, v2, mat))
        print(f"  {label:28s} {total} bytes, {seq.nseq} sequences: max_abs_err v1/v2/map/resolve/"
              f"materialize/parse {errs}, bytes {'exact' if exact else 'WRONG'}", flush=True)
        if not exact:
            raise SystemExit(f"chip_smoke: an expansion engine decoded {label} wrong")
    for label, parts, want in (("linked multi-block body", linked_parts, linked_data),
                               ("dict-prefixed body",
                                [(dic, False), (native.compress_block(dict_data, dic), True)],
                                dic + dict_data)):
        got = D.decode_parts_fused(parts, device="cuda", as_array=True)
        ref = D.decode_parts_fused(parts, device="cpu", as_array=True)
        e = err(got, ref)
        eng_err = max(eng_err, e)
        same(got.cpu().numpy().tobytes(), want, label)
        print(f"  decode_parts_fused, {label}: max_abs_err {e}, bytes exact", flush=True)
    if eng_err:
        raise SystemExit("chip_smoke: a fallback engine on the card differs from its CPU run")

    def fused_path(label: str, fn, want: bytes) -> float:
        """One byte-exact run of a fallback path with the counters set to 0
        (it must not launch K1), then its end-to-end time, median of 3."""
        for k in R.stats:
            R.stats[k] = 0
        got = fn()
        torch.cuda.synchronize()
        s = dict(R.stats)
        same(got if isinstance(got, bytes) else got.cpu().numpy().tobytes(), want, label)
        if s["kernel_launches"]:
            raise SystemExit(f"chip_smoke: {label} launched the ring kernel: {s}")
        ms = host_ms(lambda: (fn(), torch.cuda.synchronize()), 3)
        print(f"  {label:52s} {ms:.3f} ms = {len(want) / MIB / (ms / 1e3):.1f} MiB/s [{card}]",
              flush=True)
        return ms

    fallback_ms = {}
    for engine in ("v1", "v2"):
        fallback_ms[f"parse=host {engine}"] = fused_path(
            f"decode_block_device(parse='host', engine='{engine}')",
            lambda: decode_block_device(comp, n, parse="host", engine=engine), data)
    fallback_ms["parse=device v2"] = fused_path(
        "decode_block_device(parse='device') (doubling, v2)",
        lambda: decode_block_device(comp, n, parse="device"), data)
    for label, ((f, parts), linked, cfg) in frames.items():
        fused_path(f"decode_parts_fused ({label.split(',')[0]})",
                   lambda: D.decode_parts_fused(parts, independent=not linked,
                                                max_block_size=cfg.block_size.get_size()), data)
    step_blocks = [data[i : i + 65536] for i in range(0, 32 * 65536, 65536)]
    step_parts = [native.compress_block(b) for b in step_blocks]
    width = packing.size_bucket(max(len(p) for p in step_parts) + 1)
    rows = np.zeros((len(step_parts), width), np.uint8)
    for i, p in enumerate(step_parts):
        rows[i, : len(p)] = np.frombuffer(p, np.uint8)
    cfg64 = CodecConfig(block_size=BlockSize.Max64KB)

    def decode_step():
        out, total, flags = LZ4Codec(cfg64).decode_step(rows, [len(p) for p in step_parts])
        if bool(flags.any()) or total.tolist() != [len(b) for b in step_blocks]:
            raise SystemExit(f"chip_smoke: decode_step on valid blocks: lengths {total.tolist()}, "
                             f"flags {flags.nonzero().tolist()}")
        return b"".join(out[i, : len(b)].cpu().numpy().tobytes() for i, b in enumerate(step_blocks))

    fused_path(f"LZ4Codec.decode_step ({len(step_parts)} blocks of 64 KiB)", decode_step,
               b"".join(step_blocks))

    # The batched programs (the JAX package's vmap over rows): the first 64 KiB of
    # each of phase 2's blocks and of the 10 MiB soup as payload rows, with one
    # malformed row (offset zero) among them; on the card against the CPU, and
    # each row of the batched resident decode against the same row decoded alone.
    brows_raw = [b[:65536] for b in blocks.values()] + [data[:65536]]
    bpay = [native.compress_block(b) for b in brows_raw]
    bad_row = 3
    bpay.insert(bad_row, bytes([0x12, 0x41, 0x00, 0x00]))
    brows_raw.insert(bad_row, None)
    bwidth = packing.size_bucket(max(len(p) for p in bpay) + 1)
    bu8 = np.zeros((len(bpay), bwidth), np.uint8)
    for i, p in enumerate(bpay):
        bu8[i, : len(p)] = np.frombuffer(p, np.uint8)
    blen = np.array([len(p) for p in bpay], np.int32)
    bnseq = packing.size_bucket(bwidth // 3 + 2, minimum=256)
    prs_b = on_both(P.parse_rows, [bu8, blen], nseq_pad=bnseq)
    ls_b, ll_b, mo_b, _, oo_b, nseq_b, total_b, _ = prs_b[1]
    real_b = torch.arange(bnseq) < nseq_b[:, None]
    btables = [torch.where(real_b, oo_b, 65536).numpy(), ls_b.numpy(), ll_b.numpy(),
               torch.where(real_b, mo_b, 1).numpy()]
    bwords = packing.bytes_to_words(torch.from_numpy(bu8)).numpy()
    bexp = [bwords, np.zeros((len(bpay), 1), np.int32), *btables, total_b.numpy()]
    v1_b = on_both(lambda *t: D.expand_core(*t[:6], 0, t[6], out_pad=65536, has_dict=False), bexp)
    v2_b = on_both(lambda *t: X.expand2_core(*t[:6], 0, t[6], out_pad=65536, has_dict=False), bexp)
    res_b = on_both(D.decode_resident_rows, [bu8, blen], out_pad=65536, nseq_pad=bnseq)
    batch_err = max(err(*x) for x in (prs_b, v1_b, v2_b, res_b))
    bu8_d = torch.from_numpy(bu8).cuda()
    alone = [D.decode_resident_core(bu8_d[i], int(blen[i]), out_pad=65536, nseq_pad=bnseq)
             for i in range(len(bpay))]
    alone_err = max(err(tuple(t[i] for t in res_b[0]), tuple(t.cpu() for t in a))
                    for i, a in enumerate(alone))
    out_b, tot_b, flags_b = (t.cpu() for t in res_b[0])
    batch_ok = flags_b[bad_row].tolist() == [False, False, True, False, False] and all(
        out_b[i, : int(tot_b[i])].numpy().tobytes() == raw and not bool(flags_b[i].any())
        for i, raw in enumerate(brows_raw) if raw is not None)
    print(f"  batched programs, {len(bpay)} rows of 64 KiB blocks (row {bad_row} offset zero): "
          f"max_abs_err card against CPU parse_rows/expand_core/expand2_core/decode_resident_rows "
          f"{batch_err}, each row against it decoded alone {alone_err}, bytes and flags "
          f"{'exact' if batch_ok else 'WRONG'} [{card}]", flush=True)
    if batch_err or alone_err or not batch_ok:
        raise SystemExit("chip_smoke: a batched program differs on the card")

    # decode_step on device tensors at B = 1, 8, 32 and 160 (all of the 10 MiB soup)
    all_blocks = [data[i : i + 65536] for i in range(0, n, 65536)]
    all_parts = [native.compress_block(b) for b in all_blocks]
    awidth = packing.size_bucket(max(len(p) for p in all_parts) + 1)
    arows = np.zeros((len(all_parts), awidth), np.uint8)
    for i, p in enumerate(all_parts):
        arows[i, : len(p)] = np.frombuffer(p, np.uint8)
    alens = np.array([len(p) for p in all_parts], np.int32)
    arows_d, alens_d = torch.from_numpy(arows).cuda(), torch.from_numpy(alens).cuda()
    codec64 = LZ4Codec(cfg64)
    step_launches = {}
    for b in (1, 8, 32, len(all_parts)):
        r, lens_b = arows_d[:b], alens_d[:b]
        launched = R.stats["resident_launches"]
        out, total, flags = codec64.decode_step(r, lens_b)
        step_launches[b] = R.stats["resident_launches"] - launched
        if (bool(flags.any()) or total.tolist() != [len(x) for x in all_blocks[:b]]
                or out[:, :65536].cpu().numpy().tobytes() != b"".join(all_blocks[:b])):
            raise SystemExit(f"chip_smoke: decode_step at B={b} decoded wrong")
        ms = host_ms(lambda: (codec64.decode_step(r, lens_b), torch.cuda.synchronize()), 3)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        codec64.decode_step(r, lens_b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # a kernel launched from a native library may be missing from a
        # one-call profile: the launch count comes from the counter
        events = device_busy(lambda: codec64.decode_step(r, lens_b), f"decode_step B={b} (profiled)")
        # payloads in; bytes, lengths and flags out
        moved = int(alens[:b].sum()) + b * 65536 + b * (4 + 5)
        bound = moved / FP.HBM_BYTES_PER_S * 1e3
        print(f"  LZ4Codec.decode_step B={b:3d} x 64 KiB (device tensors in and out): {ms:.3f} ms "
              f"= {b * 65536 / MIB / (ms / 1e3):.1f} MiB/s, {step_launches[b]} resident kernel "
              f"launch, {events} device events seen by the profiler, peak "
              f"device memory {peak / MIB:.1f} MiB ({(peak - before) / MIB:.1f} above what was "
              f"held before the call), bytes bound {bound:.5f} ms; dispatch cap "
              f"{PP._DECODE_POSITIONS} positions [{card}]",
              flush=True)
    print(f"  decode_step on all {len(all_parts)} blocks beside the 10 MiB soup as one block: "
          f"decode_block_device (ring) {e2e_ms:.3f} ms, native host decoder {host_dec_ms:.3f} ms "
          f"(phase 4); resident kernel launches a call {step_launches} [{card}]", flush=True)
    if set(step_launches.values()) != {1}:
        raise SystemExit(f"chip_smoke: decode_step is not one kernel launch a call: {step_launches}")
    # the same from the card's side, over many calls: a one-call window may
    # miss the kernel launched from its library
    calls = 20
    seen = device_event_names(lambda: codec64.decode_step(arows_d[:32], alens_d[:32]), calls)
    resident_events = sum(v for k, v in seen.items() if "resident_decode_kernel" in k)
    other_events = sum(seen.values()) - resident_events
    print(f"  decode_step B=32, {calls} calls under one profiler window: {resident_events} resident "
          f"kernel events, {other_events} other device events {dict(seen)} [{card}]", flush=True)
    if other_events or not calls // 2 <= resident_events <= calls:
        raise SystemExit(f"chip_smoke: decode_step is not about one device kernel a call: "
                         f"{dict(seen)} over {calls} calls")

    # the resident kernel alone at the batch cell's shape, against its plain
    # version on the same tensors
    from tests.torch_inputs import block_rows

    zrows, zlens, _ = block_rows(256, seed=14)
    zu8, zn = torch.from_numpy(zrows).cuda(), torch.from_numpy(zlens).cuda()
    rkw = dict(out_pad=65536, nseq_pad=24576)
    resident = {}
    for b in (16, 87, 256):
        u8b, nb = zu8[:b], zn[:b]
        launched = R.stats["resident_launches"]
        got = D.decode_resident_rows(u8b, nb, **rkw)
        want = D.decode_resident_rows_reference(u8b, nb, **rkw)
        e = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))
        ms = kernel_ms(lambda: D.decode_resident_rows(u8b, nb, **rkw))
        plain = kernel_ms(lambda: D.decode_resident_rows_reference(u8b, nb, **rkw), iters=5,
                          warmup=1)
        # payloads read once; bytes, lengths and flags written once
        bound = (int(zlens[:b].sum()) + b * (65536 + 4 + 5)) / FP.HBM_BYTES_PER_S * 1e3
        resident[b] = {"launches": R.stats["resident_launches"] - launched, "max_abs_err": e,
                       "ms": ms, "plain_ms": plain, "bound_ms": bound}
        print(f"  resident kernel B={b:3d} x 64 KiB Zipf word soup: {ms:.3f} ms "
              f"({b * 65536 / MIB / (ms / 1e3):.1f} MiB/s), plain version {plain:.3f} ms, bytes "
              f"bound {bound:.5f} ms, max_abs_err {e}, {resident[b]['launches']} launches "
              f"[{card}]", flush=True)
        if e:
            raise SystemExit(f"chip_smoke: the resident kernel differs from its plain version at B={b}")

    # stage times of the v2 engine and the doubling parse on the 10 MiB soup
    seq, out_pad, nseq_pad, words, tables, u8 = engine_inputs(comp)
    cw, tb, cu = (torch.from_numpy(words).cuda(), [torch.from_numpy(t).cuda() for t in tables],
                  torch.from_numpy(u8).cuda())
    smap = X.build_source_map(*tb, 0, n, out_pad=out_pad, comp_pad=cw.shape[0] * 4, dict_bytes=0)
    res = X.resolve_cells(smap, out_pad=out_pad)
    wg = torch.cat([cw.new_zeros(4), cw, cw.new_zeros(12)])
    pad = u8.shape[0]
    parse_pad = packing.size_bucket(pad // 3 + 2, minimum=256)
    stage = {
        "map build": kernel_ms(lambda: X.build_source_map(
            *tb, 0, n, out_pad=out_pad, comp_pad=cw.shape[0] * 4, dict_bytes=0), iters=5, warmup=1),
        "resolution": kernel_ms(lambda: X.resolve_cells(smap, out_pad=out_pad), iters=5, warmup=1),
        "materialization": kernel_ms(lambda: X.materialize_cells(res, wg, out_pad=out_pad,
                                                                 guard_words=4), iters=5, warmup=1),
        "expand2_core": kernel_ms(lambda: X.expand2_core(cw, cw[:1], *tb, 0, n, out_pad=out_pad,
                                                         has_dict=False), iters=5, warmup=1),
        "expand_core (v1)": kernel_ms(lambda: D.expand_core(cw, cw[:1], *tb, 0, n, out_pad=out_pad,
                                                            has_dict=False), iters=5, warmup=1),
        "parse_core": kernel_ms(lambda: P.parse_core(cu, len(comp), nseq_pad=parse_pad),
                                iters=5, warmup=1),
        "decode_resident_core (doubling, v2; the resident kernel)": kernel_ms(
            lambda: D.decode_resident_core(cu, len(comp), out_pad=out_pad, nseq_pad=parse_pad),
            iters=5, warmup=1),
        "decode_resident_rows_reference (its torch ops)": kernel_ms(
            lambda: D.decode_resident_rows_reference(cu[None], len(comp), out_pad=out_pad,
                                                     nseq_pad=parse_pad), iters=5, warmup=1),
    }
    table_bytes = 4 * 4 * seq.nseq  # out_off, lit_start, lit_len, match_off
    bound = {  # each input read once, each output written once, over the HBM rate
        "expand": (len(comp) + table_bytes + n) / FP.HBM_BYTES_PER_S * 1e3,
        "parse": (len(comp) + 5 * 4 * seq.nseq) / FP.HBM_BYTES_PER_S * 1e3,
        "resident": (len(comp) + n) / FP.HBM_BYTES_PER_S * 1e3,
    }
    print(f"  stage times on the 10 MiB soup ({seq.nseq} sequences; CUDA events around each call, "
          f"its host reads of device scalars included, median of 5): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stage.items()) + f" [{card}]")
    device_busy(lambda: X.expand2_core(cw, cw[:1], *tb, 0, n, out_pad=out_pad, has_dict=False),
                "expand2_core (10 MiB soup)", top=6)
    device_busy(lambda: P.parse_core(cu, len(comp), nseq_pad=parse_pad), "parse_core (10 MiB soup)",
                top=6)
    print(f"  bytes bounds: expansion {bound['expand']:.5f} ms, parse {bound['parse']:.5f} ms, "
          f"resident decode {bound['resident']:.5f} ms; beside the ring engine's "
          f"decode_block_device {e2e_ms:.3f} ms and the native host decoder {host_dec_ms:.3f} ms "
          f"(phase 4) [{card}]", flush=True)

    # the walk and strided parses on one 64 KiB block
    blk = parts64[0][0]
    wu8 = packing.pad_to(np.frombuffer(blk, np.uint8), packing.size_bucket(len(blk) + 1))
    wpad = packing.size_bucket(wu8.shape[0] // 3 + 2, minimum=256)
    walk = on_both(P.parse_walk_core, [wu8], len(blk), nseq_pad=wpad)
    dbl = P.parse_core(torch.from_numpy(wu8).cuda(), len(blk), nseq_pad=wpad)
    stride = [on_both(P.parse_strided_core, [wu8], len(blk), lanes=k) for k in (4, 8)]
    walk_err = max(err(*walk), err(walk[0], tuple(t.cpu() for t in dbl)), *(err(*x) for x in stride))
    wcu = torch.from_numpy(wu8).cuda()
    walk_ms = kernel_ms(lambda: P.parse_walk_core(wcu, len(blk), nseq_pad=wpad), iters=3, warmup=1)
    dbl_ms = kernel_ms(lambda: P.parse_core(wcu, len(blk), nseq_pad=wpad), iters=3, warmup=1)
    str_ms = kernel_ms(lambda: P.parse_strided_core(wcu, len(blk), lanes=8), iters=3, warmup=1)
    wbound = (len(blk) + 5 * 4 * int(walk[1][5])) / FP.HBM_BYTES_PER_S * 1e3
    print(f"  64 KiB block ({int(walk[1][5])} sequences): parse_walk_core {walk_ms:.3f} ms, "
          f"parse_strided_core (8 lanes) {str_ms:.3f} ms, parse_core {dbl_ms:.3f} ms, bytes bound "
          f"{wbound:.6f} ms; walk and strided against their CPU run and the walk against the "
          f"doubling parse: max_abs_err {walk_err} [{card}]", flush=True)
    if walk_err:
        raise SystemExit("chip_smoke: the walk or strided parse differs")

    # forced overflow: every ring plan overflows; each decode must take one
    # fused decode on the card, and the host decoder refuses every call
    def refuse(*a, **kw):
        raise SystemExit("chip_smoke: a device path decoded on the host")

    def compress_with_dict(raw: bytes, dictionary: bytes) -> bytes:
        table = native.new_table()
        native.compress_block(dictionary, table=table)
        return native.compress_block(dictionary + raw, input_pos=len(dictionary),
                                     input_stream_offset=0, table=table)

    saved = (R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0], native.decompress_block)
    dict1, d1 = data[:65536], data[65536 : 65536 + MIB]
    dcomp1 = compress_with_dict(d1, dict1)
    c1 = native.compress_block(d1)
    f1 = F.compress(d1, FrameInfo(block_size=BlockSize.Max64KB))
    fone = F.compress(d1[:65536], FrameInfo(block_size=BlockSize.Max64KB))
    R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0], native.decompress_block = (1,), 1, 1, refuse
    try:
        for label, fn, want in (
            ("decode_block_device", lambda: decode_block_device(c1, len(d1)), d1),
            ("decode_block_device with a dictionary",
             lambda: decode_block_device(dcomp1, len(d1), dict1), d1),
            ("decompress_frame_device (64 KiB blocks)", lambda: decompress_frame_device(f1), d1),
            ("FrameDecoder device, one-block batch",
             lambda: F.FrameDecoder(io.BytesIO(fone), engine="device").read_all(), d1[:65536]),
        ):
            for k in R.stats:
                R.stats[k] = 0
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            s = dict(R.stats)
            same(got, want, f"forced overflow, {label}")
            print(f"  forced overflow, {label:40s} byte-exact, {ms:.3f} ms, counts {s} [{card}]",
                  flush=True)
            if s["overflow_fused_decodes"] != 1 or s["kernel_launches"]:
                raise SystemExit(f"chip_smoke: forced overflow, {label}: {s}")
    finally:
        R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0], native.decompress_block = saved
    print(f"  phase 8 took {time.perf_counter() - t_phase8:.1f} s", flush=True)

    # ---- 9. all-device encode --------------------------------------------------------
    print(f"phase 9: all-device encode (the encode kernel and torch ops; tolerance: bit-exact against the same "
          f"functions on the CPU, byte-exact against the data) [{card}]", flush=True)
    t_phase9 = time.perf_counter()

    programs = ("match_core", "emit_core", "encode_chunk_core", "_match_quad", "_merge_emit")
    prog_calls = dict.fromkeys(programs, 0)  # calls on the main paths below

    def recorded(fn, keep: bool = True):
        """``fn()`` with the device programs of ops.encode wrapped: every
        call is counted in ``prog_calls``, and with ``keep`` the first call
        of each program is recorded as (args, kwargs, result)."""
        saved = {k: getattr(E, k) for k in programs}
        first = {}

        def wrap(name, f):
            def inner(*a, **kw):
                r = f(*a, **kw)
                prog_calls[name] += 1
                if keep and name not in first:
                    first[name] = (a, kw, r)
                return r
            return inner

        for k, f in saved.items():
            setattr(E, k, wrap(k, f))
        try:
            return fn(), first
        finally:
            for k, f in saved.items():
                setattr(E, k, f)

    def to_cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, (tuple, list)):
            return type(x)(to_cpu(v) for v in x)
        return x

    def tensors(x):
        return [x] if isinstance(x, torch.Tensor) else [t for v in x for t in tensors(v)] \
            if isinstance(x, (tuple, list)) else []

    prog_err = dict.fromkeys(programs, 0)

    def replay(first: dict, label: str) -> None:
        """Each recorded call again on the CPU, on the same arguments."""
        errs = {}
        for name, (a, kw, r) in first.items():
            want = getattr(E, name)(*to_cpu(a), **{k: to_cpu(v) for k, v in kw.items()})
            errs[name] = max((int((g.cpu().long() - w.long()).abs().max()) if w.numel() else 0)
                             for g, w in zip(tensors(r), tensors(want)))
            prog_err[name] = max(prog_err[name], errs[name])
        print(f"  {label:40s} max_abs_err {errs}", flush=True)
        if any(errs.values()):
            raise SystemExit(f"chip_smoke: a device program differs from its CPU run on {label}")

    for k in E.stats:
        E.stats[k] = 0
    for label, blk in blocks.items():
        part = blk[: 256 * 1024]
        one, first = recorded(lambda: E.compress_block_device(part))
        (payloads, lens, _), first2 = recorded(lambda: PP.encode_blocks(part, 65536))
        same(native.decompress_block(one, len(part)), part, label)
        same(b"".join(native.decompress_block(p, m) for p, m in zip(payloads, lens)), part, label)
        # the single chunk's match and emission, and the frame blocks' dispatch
        replay({**first2, **first}, f"{label}, first 256 KiB")
    if E.stats["verify_fallbacks"] or E.stats["plane_quads"]:
        raise SystemExit(f"chip_smoke: the parity encodes fell back or planed: {E.stats}")
    prog_calls.update(dict.fromkeys(programs, 0))  # count the main paths only

    def encode_path(label: str, fn, decode=None, want: bytes = data, keep: bool = False):
        """One main-path encode with the encode counters set to 0 just
        before it: the device programs must have run, no candidate plane
        and no fallback to the host encoder. Returns its output, the
        recorded first calls, and the counts."""
        for k in E.stats:
            E.stats[k] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, first = recorded(fn, keep)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        st = dict(E.stats)
        peak = torch.cuda.max_memory_allocated() / MIB
        print(f"  {label:52s} first call {ms:.1f} ms, peak {peak:.1f} MiB, counts {st} [{card}]",
              flush=True)
        if (st["match_calls"] == 0 or st["emit_calls"] == 0 or st["plane_quads"]
                or st["candidate_calls"] or st["verify_fallbacks"]):
            raise SystemExit(f"chip_smoke: {label} did not encode on the card as it must: {st}")
        if decode is not None:
            same(decode(out), want, f"{label}, native decode")
        return out, first, st

    def frame_of(cfg):
        return LZ4Codec(cfg).compress(data)

    def check_frame(label: str, f: bytes) -> None:
        same(F.decompress(f), data, f"{label}, host read")
        main_path(f"decompress_frame_device of {label}", lambda: expect(decompress_frame_device(f), label))
        main_path(f"FrameDecoder device of {label}",
                  lambda: expect(F.FrameDecoder(io.BytesIO(f), engine="device").read_all(), label))

    cfg64 = CodecConfig()
    base10 = torch.cuda.memory_allocated()
    f_default, first_default, _ = encode_path(
        "LZ4Codec().compress (160 x 64 KiB independent)", lambda: frame_of(cfg64), keep=True)
    peak10 = torch.cuda.max_memory_allocated() - base10
    check_frame("the default codec frame", f_default)
    # encode_blocks uploads, encodes and reads back 32 rows at a time, so
    # eight times the input must not raise the peak
    big = data * 8
    base80 = torch.cuda.memory_allocated()
    encode_path(f"LZ4Codec().compress ({len(big) // 65536:,} x 64 KiB independent)",
                lambda: LZ4Codec().compress(big), decode=F.decompress, want=big)
    peak80 = torch.cuda.max_memory_allocated() - base80
    print(f"  peak memory of LZ4Codec().compress above what was held: {peak10 / MIB:.1f} MiB "
          f"on {n / MIB:.0f} MiB, {peak80 / MIB:.1f} MiB on {len(big) / MIB:.0f} MiB [{card}]",
          flush=True)
    if peak80 > 1.1 * peak10:
        raise SystemExit("chip_smoke: the default codec's device memory grows with its input")
    del big
    frame_cfgs = {
        "64 KiB linked, content checksum": CodecConfig(block_mode=BlockMode.Linked,
                                                       content_checksum=True),
        "256 KiB independent, block checksums": CodecConfig(block_size=BlockSize.Max256KB,
                                                            block_checksums=True),
    }
    encoded = {}
    for label, cfg in frame_cfgs.items():
        f, _, _ = encode_path(f"LZ4Codec.compress ({label})", lambda: frame_of(cfg))
        check_frame(label, f)
        encoded[label.split(" ")[0] + " KiB"] = f

    def stream_enc64():
        buf = io.BytesIO()
        with F.FrameEncoder(buf, FrameInfo(block_size=BlockSize.Max64KB), engine="device") as enc:
            for i in range(0, n, 3 * MIB + 12345):
                enc.write(data[i : i + 3 * MIB + 12345])
        return buf.getvalue()

    f_stream, _, _ = encode_path("FrameEncoder device (64 KiB independent)", stream_enc64)
    same(f_stream, f_default, "FrameEncoder device against LZ4Codec().compress")

    comp_res, first_res, s_res = encode_path(
        "LZ4Codec.compress_block (10 MiB, resident)", lambda: LZ4Codec().compress_block(data),
        decode=lambda c: native.decompress_block(c, n), keep=True)
    quads = -(-E._row_bucket(-(-n // E._CHUNK_C)) // 4)  # 23 chunk rows, bucket 24: 6
    if (s_res["match_calls"], s_res["emit_calls"]) != (quads, 1):
        raise SystemExit(f"chip_smoke: the resident encode took {s_res}, not {quads} quads "
                         f"and 1 merge")
    main_path("decode_block_device of the resident wire",
              lambda: expect(decode_block_device(comp_res, n), "resident"))
    dict300, src300 = data[: 65536], data[65536 : 65536 + 300 * 1024]
    comp300, first300, _ = encode_path(
        "LZ4Codec.compress_block (300 KiB + 64 KiB dictionary)",
        lambda: LZ4Codec().compress_block(src300, dict300),
        decode=lambda c: native.decompress_block(c, len(src300), dict300), want=src300, keep=True)
    main_path("decode_block_device of the 300 KiB wire",
              lambda: same(decode_block_device(comp300, len(src300), dict300), src300, "300 KiB"))
    step_rows, step_d, step_t, step_nb = PP.stage_blocks(data[: 32 * 65536], 65536)
    (step_out, step_tot), _, _ = encode_path(
        f"LZ4Codec().encode_step ({step_nb} x {step_rows.shape[1]:,})",
        lambda: LZ4Codec().encode_step(step_rows, step_d, step_t))
    step_h, step_n = step_out.cpu().numpy(), step_tot.cpu().numpy()
    same(b"".join(native.decompress_block(step_h[i, : step_n[i]].tobytes(), 65536)
                  for i in range(step_nb)), data[: 32 * 65536], "encode_step")
    replay(first_default, "first dispatch of the default codec frame")
    replay(first_res, "first quad and the merge, 10 MiB resident")
    replay(first300, "single chunk, 300 KiB + dictionary")

    # stage times on the first dispatch of the default codec frame, and the
    # resident encode's first quad and merge (CUDA events, median of 5)
    def timed(first: dict, name: str) -> float:
        a, kw, _ = first[name]
        return kernel_ms(lambda: getattr(E, name)(*a, **kw), iters=5, warmup=1)

    def bound(first: dict, name: str) -> float:
        """Each input read once and each output written once, over the HBM
        rate (a quad reads its four chunk rows of the resident stream)."""
        a, kw, r = first[name]
        ins = tensors(a) + tensors(list(kw.values()))
        moved = sum(t.numel() * t.element_size() for t in ins + tensors(r))
        if name == "_match_quad":
            moved += len(a[1]) * E._CHUNK_W - a[0].numel()
        return moved / FP.HBM_BYTES_PER_S * 1e3

    # On the card encode_chunk_core is one launch of the kernel
    # csrc/encode_rows.cu: its plain version (match_core, then emit_core) on
    # the first dispatch's 32 rows, held to it byte for byte and timed
    # beside it; 20 kernel calls under one profiler window (a one-call
    # window may miss a kernel launched from its library).
    a32, kw32, got32 = first_default["encode_chunk_core"]
    main_calls = dict(prog_calls)
    want32, first_plain = recorded(lambda: E.encode_chunk_core_reference(*a32, **kw32))
    prog_calls.update(main_calls)
    plain_err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got32, want32))
    if plain_err:
        raise SystemExit("chip_smoke: the encode kernel differs from its plain version")
    plain_ms = kernel_ms(lambda: E.encode_chunk_core_reference(*a32, **kw32), iters=5, warmup=1)
    seen = device_event_names(lambda: E.encode_chunk_core(*a32, **kw32), 20)
    enc_events = sum(v for k, v in seen.items() if "encode_rows_kernel" in k)
    if sum(seen.values()) != enc_events or not 10 <= enc_events <= 20:
        raise SystemExit(f"chip_smoke: encode_chunk_core is not one kernel a call: {dict(seen)}")
    prog_ms = {name: timed(first_plain, name) for name in ("match_core", "emit_core")}
    prog_ms["encode_chunk_core"] = timed(first_default, "encode_chunk_core")
    prog_ms.update({name: timed(first_res, name) for name in ("_match_quad", "_merge_emit")})
    prog_bound = {name: bound(first_plain, name) for name in ("match_core", "emit_core")}
    prog_bound["encode_chunk_core"] = bound(first_default, "encode_chunk_core")
    prog_bound.update({name: bound(first_res, name) for name in ("_match_quad", "_merge_emit")})
    for name in programs:
        extra = ""
        if name == "encode_chunk_core":
            extra = (f" (kernel csrc/encode_rows.cu on {a32[0].shape[0]} rows of "
                     f"{a32[0].shape[1]:,}; plain version {plain_ms:.3f} ms, byte-exact; "
                     f"{enc_events} kernel events of 20 calls, no other)")
        print(f"  device program {name:18s} {prog_ms[name]:9.3f} ms{extra}, bytes bound "
              f"{prog_bound[name]:.5f} ms, calls on the main paths {prog_calls[name]}, "
              f"max_abs_err {prog_err[name]} [{card}]", flush=True)
    out32 = first_default["encode_chunk_core"][2][0]
    read_ms = cuda_host_ms(lambda: out32.cpu(), 5)
    payloads64, lens64, _ = PP.encode_blocks(data, 65536)
    verify_ms = host_ms(lambda: [native.verify_block(p, data[i * 65536 : i * 65536 + m])
                                 for i, (p, m) in enumerate(zip(payloads64, lens64))], 3)
    stage_ms = host_ms(lambda: PP.stage_blocks(data, 65536), 3)
    staged = PP.stage_blocks(data, 65536)[0]
    group = staged[: PP._ENCODE_ROWS]
    up_ms = cuda_host_ms(lambda: torch.from_numpy(group).pin_memory().cuda(non_blocking=True), 3)
    print(f"  stages, 10 MiB in 64 KiB blocks: staging {stage_ms:.3f} ms, pinned upload of one "
          f"group {up_ms:.3f} ms, "
          f"{len(lens64)} rows in {-(-len(lens64) // PP._ENCODE_ROWS)} dispatches of "
          f"{prog_ms['encode_chunk_core']:.3f} ms (plain version {plain_ms:.3f}: match "
          f"{prog_ms['match_core']:.3f}, emit {prog_ms['emit_core']:.3f}), payload read of one dispatch {read_ms:.3f} ms, verify "
          f"walks {verify_ms:.3f} ms [{card}]", flush=True)
    print(f"  stages, 10 MiB resident: {quads} quads of {prog_ms['_match_quad']:.3f} ms, merge "
          f"and emission {prog_ms['_merge_emit']:.3f} ms [{card}]", flush=True)
    cfg256 = frame_cfgs["256 KiB independent, block checksums"]
    e2e = {
        "LZ4Codec().compress (64 KiB)": (lambda: frame_of(cfg64), f_default),
        "LZ4Codec.compress (256 KiB)": (lambda: frame_of(cfg256), encoded["256 KiB"]),
        "compress_block_device (resident)": (lambda: E.compress_block_device(data), comp_res),
        "compress_block_hybrid": (lambda: E.compress_block_hybrid(data), hybrid["bench soup"]),
        "native.compress_block": (lambda: native.compress_block(data), comp),
    }
    for label, (fn, out) in e2e.items():
        ms = host_ms(fn, 3)
        print(f"  {label:36s} {ms:9.3f} ms = {n / MIB / (ms / 1e3):7.1f} MiB/s, ratio "
              f"{len(out) / n:.4f} [{card}]", flush=True)
    device_busy(lambda: frame_of(cfg64), "LZ4Codec().compress (64 KiB)", top=8)
    device_busy(lambda: E.compress_block_device(data), "compress_block_device (resident)", top=6)
    print(f"  phase 9 took {time.perf_counter() - t_phase9:.1f} s", flush=True)

    # ---- 10. the mesh layer on one card, and the CLI ------------------------------------
    print(f"phase 10: the mesh layer on one card (mesh entries repeat cuda:0) and the CLI "
          f"(tolerance: byte-exact; K1c against its plain version: max_abs_err must be 0) "
          f"[{card}]", flush=True)
    t_phase10 = time.perf_counter()
    from lz4_flex_tpu_torch import cli
    from lz4_flex_tpu_torch.frame import compress_frame_device
    from lz4_flex_tpu_torch.parallel import codec_mesh

    def mesh_of(k: int):
        return codec_mesh(["cuda:0"] * k)

    # The default codec's frame of phase 9: 160 independent 64 KiB blocks.
    fi_default = CodecConfig().frame_info()  # 64 KiB independent blocks
    payloads160 = []
    pos = len(fi_default.write())
    while True:
        info = BlockInfo.read(f_default[pos : pos + 4])
        pos += 4
        if info.kind is BlockInfoKind.EndMark:
            break
        if info.kind is not BlockInfoKind.Compressed:
            raise SystemExit("chip_smoke: the default codec's frame holds a stored block")
        payloads160.append(f_default[pos : pos + info.size])
        pos += info.size
    if len(payloads160) != 160:
        raise SystemExit(f"chip_smoke: the default codec's frame has {len(payloads160)} blocks")

    def native_back(payloads, lens, label: str) -> None:
        same(b"".join(native.decompress_block(p, m) for p, m in zip(payloads, lens)), data, label)

    # N=1: every mesh entry point gives the bytes of the run without a mesh
    m1 = mesh_of(1)
    for bs in (65536, MIB):
        got = PP.encode_blocks_sharded(data, bs, mesh=m1)
        if got != PP.encode_blocks(data, bs)[:2]:
            raise SystemExit(f"chip_smoke: encode_blocks_sharded N=1 at {bs} differs from encode_blocks")
        native_back(*got, f"encode_blocks_sharded N=1 at {bs}")
    for label, fi in (("64 KiB", fi_default), ("1 MiB linked", FrameInfo(
            block_size=BlockSize.Max1MB, block_mode=BlockMode.Linked, content_checksum=True))):
        f = compress_frame_device(data, fi, mesh=m1)
        same(f, compress_frame_device(data, fi), f"compress_frame_device(mesh=) N=1, {label}")
        same(F.decompress(f), data, f"compress_frame_device(mesh=) N=1, {label}, host read")
    same(LZ4Codec(CodecConfig(), m1).compress(data), f_default, "LZ4Codec(mesh=) N=1")
    buf = io.BytesIO()
    with F.FrameEncoder(buf, fi_default, engine="device", mesh=m1) as enc:
        for i in range(0, n, 3 * MIB + 12345):
            enc.write(data[i : i + 3 * MIB + 12345])
    same(buf.getvalue(), f_default, "FrameEncoder(engine='device', mesh=) N=1")
    for label, fn in (("decompress_frame_device(mesh=) N=1",
                       lambda: decompress_frame_device(f_default, mesh=m1)),
                      ("LZ4Codec(mesh=).decompress N=1",
                       lambda: LZ4Codec(mesh=m1).decompress(f_default))):
        s = main_path(label, lambda: expect(fn(), label))
        if s["grouped_launches"] != 1:
            raise SystemExit(f"chip_smoke: {label}: {s}")

    # N=4 and 8: one K1c launch a decode, each group's plan held against the plain version
    max_err["ring_decode_grouped"] = 0

    def stacked_plans(g: int):
        """The 160 blocks in g groups, as decode_blocks_sharded_ring stages
        them: (staged groups, the stacked plan tensors on the card)."""
        per = -(-len(payloads160) // g)
        staged = PP.stage_ring_groups([payloads160[i * per : (i + 1) * per] for i in range(g)], 65536)
        if staged is None:
            raise SystemExit(f"chip_smoke: a group's plan overflowed at G={g}")
        staged = [st for st in staged if st and st[0]]
        arrs = PP.stack_ring_plans([st[0] for st in staged], R.TILE_ROWS)
        return staged, [torch.from_numpy(a).cuda() for a in arrs]

    def grouped_bytes(staged) -> int:
        """Bytes K1c must move for these plans, unpadded, as FP.plan_bytes
        counts a plan's: literal images, the fires' records, nf_tot, output."""
        tot = 0
        for (nft, init, f0, _, _), _ in staged:
            fires = int(np.minimum(nft, f0.shape[1]).sum())
            tot += 2 * init.nbytes + fires * R.RB * 12 + nft.nbytes
        return tot

    grouped = {}
    for g in (1, 4, 8):
        staged, ts = stacked_plans(g)
        out = R.ring_decode_grouped(*ts, tile_rows=R.TILE_ROWS)
        ref = R.ring_decode_grouped_reference(*ts, tile_rows=R.TILE_ROWS)
        torch.cuda.synchronize()
        e = int((out.int() - ref.int()).abs().max())
        max_err["ring_decode_grouped"] = max(max_err["ring_decode_grouped"], e)
        host = out.cpu().numpy()
        got = b"".join(host[k].reshape(-1)[: sum(st[1])].tobytes() for k, st in enumerate(staged))
        print(f"  K1c G={g}: grid {ts[0].shape[0]}, plan shape (ntiles {ts[4].shape[1]}, nf "
              f"{ts[1].shape[2]}), fires {int(ts[4].sum())}, max_abs_err {e}, bytes "
              f"{'exact' if got == data else 'WRONG'}", flush=True)
        if e or got != data:
            raise SystemExit(f"chip_smoke: K1c and its plain version disagree at G={g}")
        grouped[g] = dict(staged=staged, ts=ts, bound=grouped_bytes(staged) / FP.HBM_BYTES_PER_S * 1e3)
    for k in (4, 8):
        mk = mesh_of(k)
        for label, fn in ((f"decode_blocks_sharded N={k}",
                           lambda: b"".join(PP.decode_blocks_sharded(payloads160, 65536, mesh=mk))),
                          (f"decompress_frame_device(mesh=) N={k}",
                           lambda: decompress_frame_device(f_default, mesh=mk))):
            s = main_path(label, lambda: expect(fn(), label))
            if s["grouped_launches"] != 1 or s["kernel_launches"] != 1:
                raise SystemExit(f"chip_smoke: {label} took {s}, not one K1c launch")
    enc_1m = {}
    for k in (4, 8):
        for key in E.stats:
            E.stats[key] = 0
        t0 = time.perf_counter()
        enc_1m[k] = PP.encode_blocks_sharded(data, MIB, mesh=mesh_of(k))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        st = dict(E.stats)
        print(f"  encode_blocks_sharded N={k} at 1 MiB: {ms:.1f} ms, ratio "
              f"{sum(map(len, enc_1m[k][0])) / n:.4f}, counts {st} [{card}]", flush=True)
        if st["match_calls"] == 0 or st["plane_quads"] or st["candidate_calls"] or st["verify_fallbacks"]:
            raise SystemExit(f"chip_smoke: 1 MiB blocks at N={k} did not take compress_block_device: {st}")
    if enc_1m[4] != enc_1m[8]:
        raise SystemExit("chip_smoke: 1 MiB blocks at N=4 and N=8 differ")
    native_back(*enc_1m[4], "encode_blocks_sharded at 1 MiB, N=4")
    if enc_1m[4][0] == PP.encode_blocks(data, MIB)[0]:
        raise SystemExit("chip_smoke: 1 MiB blocks took the same route at N=1 and N=4")

    # forced overflow at N=2: the resident decoder, with no K1 launch and no host decode
    p8 = payloads160[:8]
    saved = (R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0], native.decompress_block)
    R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0], native.decompress_block = (1,), 1, 1, refuse
    try:
        for key in R.stats:
            R.stats[key] = 0
        t0 = time.perf_counter()
        got = PP.decode_blocks_sharded(p8, 65536, mesh=mesh_of(2))
        torch.cuda.synchronize()
        ov_ms = (time.perf_counter() - t0) * 1e3
        s = dict(R.stats)
    finally:
        R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0], native.decompress_block = saved
    same(b"".join(got), data[: 8 * 65536], "forced overflow, decode_blocks_sharded N=2")
    print(f"  forced overflow, decode_blocks_sharded N=2 (8 x 64 KiB): byte-exact, {ov_ms:.3f} ms, "
          f"counts {s} [{card}]", flush=True)
    if s["overflow_sharded_decodes"] != 1 or s["kernel_launches"]:
        raise SystemExit(f"chip_smoke: forced overflow at N=2: {s}")
    t0 = time.perf_counter()
    comp8, lens8, offs8, ok8 = PP.roundtrip_step_sharded(data[: 8 * 65536], 65536, mesh=mesh_of(2))
    ok8 = bool(ok8)
    rt_ms = (time.perf_counter() - t0) * 1e3
    print(f"  roundtrip_step_sharded N=2 (8 x 64 KiB): ok {ok8}, {rt_ms:.1f} ms [{card}]", flush=True)
    if not ok8 or int(offs8[-1] + lens8[-1]) != int(lens8.sum()):
        raise SystemExit("chip_smoke: roundtrip_step_sharded at N=2 failed")

    # times: K1a on the frame as one plan and K1c at G=1, 4, 8, in turns
    fplan, _ = R.build_ring_plan_parts([(p, True) for p in payloads160], n, independent=True)
    fts = R.ring_plan_device_tensors(fplan, "cuda")
    torch.cuda.synchronize()
    fns = {"K1a": lambda: R.ring_decode(*fts, tile_rows=R.TILE_ROWS)}
    for g in (1, 4, 8):
        fns[f"K1c G={g}"] = lambda g=g: R.ring_decode_grouped(*grouped[g]["ts"], tile_rows=R.TILE_ROWS)
    order = list(fns) + list(reversed(fns))
    turns = {k: [] for k in fns}
    for name in order:
        turns[name].append(kernel_ms(fns[name]))
    k_ms = {k: statistics.mean(v) for k, v in turns.items()}
    plain_g8 = cuda_host_ms(lambda: R.ring_decode_grouped_reference(*grouped[8]["ts"],
                                                                    tile_rows=R.TILE_ROWS), 3)
    print(f"  in turns ({' '.join(order)}): " + ", ".join(
        f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in turns.items()) + f" [{card}]")
    print(f"  K1a (one plan of {fplan.ntiles} tiles) {k_ms['K1a']:.4f} ms, bound "
          f"{FP.bound_ms(fplan):.5f} ms; " + "; ".join(
              f"K1c G={g} {k_ms[f'K1c G={g}']:.4f} ms, bound {grouped[g]['bound']:.5f} ms"
              for g in (1, 4, 8)) + f"; G=8/G=1 {k_ms['K1c G=8'] / k_ms['K1c G=1']:.4f}; plain "
          f"version at G=8 {plain_g8:.2f} ms [{card}]", flush=True)
    build_ms = {}
    for g in (1, 4, 8):
        per = -(-len(payloads160) // g)
        groups = [payloads160[i * per : (i + 1) * per] for i in range(g)]
        build_ms[g] = host_ms(lambda: PP.stage_ring_groups(groups, 65536), 10)
    parts160 = [(p, True) for p in payloads160]
    walk_ms = host_ms(lambda: R.part_sizes(parts160), 10)
    one_ms = {t: host_ms(lambda: R.build_ring_plan_parts(parts160, n, independent=True, nthreads=t), 10)
              for t in (0, 1)}
    print(f"  of the G=1 stage: size walks {walk_ms:.3f} ms, the plan build {one_ms[0]:.3f} ms on "
          f"the native pool's lanes, {one_ms[1]:.3f} ms on one lane [{card}]", flush=True)
    e2e_mesh = {k: host_ms(lambda: decompress_frame_device(f_default, mesh=mesh_of(k)), 5)
                for k in (1, 4, 8)}
    e2e_one = host_ms(lambda: decompress_frame_device(f_default), 5)
    print(f"  plan-build wall (stage_ring_groups, {os.cpu_count()} host cores): " + ", ".join(
        f"G={g} {v:.3f} ms" for g, v in build_ms.items()) + f"; decompress_frame_device of the "
          f"160-block frame: one card, no mesh {e2e_one:.3f} ms; " + ", ".join(
              f"mesh N={k} {v:.3f} ms" for k, v in e2e_mesh.items()) + f" [{card}]", flush=True)

    # the CLI with --engine device, as a user runs it
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    data4 = data[: 4 * MIB]

    def run_cli(*args, stdin: bytes | None = None) -> bytes:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "lz4_flex_tpu_torch.cli", *args], input=stdin,
                           capture_output=True, cwd=root, env=env, timeout=300)
        if r.returncode:
            raise SystemExit(f"chip_smoke: the CLI {args} failed: {r.stderr.decode()[-2000:]}")
        print(f"  cli {' '.join(args)}: {(time.perf_counter() - t0) * 1e3:.1f} ms (process "
              f"included) [{card}]", flush=True)
        return r.stdout

    piped = run_cli("--engine", "device", stdin=data4)
    same(piped, compress_frame_device(data4), "CLI pipe against compress_frame_device")
    same(F.decompress(piped), data4, "CLI pipe, host read")
    same(run_cli("-d", "--engine", "device", stdin=piped), data4, "CLI pipe roundtrip")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "soup.txt")
        with open(src, "wb") as fh:
            fh.write(data4)
        run_cli(src, "-f", "--engine", "device", "--block-size", "Max64KB", "--content-checksum")
        with open(src + ".lz4", "rb") as fh:
            filed = fh.read()
        fi64 = FrameInfo(block_size=BlockSize.Max64KB, content_checksum=True)
        same(filed, compress_frame_device(data4, fi64), "CLI file against compress_frame_device")
        same(F.decompress(filed), data4, "CLI file, host read")
        run_cli(src + ".lz4", "-f", "-o", src + ".back", "--engine", "device")
        with open(src + ".back", "rb") as fh:
            same(fh.read(), data4, "CLI file roundtrip")
    print(f"  phase 10 took {time.perf_counter() - t_phase10:.1f} s", flush=True)

    # ---- 11. the examples, and a two-process mesh on one card ------------------------------
    print(f"phase 11: the five examples as python -m, and a two-process mesh on cuda:0 "
          f"(tolerance: byte-exact; K1c against its plain version: max_abs_err must be 0) "
          f"[{card}]", flush=True)
    t_phase11 = time.perf_counter()
    import hashlib
    import pickle
    import socket

    from lz4_flex_tpu_torch.block import compress_prepend_size

    def start(args, stdin: bytes = b""):
        """A subprocess of this checkout's Python, its stdin written and
        closed: (process, its start time, its stdin bytes)."""
        p = subprocess.Popen([sys.executable, *args], cwd=root, env=env, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        return p, time.perf_counter(), stdin

    def finish(run, label: str, timeout: float) -> bytes:
        p, t0, stdin = run
        try:
            out, err = p.communicate(stdin, timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise SystemExit(f"chip_smoke: {label} timed out after {timeout} s")
        if p.returncode:
            raise SystemExit(f"chip_smoke: {label} failed (exit {p.returncode}): "
                             f"{err.decode(errors='replace')[-3000:]}")
        print(f"  {label}: {(time.perf_counter() - t0) * 1e3:.1f} ms (process included) [{card}]",
              flush=True)
        return out

    def example(name: str) -> list[str]:
        return ["-m", f"lz4_flex_tpu_torch.examples.{name}"]

    cfg_pipe = CodecConfig(block_size=BlockSize.Max64KB, block_mode=BlockMode.Linked,
                           content_checksum=True)
    f_pipe = LZ4Codec(cfg_pipe).compress(data)
    main_path("device_pipeline's decode, in this process",
              lambda: expect(LZ4Codec(cfg_pipe).decompress(f_pipe), "device_pipeline's frame"))
    with tempfile.TemporaryDirectory() as tmp:
        soup_path = os.path.join(tmp, "soup.txt")
        with open(soup_path, "wb") as fh:
            fh.write(data)
        wave = {name: start(example(name), data4) for name in ("compress", "compress_block")}
        wave["device_pipeline"] = start(example("device_pipeline") + [soup_path])
        outs = {name: finish(run, f"examples.{name}", 600) for name, run in wave.items()}
    same(outs["compress"], F.compress(data4), "examples.compress against the host frame codec")
    same(outs["compress_block"], compress_prepend_size(data4),
         "examples.compress_block against block.compress_prepend_size")
    want_line = (f"{n} -> {len(f_pipe)} bytes (ratio {len(f_pipe) / n:.4f}), "
                 f"roundtrip OK\n").encode()
    print(f"  examples.device_pipeline on the 10 MiB soup: {outs['device_pipeline'].decode().strip()}",
          flush=True)
    same(outs["device_pipeline"], want_line, "examples.device_pipeline's line")
    wave = {"decompress": start(example("decompress"), outs["compress"]),
            "decompress_block": start(example("decompress_block"), outs["compress_block"])}
    for name, run in wave.items():
        same(finish(run, f"examples.{name}", 600), data4, f"examples.{name} back to the input")

    # two processes of this script on cuda:0, joined by distributed_init, global meshes of
    # 2x2 and 2x4
    want_enc = {k: compress_frame_device(data, fi_default, mesh=mesh_of(k)) for k in (4, 8)}
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join(work, "inputs.pkl"), "wb") as fh:
            pickle.dump((data, f_default, payloads160), fh)
        with socket.socket() as sk:  # a free port for the group's rendezvous
            sk.bind(("127.0.0.1", 0))
            address = f"127.0.0.1:{sk.getsockname()[1]}"
        runs = [start([os.path.abspath(__file__), MESH_WORKER, address, str(r), str(MESH_WORLD), work])
                for r in range(MESH_WORLD)]
        try:
            for r, run in enumerate(runs):
                print(finish(run, f"mesh worker rank {r}", 300).decode().rstrip(), flush=True)
        finally:
            for p, _, _ in runs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))

    def digest(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    for local in MESH_LOCAL:
        k = MESH_WORLD * local
        for st in ranks:
            got = st["meshes"][str(local)]
            if got["decoded"] != digest(data) or got["encoded"] != digest(want_enc[k]):
                raise SystemExit(f"chip_smoke: rank {st['rank']} at 2x{local} differs from the "
                                 f"one-process N={k} bytes")
            s = got["counts"]
            if s["grouped_launches"] != 1 or s["kernel_launches"] != 1 or s["overflow_sharded_decodes"]:
                raise SystemExit(f"chip_smoke: rank {st['rank']} at 2x{local}: {s}, not one K1c launch")
            launches["ring_decode_grouped"] += s["grouped_launches"]
        print(f"  two-process decompress_frame_device at 2x{local}: " + ", ".join(
            f"rank {st['rank']} {st['meshes'][str(local)]['decode_ms']:.3f} ms" for st in ranks)
              + f" against one process at N={k} {e2e_mesh[k]:.3f} ms (phase 10); "
              f"compress_frame_device " + ", ".join(
                  f"rank {st['rank']} {st['meshes'][str(local)]['encode_ms']:.3f} ms" for st in ranks)
              + f"; bytes equal to N={k}, one K1c launch a process a decode [{card}]", flush=True)
    for st in ranks:
        max_err["ring_decode_grouped"] = max(max_err["ring_decode_grouped"], st["k1c_max_abs_err"])
        if st["k1c_max_abs_err"] or not st["k1c_bytes_exact"]:
            raise SystemExit(f"chip_smoke: K1c and its plain version disagree on rank {st['rank']}")
        s = st["overflow"]["counts"]
        if (st["overflow"]["decoded"] != digest(data[: 8 * 65536])
                or st["overflow"]["again_decoded"] != digest(data[: 8 * 65536])
                or s["overflow_sharded_decodes"] != 1 or s["kernel_launches"]):
            raise SystemExit(f"chip_smoke: forced overflow on rank 1: rank {st['rank']}: {s}")
        if st["corrupt"] != "OffsetOutOfBounds":
            raise SystemExit(f"chip_smoke: a corrupted block on rank 1: rank {st['rank']} "
                             f"raised {st['corrupt']}")
    print(f"  the host gather alone, {n // MESH_WORLD} bytes a rank over gloo: " + ", ".join(
        f"rank {st['rank']} {st['gather_ms']:.3f} ms" for st in ranks) + f" [{card}]", flush=True)
    print(f"  forced overflow on rank 1 alone: both ranks byte-exact through the resident decoder, "
          f"no K1 launch ({', '.join(f'{st["overflow"]["ms"]:.3f}' for st in ranks)} ms; "
          f"the same call again {', '.join(f'{st["overflow"]["again_ms"]:.3f}' for st in ranks)} "
          f"ms); "
          f"a corrupted block on rank 1: OffsetOutOfBounds on both ranks; K1c max_abs_err 0 on "
          f"each rank's groups [{card}]", flush=True)
    print(f"  phase 11 took {time.perf_counter() - t_phase11:.1f} s", flush=True)

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
        # K1c at G=8, the largest grid of phase 10's main paths
        {"name": "ring_decode_grouped", "route": "cuda", "source": SOURCE,
         "replaces": "lz4_flex_tpu/parallel/pipeline.py:444",
         "launches": launches["ring_decode_grouped"], "max_abs_err": max_err["ring_decode_grouped"],
         "ms": k_ms["K1c G=8"], "plain_ms": plain_g8, "bound_ms": grouped[8]["bound"],
         "bound_by": "bytes", "library_ms": None},
    ]
    # The all-device encode kernel on the default frame's first dispatch (phase 9).
    kernels.append({
        "name": "encode_rows", "route": "cuda", "source": "lz4_flex_tpu_torch/csrc/encode_rows.cu",
        "replaces": "lz4_flex_tpu/ops/encode.py:427", "launches": prog_calls["encode_chunk_core"],
        "max_abs_err": max(plain_err, prog_err["encode_chunk_core"]),
        "ms": prog_ms["encode_chunk_core"], "plain_ms": plain_ms,
        "bound_ms": prog_bound["encode_chunk_core"], "bound_by": "bytes", "library_ms": None})
    # The resident kernel at the batch cell's shape (phase 8).
    for b, r in resident.items():
        kernels.append({
            "name": f"resident_decode:B={b}", "route": "cuda",
            "source": "lz4_flex_tpu_torch/csrc/resident_decode.cu",
            "replaces": "lz4_flex_tpu/parallel/pipeline.py:124", **r, "bound_by": "bytes",
            "library_ms": None})
    # Fire probe entries: the 10 MiB bench soup at the main path's tile height.
    for r in fres["rows"]:
        if r["tile_rows"] == R.TILE_ROWS and r["corpus"] == "bench soup":
            v = r["variant"]
            kernels.append({
                "name": f"fire_probe:{v}", "route": "cuda", "source": FP.SOURCE,
                "replaces": FP.REPLACES[v], "launches": FP.stats[v],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": fres["plain_ms"][(R.TILE_ROWS, "bench soup")] if v in FP.EXACT else None,
                "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None})
    # Gather forms: one pass (16 KiB gathered from the 96 KiB table).
    for v, r in gres.items():
        kernels.append({
            "name": f"gather_probe:{v}", "route": "cuda", "source": GP.SOURCE,
            "replaces": GP.REPLACES[GP.function_of(v)], "launches": GP.stats[v],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


def mesh_worker(address: str, rank: int, world: int, work: str) -> None:
    """One rank of phase 11: join the group at ``address`` through
    ``distributed_init`` (NCCL is the default group where a card is
    present; the pipelines' gathers run over its gloo host group, so both
    ranks may share ``cuda:0``), run every mesh case on ``cuda:0`` with the
    inputs that the parent wrote to
    ``work/inputs.pkl``, and write what it saw to ``work/rank<rank>.json``:
    digests of its outputs, launch counts, times and error types. Any
    failure raises, so the process exits non-zero."""
    import hashlib
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from lz4_flex_tpu_torch import native
    from lz4_flex_tpu_torch.block import errors as BE
    from lz4_flex_tpu_torch.frame import compress_frame_device, decompress_frame_device
    from lz4_flex_tpu_torch.models import CodecConfig
    from lz4_flex_tpu_torch.ops import ringdecode as R
    from lz4_flex_tpu_torch.parallel import distributed_init
    from lz4_flex_tpu_torch.parallel import pipeline as PP
    from lz4_flex_tpu_torch.parallel.mesh import all_gather_arrays, host_group

    if not distributed_init(address, num_processes=world, process_id=rank, local_device_ids=[0]):
        raise SystemExit("distributed_init did not start a process group")
    print(f"  mesh worker rank {rank}: default group {dist.get_backend()}, host gathers over "
          f"{'the default group' if host_group() is None else 'a gloo group'}", flush=True)
    with open(os.path.join(work, "inputs.pkl"), "rb") as fh:
        data, frame, payloads = pickle.load(fh)
    fi = CodecConfig().frame_info()

    def digest(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    def counted(fn):
        """fn() with the launch counters set to 0 just before: (its result,
        the counters, ms on the host clock up to a synchronize)."""
        for key in R.stats:
            R.stats[key] = 0
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, dict(R.stats), (time.perf_counter() - t0) * 1e3

    def median_ms(fn, iters: int) -> float:
        return statistics.median(counted(fn)[2] for _ in range(iters))

    report = {"rank": rank, "meshes": {}}
    for local in MESH_LOCAL:
        mesh = ["cuda:0"] * local
        decoded, counts, _ = counted(lambda: decompress_frame_device(frame, mesh=mesh))
        encoded = compress_frame_device(data, fi, mesh=mesh)
        report["meshes"][str(local)] = dict(
            decoded=digest(decoded), counts=counts, encoded=digest(encoded),
            decode_ms=median_ms(lambda: decompress_frame_device(frame, mesh=mesh), 5),
            encode_ms=median_ms(lambda: compress_frame_device(data, fi, mesh=mesh), 3))

    # the host gather alone: the decoded frame's bytes, half a rank, over the gloo group
    share = len(data) // world
    mine = np.frombuffer(data, np.uint8)[rank * share : (rank + 1) * share]
    gather_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        all_gather_arrays(mine, [share] * world)
        gather_ms.append((time.perf_counter() - t0) * 1e3)
    report["gather_ms"] = statistics.median(gather_ms)

    # this rank's groups at 2x2 through K1c and its plain version
    per = -(-len(payloads) // (world * MESH_LOCAL[0]))
    groups = [payloads[g * per : (g + 1) * per]
              for g in range(rank * MESH_LOCAL[0], (rank + 1) * MESH_LOCAL[0])]
    staged = [st for st in PP.stage_ring_groups(groups, 65536) if st and st[0]]
    ts = [torch.from_numpy(a).cuda() for a in PP.stack_ring_plans([st[0] for st in staged],
                                                                   R.TILE_ROWS)]
    out = R.ring_decode_grouped(*ts, tile_rows=R.TILE_ROWS)
    ref = R.ring_decode_grouped_reference(*ts, tile_rows=R.TILE_ROWS)
    torch.cuda.synchronize()
    host = out.cpu().numpy()
    got = b"".join(host[k].reshape(-1)[: sum(st[1])].tobytes() for k, st in enumerate(staged))
    first = rank * MESH_LOCAL[0] * per * 65536
    report["k1c_max_abs_err"] = int((out.int() - ref.int()).abs().max())
    report["k1c_bytes_exact"] = got == data[first : first + len(got)]

    # rank 1's plans overflow (a one-step NFMAX ladder), rank 0's fit; no host decode anywhere
    def refuse(*a, **kw):
        raise SystemExit("a device path decoded on the host")

    saved = R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0], native.decompress_block
    native.decompress_block = refuse
    if rank == 1:
        R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0] = (1,), 1, 1
    try:
        blocks, counts, ms = counted(
            lambda: PP.decode_blocks_sharded(payloads[:8], 65536, mesh=["cuda:0"] * MESH_LOCAL[0]))
        # the same call again: the first one in this process also pays for loading
        # the resident decoder's kernels
        again = counted(
            lambda: PP.decode_blocks_sharded(payloads[:8], 65536, mesh=["cuda:0"] * MESH_LOCAL[0]))
    finally:
        R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0], native.decompress_block = saved
    report["overflow"] = dict(decoded=digest(b"".join(blocks)), counts=counts, ms=ms,
                              again_ms=again[2], again_decoded=digest(b"".join(again[0])))

    # a block of rank 1's span corrupted: a match reaching before the block's start
    bad = list(payloads)
    bad[MESH_BAD_BLOCK] = bytes([0x10, 0x41, 100, 0, 0x00])
    try:
        PP.decode_blocks_sharded(bad, 65536, mesh=["cuda:0"] * MESH_LOCAL[0])
    except BE.DecompressError as e:
        report["corrupt"] = type(e).__name__
    else:
        raise SystemExit("a corrupted block decoded without an error")
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    dist.destroy_process_group()
    print(f"  mesh worker rank {rank}: done, K1c against its plain version max_abs_err "
          f"{report['k1c_max_abs_err']}")


if __name__ == "__main__":
    if sys.argv[1:2] == [MESH_WORKER]:
        mesh_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        main()
    sys.stdout.flush()
