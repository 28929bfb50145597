"""Time of ``LZ4Codec.decode_step`` on the card at several batch sizes.

    python3 lz4_flex_tpu_torch/experiments/decode_step_time.py [--root DIR] [--batches 1,8,32]

Compresses the 10 MiB bench soup as 160 independent 64 KiB blocks (the
native encoder), stages the payloads as device rows and, for each batch size
B, runs ``LZ4Codec(CodecConfig(block_size=Max64KB)).decode_step`` on the
first B rows: device tensors in and out, as a device pipeline calls it. It
prints one JSON line: per B the median of ``--iters`` host-clock times up to
a synchronize after one warm-up call, the device events (kernels and copies)
of one call under ``torch.profiler``, and a SHA-256 of the outputs, lengths
and flags (two versions that agree print the same); and the card's name and
power limit. ``--root`` imports ``lz4_flex_tpu_torch`` from another
checkout, so that two versions can be timed in turns, one process each, on
one card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."),
                    help="checkout whose lz4_flex_tpu_torch is timed (default: this one)")
    ap.add_argument("--batches", default="1,8,32", help="comma-separated batch sizes (at most 160)")
    ap.add_argument("--iters", type=int, default=3, help="timed calls per batch size")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("decode_step_time: needs a CUDA card")
    from lz4_flex_tpu_torch import native
    from lz4_flex_tpu_torch.experiments.fire_probe import bench_word_soup
    from lz4_flex_tpu_torch.frame.header import BlockSize
    from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec
    from lz4_flex_tpu_torch.ops import packing

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    data = bench_word_soup(10 << 20)
    parts = [native.compress_block(data[i : i + 65536]) for i in range(0, len(data), 65536)]
    rows = np.zeros((len(parts), packing.size_bucket(max(len(p) for p in parts) + 1)), np.uint8)
    for i, p in enumerate(parts):
        rows[i, : len(p)] = np.frombuffer(p, np.uint8)
    rows_d = torch.from_numpy(rows).cuda()
    lens_d = torch.tensor([len(p) for p in parts], dtype=torch.int32).cuda()
    codec = LZ4Codec(CodecConfig(block_size=BlockSize.Max64KB))

    result = {}
    for b in (int(x) for x in args.batches.split(",")):
        def step():
            out = codec.decode_step(rows_d[:b], lens_d[:b])
            torch.cuda.synchronize()
            return out

        digest = hashlib.sha256()
        for t in step():
            digest.update(t.cpu().numpy().tobytes())
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
        events = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
        result[b] = {"ms": statistics.median(times), "device_events": events,
                     "sha256": digest.hexdigest()}
    print(json.dumps({"root": os.path.abspath(args.root), "batches": result, "card": card}))


if __name__ == "__main__":
    main()
