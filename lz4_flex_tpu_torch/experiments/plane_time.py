"""Time of one candidate-plane dispatch on the card.

    python3 lz4_flex_tpu_torch/experiments/plane_time.py [--root DIR]

Runs ``ops.encode._best_plane_quad`` on the first dispatch of the 10 MiB
bench soup (8 chunk rows of 512 KiB, as ``compress_block_hybrid`` slices
them) and prints one JSON line: the median of 20 CUDA-event times after a
warm-up, the device time and the number of device kernels of one dispatch
under ``torch.profiler``, a SHA-256 of the plane (two versions that agree
print the same), and the card's name and power limit. ``--root`` imports
``lz4_flex_tpu_torch`` from another checkout, so that two versions of the
plane can be timed in turns, one process each, on one card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."),
                    help="checkout whose lz4_flex_tpu_torch is timed (default: this one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("plane_time: needs a CUDA card")
    from lz4_flex_tpu_torch.experiments.fire_probe import bench_word_soup, kernel_ms
    from lz4_flex_tpu_torch.ops import encode as E
    from lz4_flex_tpu_torch.ops import packing

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    data = bench_word_soup(10 << 20)
    bucket, _, _, groups = E._stream_rows(len(data), 0, len(data))
    gpad = torch.from_numpy(packing.pad_to(np.frombuffer(data, np.uint8).copy(), bucket)).cuda()
    ms = kernel_ms(lambda: E._best_plane_quad(gpad, groups[0]))
    plane = E._best_plane_quad(gpad, groups[0]).cpu().numpy()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        E._best_plane_quad(gpad, groups[0])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(json.dumps({
        "root": os.path.abspath(args.root), "rows": len(groups[0]), "ms": ms,
        "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
        "device_kernels": len(kernels), "plane_sha256": hashlib.sha256(plane.tobytes()).hexdigest(),
        "card": card,
    }))


if __name__ == "__main__":
    main()
