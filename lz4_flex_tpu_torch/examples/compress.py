"""stdin -> stdout LZ4 frame compression on the host engine (the JAX
package's ``examples/compress.py``).

Usage: python -m lz4_flex_tpu_torch.examples.compress < input > output.lz4
"""

from __future__ import annotations

import sys

from ..frame import FrameEncoder


def main(argv=None, *, device=None) -> int:
    """Compress stdin into one frame on stdout. ``argv`` and ``device`` are
    not read: the example takes no arguments and runs on the host, as the
    JAX one does."""
    enc = FrameEncoder(sys.stdout.buffer)
    while chunk := sys.stdin.buffer.read(1 << 20):
        enc.write(chunk)
    enc.finish()
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
