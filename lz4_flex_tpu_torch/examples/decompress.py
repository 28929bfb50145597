"""stdin -> stdout LZ4 frame decompression on the host engine (the JAX
package's ``examples/decompress.py``).

Usage: python -m lz4_flex_tpu_torch.examples.decompress < input.lz4 > output
"""

from __future__ import annotations

import sys

from ..frame import FrameDecoder


def main(argv=None, *, device=None) -> int:
    """Decompress every frame on stdin to stdout. ``argv`` and ``device``
    are not read: the example takes no arguments and runs on the host, as
    the JAX one does."""
    sys.stdout.buffer.write(FrameDecoder(sys.stdin.buffer).read_all())
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
