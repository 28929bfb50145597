"""One-shot decompression of a size-prepended block (the JAX package's
``examples/decompress_block.py``).

Usage: python -m lz4_flex_tpu_torch.examples.decompress_block < input.lz4b > output
"""

from __future__ import annotations

import sys

from .. import decompress_size_prepended


def main(argv=None, *, device=None) -> int:
    """Decompress the size-prepended block on stdin to stdout. ``argv`` and
    ``device`` are not read: the example takes no arguments and runs on the
    host, as the JAX one does."""
    sys.stdout.buffer.write(decompress_size_prepended(sys.stdin.buffer.read()))
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
