"""One-shot block compression with the size prepended (the JAX package's
``examples/compress_block.py``).

Usage: python -m lz4_flex_tpu_torch.examples.compress_block < input > output.lz4b
"""

from __future__ import annotations

import sys

from .. import compress_prepend_size


def main(argv=None, *, device=None) -> int:
    """Compress stdin into one size-prepended block on stdout. ``argv`` and
    ``device`` are not read: the example takes no arguments and runs on the
    host, as the JAX one does."""
    sys.stdout.buffer.write(compress_prepend_size(sys.stdin.buffer.read()))
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
