"""Device pipeline demo (the JAX package's ``examples/device_pipeline.py``):
compress a file into an LZ4 frame of 64 KiB linked blocks with a content
checksum on the device, decode it back on the device, and check it against
the host streaming engine.

Usage: python -m lz4_flex_tpu_torch.examples.device_pipeline [file]

From the command line it runs on the CUDA card and fails without one.
"""

from __future__ import annotations

import pathlib
import sys

from .. import frame
from ..frame import BlockMode, BlockSize
from ..models import CodecConfig, LZ4Codec


def main(argv=None, *, device=None) -> int:
    """Round-trip ``argv[0]`` (default: a 90,000-byte sentence repeated)
    through ``LZ4Codec`` on ``device`` (``None``: the CUDA card) and print
    the sizes and the ratio."""
    argv = sys.argv[1:] if argv is None else list(argv)
    data = (pathlib.Path(argv[0]).read_bytes() if argv
            else b"The quick brown fox jumps over the lazy dog. " * 2000)
    codec = LZ4Codec(
        CodecConfig(block_size=BlockSize.Max64KB, block_mode=BlockMode.Linked,
                    content_checksum=True),
        device=device,
    )
    compressed = codec.compress(data)
    if codec.decompress(compressed) != data:
        raise RuntimeError("the device decode does not give the input back")
    if frame.decompress(compressed) != data:  # host engine cross-check
        raise RuntimeError("the host engine does not read the device frame back")
    print(f"{len(data)} -> {len(compressed)} bytes "
          f"(ratio {len(compressed) / max(len(data), 1):.4f}), roundtrip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
