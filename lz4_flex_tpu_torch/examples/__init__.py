"""The JAX package's five examples on the port, one module each, run as
``python -m lz4_flex_tpu_torch.examples.<name>``: ``compress`` and
``decompress`` (stdin to stdout through the streaming frame codec),
``compress_block`` and ``decompress_block`` (the size-prepended block
format), and ``device_pipeline`` (a frame through ``LZ4Codec`` on the card
and back). Each keeps its body in ``main(argv=None, *, device=None)``."""
