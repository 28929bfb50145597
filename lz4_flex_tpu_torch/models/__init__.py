"""Flagship codec models: configured end-to-end pipelines."""

from .codec import CodecConfig, LZ4Codec

__all__ = ["CodecConfig", "LZ4Codec"]
