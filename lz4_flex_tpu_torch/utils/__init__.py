"""Shared utilities: checksums."""

from .checksum import XxHash32, xxh32

__all__ = ["XxHash32", "xxh32"]
