"""Format constants, golden-model codec and checksum reference semantics."""

from . import constants, golden
from .xxhash32 import XxHash32, xxh32

__all__ = ["constants", "golden", "XxHash32", "xxh32"]
