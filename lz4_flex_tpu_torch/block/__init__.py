"""Block format: the decompress error taxonomy."""

from . import errors

__all__ = ["errors"]
