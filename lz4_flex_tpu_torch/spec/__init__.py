"""Format constants."""

from . import constants

__all__ = ["constants"]
