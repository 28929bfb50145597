"""Host orchestration of the device codec: the persistent walk pool and the
frame-block encode on one card (the mesh layer comes with ROADMAP item 7)."""

from .pipeline import encode_blocks

__all__ = ["encode_blocks"]
