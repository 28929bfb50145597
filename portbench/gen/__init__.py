"""Input generation: the seeded text (text.py) and the frozen LZ4 encoder
(frozen.py) that makes the decode cells' frames and rows."""
