"""Requests whose plan overflowed its static shape and went through the
expansion engine instead of K1, x 100
(`ringdecode.stats["overflow_fused_decodes"]` over the window's requests)."""

UNIT = "%"
SPANS = ()


def read(w):
    n = w.stats.get("ringdecode.overflow_fused_decodes")
    return 100.0 * n / w.n if n is not None and w.n else None
