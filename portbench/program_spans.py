"""The port's own spans over a traced window, for the metrics that read them.

The port records a span at each of its layer boundaries while a profiler
records (``lz4_flex_tpu_torch.utils.trace``), stamped with ``time.time_ns()``,
the clock of the profiler's events, so they compare with the window
(``w.trace.window``) and the device's busy intervals (``w.trace._busy``),
both in the profiler's nanoseconds. A port without that module, or a window
without spans, gives None, and the metric is left out of the result line.
"""

from __future__ import annotations


def records(w):
    """The port's spans inside the traced window as
    (name, request_id, parent_index, thread_id, t0_ns, t1_ns), or None."""
    if w.trace is None or not w.trace.window:
        return None
    try:
        from lz4_flex_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.records(*w.trace.window) or None


def intervals(recs, names) -> list:
    """The sorted, disjoint union of the spans named in ``names`` (a name
    ending in ``.`` takes every span that starts with it)."""
    def named(n):
        return any(n.startswith(k) if k.endswith(".") else n == k for k in names)

    out = []
    for s, e in sorted((r[4], r[5]) for r in recs if named(r[0])):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def length(ivs) -> int:
    return sum(e - s for s, e in ivs)


def overlap(a, b) -> int:
    """Nanoseconds that two sorted, disjoint interval lists share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def total_ms(recs, names) -> float:
    """Host milliseconds inside any span of ``names``."""
    return length(intervals(recs, names)) / 1e6


def self_ms(recs, name, less) -> float:
    """Host milliseconds inside the spans ``name`` and outside every span
    of ``less``."""
    own = intervals(recs, (name,))
    return (length(own) - overlap(own, intervals(recs, less))) / 1e6


def count(recs, name) -> int:
    return sum(1 for r in recs if r[0] == name)


def idle_share_pct(w, recs, names) -> float | None:
    """The share of the device's idle time in the window (no device
    operation running) during which the host was inside a span of
    ``names``, x 100; None without idle time."""
    w0, w1 = w.trace.window
    busy = [[max(s, w0), min(e, w1)] for s, e in w.trace._busy if e > w0 and s < w1]
    idle, at = [], w0
    for s, e in busy:
        if s > at:
            idle.append([at, s])
        at = max(at, e)
    if at < w1:
        idle.append([at, w1])
    if not length(idle):
        return None
    return 100.0 * overlap(idle, intervals(recs, names)) / length(idle)


def per_request(value, w):
    """``value`` over the window's requests; None where either is missing."""
    return value / w.n if value is not None and w.n else None
