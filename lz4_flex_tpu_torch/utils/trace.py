"""Spans of the port's layers, recorded while a ``torch.profiler`` records.

``request(name)`` marks one call of an entry point and ``span(name)`` one
layer's work inside it. Tracing is on exactly while a profiler records
(``torch.autograd._profiler_enabled()``); there is no other switch. Off, a
span is one check and a shared no-op context. That state belongs to the
thread that started the profiler, so work handed to a pool thread passes
:func:`enabled`, read where it was submitted, as a span's ``on``. On, a span is a host range of
the profiler named ``"lz4:" + name``, so its timeline shows it above the ops
that launched kernels inside it, and a record kept in memory (the newest
``CAPACITY``), read with :func:`records`:

    (name, request_id, parent_index, thread_id, t0_ns, t1_ns)

``request_id`` is that of the innermost request open on the span's thread
(-1 outside any request, as on a pool thread); ``parent_index`` is the position, in the same list,
of the span that encloses it on its thread, or -1; ``thread_id`` is
``threading.get_ident()``. Times are ``time.time_ns()``, the clock of the
profiler's own events, read just outside the range, so a record holds its
``lz4:`` event and what the profiler spends to open and close it.

The range is a function-scope record (``_RecordFunctionFast``), not
``torch.profiler.record_function``: the profiler copies a user annotation
onto the device's timeline, and a reader of the trace that cannot tell
annotations from kernels (a torch whose events lack ``activity_type``) would
count it as device time. A function-scope range stays on the host.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

import torch

PREFIX = "lz4:"
CAPACITY = 1 << 20

_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_kept = deque(maxlen=CAPACITY)  # (seq, name, request_id, parent_seq, thread_id, t0_ns, t1_ns)
_open = threading.local()  # .stack: (seq, request_id) of this thread's open spans
_seq = itertools.count()
_requests = itertools.count(1)


def enabled() -> bool:
    """Whether spans are recorded on this thread now."""
    return _enabled()


def span(name: str, on: bool | None = None):
    """A context manager marking one layer's work as the span ``name``;
    ``on`` stands for the check on a thread that did not start the
    profiler (see the module's docstring)."""
    return _recorded(name, False) if (_enabled() if on is None else on) else _OFF


def request(name: str):
    """:func:`span` as the root of a new request: it and the spans opened
    inside it on its thread carry a new request id."""
    return _recorded(name, True) if _enabled() else _OFF


@contextlib.contextmanager
def _recorded(name: str, root: bool):
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    parent, rid = stack[-1] if stack else (-1, -1)
    if root:
        rid = next(_requests)
    seq = next(_seq)
    stack.append((seq, rid))
    t0 = time.time_ns()
    try:
        with torch._C._profiler._RecordFunctionFast(PREFIX + name):
            yield
    finally:
        t1 = time.time_ns()
        stack.pop()
        _kept.append((seq, name, rid, parent, threading.get_ident(), t0, t1))


def records(t0_ns: int | None = None, t1_ns: int | None = None) -> list[tuple]:
    """The kept spans that lie inside [t0_ns, t1_ns] (either bound may be
    left open), in the order they were opened."""
    kept = sorted(r for r in list(_kept)
                  if (t0_ns is None or r[5] >= t0_ns) and (t1_ns is None or r[6] <= t1_ns))
    at = {r[0]: i for i, r in enumerate(kept)}
    return [(name, rid, at.get(parent, -1), tid, t0, t1)
            for _, name, rid, parent, tid, t0, t1 in kept]


def clear() -> None:
    """Forget every kept span."""
    _kept.clear()
