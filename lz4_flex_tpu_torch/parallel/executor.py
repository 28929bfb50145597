"""The persistent host thread pool for native walks and plan builds (the
JAX package's ``parallel/pipeline.py:_plan_executor``)."""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

_pool_lock = threading.Lock()
_pool: list = [None]


def plan_executor() -> ThreadPoolExecutor:
    """The process's pool for concurrent native work (hybrid chunk walks).

    Persistent, not made per call: each worker thread owns thread-local
    scratch (the ring planner's rotating record pool,
    ops/ringdecode.py:_record_arrays), which a fresh pool per call would
    fault in again. The native calls release the GIL, so the workers run in
    parallel."""
    with _pool_lock:
        if _pool[0] is None:
            _pool[0] = ThreadPoolExecutor(
                max_workers=max(2, os.cpu_count() or 2), thread_name_prefix="tlz4-plan"
            )
        return _pool[0]
