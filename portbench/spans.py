"""Spans around the port's functions, and what the profiler saw inside them.

With ``--trace 1`` the harness wraps each function a cell's metrics name
(``"<module>:<qualname>"``, e.g. ``lz4_flex_tpu_torch.ops.ringdecode:ring_decode``)
in the module that defines it and in every module of the port that imported
it by name. A wrapper records its host interval on every thread and opens a
``torch.profiler.record_function`` range, so each device operation is
attributed by the profiler's correlation to the spans that were open on the
host when it was launched: by no kernel name, so a kernel that is renamed,
split or replaced is still held to the same work.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import sys
import time
import warnings
from collections import defaultdict

PREFIX = "pb:"
PORT = "lz4_flex_tpu_torch"


def request(spans):
    """The span of one request (a no-op without tracing)."""
    if spans is None:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(PREFIX + "request")


def _merge(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _holds(ivs, t) -> bool:
    """Whether one of the sorted, non-nested intervals ``ivs`` holds ``t``."""
    j = bisect.bisect_right(ivs, (t, float("inf"))) - 1
    return j >= 0 and ivs[j][0] <= t <= ivs[j][1]


def _total(intervals) -> float:
    return sum(e - s for s, e in _merge(intervals))


class Spans:
    """The wrappers of ``keys`` and the profiler over one traced window."""

    def __init__(self, keys) -> None:
        self.keys = list(keys)
        self.host = []  # (key, t0, t1), perf_counter seconds, any thread
        self._patched = []
        self._prof = self._win = None

    def _wrap(self, key, fn):
        import torch

        host, rf = self.host, torch.profiler.record_function

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            try:
                with rf(PREFIX + key):
                    return fn(*args, **kwargs)
            finally:
                host.append((key, t, time.perf_counter()))

        return wrapper

    def _install(self) -> None:
        for key in self.keys:
            modname, qual = key.split(":")
            mod = importlib.import_module(modname)
            *path, attr = qual.split(".")
            owner = functools.reduce(getattr, path, mod)
            orig = getattr(owner, attr)
            wrapper = self._wrap(key, orig)
            targets = [owner]
            if owner is mod:  # modules of the port that imported it by name
                targets += [m for name, m in list(sys.modules.items())
                            if m is not mod and name.split(".")[0] == PORT
                            and getattr(m, attr, None) is orig]
            for t in targets:
                setattr(t, attr, wrapper)
                self._patched.append((t, attr, orig))

    def _uninstall(self) -> None:
        for owner, attr, orig in reversed(self._patched):
            setattr(owner, attr, orig)
        self._patched.clear()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._install()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self._prof.__enter__()
        self._win = torch.profiler.record_function(PREFIX + "window")
        self._win.__enter__()
        self.host.clear()

    def stop(self) -> "TraceView":
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._win.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._uninstall()
        view = TraceView(self._prof.profiler.kineto_results.events(), list(self.host))
        self._prof = None
        return view


class TraceView:
    """The traced window: host spans (perf_counter, every thread), and the
    profiler's device operations (kernels, copies, sets), each attributed
    through its linked correlation id to the host op that launched it, and
    so to the spans open on that op's thread at that moment."""

    def __init__(self, events, host) -> None:
        from torch.autograd import DeviceType

        self._host = defaultdict(list)
        for key, t0, t1 in host:
            self._host[key].append((t0, t1))
        front, dev = {}, []
        spans = defaultdict(lambda: defaultdict(list))  # key -> thread -> [(start, end)] ns
        gpu_ann = defaultdict(list)  # key -> the profiler's device-side ranges of the span
        self.window = None
        self.main_thread = None
        for e in events:
            name = e.name()
            kind = e.activity_type() if hasattr(e, "activity_type") else None
            if e.device_type() != DeviceType.CPU:
                if name.startswith(PREFIX):
                    gpu_ann[name[len(PREFIX):]].append((e.start_ns(), e.end_ns()))
                elif kind != "gpu_user_annotation":
                    dev.append((e.start_ns(), e.end_ns(), name, kind, e.linked_correlation_id()))
                continue
            if e.linked_correlation_id() != 0:
                continue  # runtime and driver calls: their launches carry the op's id
            front[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
            if name.startswith(PREFIX):
                key = name[len(PREFIX):]
                rng = (e.start_ns(), e.end_ns())
                if key == "window":
                    self.window, self.main_thread = rng, e.start_thread_id()
                else:
                    spans[key][e.start_thread_id()].append(rng)
        self._spans = {k: {t: sorted(v) for t, v in th.items()} for k, th in spans.items()}
        self._gpu_ann = {k: sorted(v) for k, v in gpu_ann.items()}
        w0, w1 = self.window if self.window else (0, 0)
        self.window_s = (w1 - w0) / 1e9
        self._ops = []  # (start, end, name, is_kernel, keys), ns
        self.unattributed = 0
        cache = {}
        for start, end, name, kind, cid in dev:
            if cid not in cache:
                c = front.get(cid)
                cache[cid] = self._keys_at(*c) if c else None
            keys = cache[cid]
            if keys is None:
                # No host op carries the launch's id (a kernel launched from a
                # native library through its own CUDA runtime): take the spans
                # whose device-side range, which the profiler correlated
                # itself, holds the operation.
                keys = tuple(k for k, ivs in self._gpu_ann.items() if _holds(ivs, start))
                self.unattributed += not keys
            s, e = max(start, w0), min(end, w1)
            if e > s:
                is_kernel = kind == "kernel" if kind else not name.startswith(("Memcpy", "Memset"))
                self._ops.append((s, e, name, is_kernel, keys))
        self._busy = _merge((s, e) for s, e, *_ in self._ops)
        self.busy_s = sum(e - s for s, e in self._busy) / 1e9

    def _keys_at(self, thread, t) -> tuple:
        return tuple(k for k, th in self._spans.items() if _holds(th.get(thread, ()), t))

    def host_ms(self, keys) -> float:
        return 1e3 * _total([iv for k in keys for iv in self._host.get(k, ())])

    def device_ms(self, keys) -> float:
        keys = set(keys)
        return _total((s, e) for s, e, _, _, ks in self._ops if keys.intersection(ks)) / 1e6

    def kernels(self, keys) -> int:
        keys = set(keys)
        return sum(1 for *_, kern, ks in self._ops if kern and keys.intersection(ks))

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the innermost span open on the host at each gap's middle."""
        by_op = defaultdict(float)
        for s, e, name, *_ in self._ops:
            by_op[name] += (e - s) / 1e9
        gaps = defaultdict(float)
        if self.window:
            edges = [self.window[0]] + [x for iv in self._busy for x in iv] + [self.window[1]]
            main = {k: th.get(self.main_thread, []) for k, th in self._spans.items()}
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    mid, best, label = (a + b) / 2, None, "between requests"
                    for key, ivs in main.items():
                        j = bisect.bisect_right(ivs, (mid, float("inf"))) - 1
                        if j >= 0 and ivs[j][0] <= mid <= ivs[j][1] and (best is None or ivs[j][0] > best):
                            best, label = ivs[j][0], key
                    gaps[label] += (b - a) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}
