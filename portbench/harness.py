"""The benchmark's driver: one cell, one seed, one measured window.

Everything that belongs to one configuration, traffic mix, operation or
metric sits in a file of its own, found by name:

  BENCHMARK.json                    the cells: (configuration, traffic) pairs
  portbench/configs/<config>.json   frame settings, source, assumed, reduced
  portbench/traffic/<mix>.json      operation, sizes, pool, loop, check sample
  portbench/ops/<operation>.py      how a request is made, called and judged
  portbench/metrics/<metric>.py     one metric: the spans it wraps, its arithmetic

A run: make the data from the seed, warm the cell's shapes, measure a closed
loop of one caller for ``--seconds`` (with ``--trace 1``: a shorter traced
window under ``torch.profiler``, spans wrapped around the port's functions),
read the device's peak memory, judge the kept answers against the inputs,
print the result line. Nothing here imports the JAX package or ``jax``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from . import spans as span_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MIB = 1 << 20

#: Published HBM bandwidth by card name (NVIDIA's H100 SXM data sheet: 3.35
#: TB/s at the full 700 W). A card not listed gets no roofline share.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

#: Modules whose presence in ``sys.modules`` after the window fails a run,
#: compared by whole top-level name (the port's name begins with the JAX
#: package's).
FORBIDDEN_TOP_LEVEL = {"jax", "jaxlib", "flax", "lz4_flex_tpu"}


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration, traffic mix and
    the metrics it reports."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    return Cell(name, entry["chips"], config, load_json("traffic", entry["traffic"]),
                [m["name"] for m in bench["end_to_end"] if _applies(m, name)],
                [m["name"] for m in bench["per_layer"] if _applies(m, name)])


class Context:
    """What an operation module needs: the configuration, the traffic mix,
    the seed's random streams, the device and the port's codec."""

    def __init__(self, config: dict, traffic: dict, seed: int, device) -> None:
        import torch

        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self._text = None
        self.rng = np.random.default_rng([self.seed, 1])  # offsets and block choices
        self.codec = make_codec(config, self.device)

    def text(self) -> np.ndarray:
        """The run's base text (uint8), made once from the seed."""
        if self._text is None:
            from .gen.text import zipf_text

            t = self.traffic["text"]
            if t["kind"] != "zipf":
                raise ValueError(f"unknown text kind {t['kind']!r}")
            self._text = zipf_text(self.seed, t["base_bytes"], vocab=t["vocab"],
                                   exponent=t["exponent"], word_len=t["word_len"])
        return self._text

    def pool_sizes(self) -> list[int]:
        """The pool's request sizes: the same set for every seed."""
        from .gen.text import log_uniform_sizes

        s = self.traffic["sizes"]
        if s["dist"] != "log_uniform":
            raise ValueError(f"unknown size distribution {s['dist']!r}")
        return log_uniform_sizes(self.traffic["pool"], s["min"], s["max"])

    def slice_of_text(self, n: int) -> np.ndarray:
        """``n`` bytes of the base text at an offset drawn from the seed."""
        text = self.text()
        off = int(self.rng.integers(0, text.size - n + 1))
        return text[off : off + n]

    def frame_args(self) -> dict:
        """The configuration's frame settings as the frozen encoder takes them."""
        f = self.config["frame"]
        if f["block_mode"] != "independent":
            raise ValueError("the frozen encoder writes independent frames only")
        return dict(block_size=f["block_size"], block_checksums=f["block_checksums"],
                    content_checksum=f["content_checksum"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


def make_codec(config: dict, device):
    """The port's ``LZ4Codec`` with the configuration's frame settings."""
    from lz4_flex_tpu_torch.frame.header import BlockMode, BlockSize
    from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec

    f = config["frame"]
    if f["content_size"]:
        raise ValueError("content size in the header is not a codec setting")
    sizes = {BlockSize(i).get_size(): BlockSize(i) for i in (4, 5, 6, 7)}
    cfg = CodecConfig(block_size=sizes[f["block_size"]],
                      block_mode=BlockMode(f["block_mode"]),
                      block_checksums=f["block_checksums"],
                      content_checksum=f["content_checksum"],
                      verify=config["device_encoder_verify"])
    return LZ4Codec(cfg, device=None if device.type == "cuda" else device)


@dataclass
class Window:
    """One measured window, as the metric readers see it."""

    seconds: float
    setup_s: float
    latencies_s: list = field(default_factory=list)
    in_bytes: list = field(default_factory=list)
    out_bytes: list = field(default_factory=list)
    stats: dict = field(default_factory=dict)
    trace: object = None  # spans.TraceView with --trace 1
    peak_bytes_per_s: float | None = None

    @property
    def n(self) -> int:
        return len(self.latencies_s)

    def host_ms(self, keys) -> float:
        """Host milliseconds in which any span of ``keys`` ran (their union
        over every thread)."""
        return self.trace.host_ms(keys) if self.trace else 0.0

    def device_ms(self, keys) -> float:
        """Device milliseconds (union) of every operation launched inside a
        span of ``keys``."""
        return self.trace.device_ms(keys) if self.trace else 0.0

    def kernels(self, keys) -> int:
        return self.trace.kernels(keys) if self.trace else 0

    def idle_pct(self) -> float | None:
        """100 less the share of the traced window in which any device
        operation ran; None without a trace or device time."""
        t = self.trace
        if t is None or t.window_s <= 0 or t.busy_s <= 0:
            return None
        return 100.0 * (1.0 - t.busy_s / t.window_s)

    def roofline_pct(self, nbytes: float, keys) -> float | None:
        """``nbytes`` over the card's peak bandwidth, as a share of the device
        time of the operations launched inside ``keys``' spans; None where
        no device time or no peak was read."""
        dev_s = self.device_ms(keys) / 1e3
        if dev_s <= 0 or not self.peak_bytes_per_s:
            return None
        return 100.0 * nbytes / self.peak_bytes_per_s / dev_s


def _counters() -> dict:
    from lz4_flex_tpu_torch.ops import encode, ringdecode

    return {**{f"ringdecode.{k}": v for k, v in ringdecode.stats.items()},
            **{f"encode.{k}": v for k, v in encode.stats.items()}}


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
            log=print) -> dict:
    """Run one cell; return the result line (a dict) and print the counters
    and the compared numbers to ``log``. ``device`` is ``"cuda"`` on the card
    (tests pass ``"cpu"``)."""
    import torch

    if cell.traffic["loop"] != {"kind": "closed", "callers": 1}:
        raise ValueError("the harness drives a closed loop of one caller")
    op = load_module("ops", cell.traffic["operation"])
    readers = {m: load_module("metrics", m) for m in (cell.per_layer if trace else cell.end_to_end)}
    t_prep = time.perf_counter()
    ctx = Context(cell.config, cell.traffic, seed, device)
    pool = op.prepare(ctx)
    t_warm = time.perf_counter()
    order = np.random.default_rng([ctx.seed, 2]).permutation(len(pool))
    sample = set(int(i) for i in order[: cell.traffic["check"]["sample"]])

    spans = None
    if trace:
        spans = span_mod.Spans(sorted({k for r in readers.values() for k in getattr(r, "SPANS", ())}))
    # Warm the cell's shapes: its largest request first, so the allocator
    # holds the largest blocks, then the first requests of the order.
    largest = max(range(len(pool)), key=lambda i: op.weight(pool[i]))
    for i in [largest] + [int(j) for j in order[: cell.traffic["warmup"]]]:
        op.call(ctx, pool[i])
    ctx.sync()
    gc.collect()
    log(f"set-up: imports {t_prep - t0:.2f} s, data {t_warm - t_prep:.2f} s, "
        f"warm-up {time.perf_counter() - t_warm:.2f} s")

    window_s = min(seconds, cell.traffic["trace_seconds"]) if trace else seconds
    w = Window(seconds=0.0, setup_s=time.perf_counter() - t0)
    kept, failed, first_error = {}, 0, None
    before = _counters()
    if spans:
        spans.start()
    start = time.perf_counter()
    deadline = start + window_s
    k = 0
    while time.perf_counter() < deadline:
        i = int(order[k % len(order)])
        k += 1
        item = pool[i]
        t_req = time.perf_counter()
        try:
            with span_mod.request(spans):
                res = op.call(ctx, item)
        except Exception as e:  # a request that raises is failed, and the loop goes on
            failed += 1
            first_error = first_error or repr(e)
            continue
        w.latencies_s.append(time.perf_counter() - t_req)
        nin, nout = op.amounts(item, res)
        w.in_bytes.append(nin)
        w.out_bytes.append(nout)
        if i in sample:
            kept[i] = res
    w.seconds = time.perf_counter() - start
    if spans:
        t_read = time.perf_counter()
        w.trace = spans.stop()
        log(f"trace: {len(w.trace._ops)} device operations in the window, "
            f"{w.trace.unattributed} not attributed to any span, read in "
            f"{time.perf_counter() - t_read:.1f} s")
    after = _counters()
    w.stats = {key: after[key] - before[key] for key in after}

    dev = ctx.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    w.peak_bytes_per_s = PEAK_BYTES_PER_S.get(kind)
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(w)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": reader.UNIT}

    attempted = w.n + failed
    if w.n:
        lat = np.array(w.latencies_s) * 1e3
        half = np.searchsorted(np.cumsum(w.latencies_s), w.seconds / 2)
        rate = lambda sl: sum(w.out_bytes[sl]) / MIB / max(sum(w.latencies_s[sl]), 1e-9)
        log(f"requests: {w.n} in {w.seconds:.3f} s; latency ms median {np.median(lat):.3f}, "
            f"p95 {np.percentile(lat, 95):.3f}, max {lat.max():.3f}; output MiB/s busy "
            f"first half {rate(slice(0, half)):.1f}, second half {rate(slice(half, None)):.1f}")
    log(f"counters over the window: {json.dumps(w.stats)}")
    if first_error:
        log(f"first failed request: {first_error}")
    checks = {"failed": (failed, 0)}
    checks.update(op.check(ctx, pool, kept, w))
    checks["compared"] = (len(kept), None)
    correct = attempted > 0 and len(kept) > 0 and all(
        lim is None or v <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and w.trace is not None:
        device_info["busy_s"] = w.trace.busy_s
        device_info["window_s"] = w.trace.window_s
        result["breakdown"] = w.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_TOP_LEVEL)


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(args, t0: float) -> int:
    """The command line's run: exits 2 without the cards the cell asks for,
    3 when a forbidden module was loaded; prints the result line last."""
    import torch

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    torch.set_num_threads(1)  # as OMP_NUM_THREADS, which run.py sets
    cell = load_cell(load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    log(f"card: {power_limit()}; roofline peak {PEAK_BYTES_PER_S.get(result['device']['kind'])} B/s")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {'none' if c['limit'] is None else c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
