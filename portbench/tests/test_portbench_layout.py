"""Every configuration, mix, operation and metric is a file found by name,
and a new one is taken with no edit to a file that is there."""

import json
import os
import shutil
import time

import pytest

from conftest import CELLS, small_cell
from portbench import harness

BENCH = harness.load_benchmark()


def test_benchmark_names_the_cells():
    assert [w["name"] for w in harness.load_benchmark()["workloads"]] == CELLS
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "decode_MiBps", "encode_MiBps", "p95_ms", "compressed_pct", "setup_s"}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads_by_name(conf):
    with open(os.path.join(harness.ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    assert set(cfg["frame"]) == {"block_size", "block_mode", "block_checksums",
                                 "content_checksum", "content_size"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_its_mix_operation_and_metrics(name):
    cell = harness.load_cell(BENCH, name)
    op = harness.load_module("ops", cell.traffic["operation"])
    for fn in ("prepare", "weight", "call", "amounts", "check", "control"):
        assert callable(getattr(op, fn))
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for metric in cell.end_to_end + cell.per_layer:
        mod = harness.load_module("metrics", metric)
        assert mod.UNIT == units[metric] and callable(mod.read)
    moved = {m["moves"] for m in BENCH["per_layer"] if name in m["workloads"]}
    assert moved <= set(cell.end_to_end)


def test_every_metric_names_real_functions_of_the_port():
    import importlib
    import functools

    for m in BENCH["per_layer"]:
        for key in getattr(harness.load_module("metrics", m["name"]), "SPANS", ()):
            modname, qual = key.split(":")
            assert callable(functools.reduce(getattr, qual.split("."), importlib.import_module(modname)))


def test_new_files_are_taken_with_no_edit(tmp_path, monkeypatch):
    """A copy of the benchmark plus one new configuration, mix, metric and
    cell, all as new files and entries: the harness runs the new cell and
    reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(os.path.join(harness.ROOT, "portbench/configs/lz4f-64k.json")))
    cfg.update(name="lz4f-256k")
    cfg["frame"]["block_size"] = 256 * 1024
    (root / "portbench/configs/lz4f-256k.json").write_text(json.dumps(cfg))
    mix = small_cell("lz4f-64k.decode").traffic
    (root / "portbench/traffic/decode_small.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/dec.requests.py").write_text(
        'UNIT = "requests"\n\n\ndef read(w):\n    return w.n\n')
    bench["configs"].append({"name": "lz4f-256k", "source": "https://example.org/x",
                             "file": "portbench/configs/lz4f-256k.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "lz4f-256k.decode", "config": "lz4f-256k",
                               "traffic": "decode_small", "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "dec.requests", "unit": "requests", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["lz4f-256k.decode"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", str(root / "portbench"))
    monkeypatch.setattr(harness, "ROOT", str(root))
    cell = harness.load_cell(harness.load_benchmark(), "lz4f-256k.decode")
    assert cell.config["frame"]["block_size"] == 256 * 1024
    r = harness.execute(cell, 5, 0.3, False, "cpu", time.perf_counter(), log=lambda m: None)
    assert r["correct"] and r["metrics"]["dec.requests"]["value"] == r["attempted"]
