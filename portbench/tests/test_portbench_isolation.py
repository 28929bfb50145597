"""What the benchmark runs loads neither ``jax`` nor the JAX package, and
the reference loads nothing of the port; top-level names compared whole."""

import json
import os
import subprocess
import sys

from conftest import ROOT
from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "lz4_flex_tpu"}


def _top_level(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """run.py's imports, every operation and metric module, and a short run
    of each cell on the CPU."""
    mods = _top_level(
        "import sys, time; sys.path.insert(0, 'portbench/tests'); sys.argv = ['x']\n"
        "import portbench.run\n"
        "from conftest import CELLS, small_cell\n"
        "from portbench import harness\n"
        "import glob, os\n"
        "[harness.load_module(k, os.path.basename(p)[:-3]) for k in ('ops', 'metrics')"
        " for p in glob.glob(os.path.join(harness.HERE, k, '[!_]*.py'))]\n"
        "[harness.execute(small_cell(c), 3, 0.2, t, 'cpu', time.perf_counter(), log=lambda m: None)"
        " for c in CELLS for t in (False, True)]\n")
    assert "lz4_flex_tpu_torch" in mods and "portbench" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_level("from portbench.reference import lz4_ref\nfrom portbench.gen import frozen, text\n"
                      "frozen.frame(text.zipf_text(1, 100000), block_size=65536)\n")
    assert not mods & (FORBIDDEN | {"lz4_flex_tpu_torch", "torch"})


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lz4_flex_tpu_torch_extra", sys)
    assert not [m for m in harness.forbidden_modules() if m.startswith("lz4_flex_tpu_torch")]
    monkeypatch.setitem(sys.modules, "lz4_flex_tpu.frame", sys)
    assert "lz4_flex_tpu.frame" in harness.forbidden_modules()
