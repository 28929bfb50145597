"""The port stands alone: importing every module of it (and chip_smoke.py)
loads neither JAX nor the JAX package, its entry points never drop to the
CPU on their own, and chip_smoke.py fails without a card."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "lz4_flex_tpu_torch",
    "lz4_flex_tpu_torch.block",
    "lz4_flex_tpu_torch.block.errors",
    "lz4_flex_tpu_torch.frame",
    "lz4_flex_tpu_torch.frame.device",
    "lz4_flex_tpu_torch.frame.errors",
    "lz4_flex_tpu_torch.frame.header",
    "lz4_flex_tpu_torch.models",
    "lz4_flex_tpu_torch.models.codec",
    "lz4_flex_tpu_torch.native",
    "lz4_flex_tpu_torch.ops",
    "lz4_flex_tpu_torch.ops._kernels",
    "lz4_flex_tpu_torch.ops.decode",
    "lz4_flex_tpu_torch.ops.ringdecode",
    "lz4_flex_tpu_torch.spec",
    "lz4_flex_tpu_torch.spec.constants",
    "lz4_flex_tpu_torch.utils",
    "lz4_flex_tpu_torch.utils.checksum",
    "chip_smoke",
]

_PROBE = """
import importlib, sys
for m in {mods!r}:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "lz4_flex_tpu" or m.startswith("lz4_flex_tpu."))
print("LOADED", bad)
"""


def _run(argv, cwd: str = REPO):
    env = dict(os.environ, PYTHONPATH=REPO if cwd == REPO else "")
    return subprocess.run(argv, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_port_imports_neither_jax_nor_the_jax_package():
    r = _run([sys.executable, "-c", _PROBE.format(mods=PORT_MODULES)])
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_every_port_module_is_listed():
    found = []
    root = os.path.join(REPO, "lz4_flex_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), REPO)[:-3].replace(os.sep, ".")
                found.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    assert sorted(found) == sorted(m for m in PORT_MODULES if m != "chip_smoke")


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    from lz4_flex_tpu import block, frame
    from lz4_flex_tpu_torch.frame import decompress_frame_device
    from lz4_flex_tpu_torch.models import LZ4Codec
    from lz4_flex_tpu_torch.ops import ringdecode as R
    from lz4_flex_tpu_torch.ops.decode import decode_block_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = b"hello hello hello " * 100
    comp = block.compress(data)
    f = frame.compress(data)
    before = dict(R.stats)
    for call in (
        lambda: decode_block_device(comp, len(data)),
        lambda: decompress_frame_device(f),
        lambda: LZ4Codec().decompress(f),
        lambda: LZ4Codec().decompress_block(comp, len(data)),
        lambda: R.decode_parts_ring([(comp, True)]),
        lambda: decode_block_device(comp, len(data), device="cuda"),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert R.stats == before


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run in full")
    r = _run([sys.executable, os.path.join(REPO, "chip_smoke.py")])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory, without the package beside it, it fails too
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    r = _run([sys.executable, str(lone)], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
