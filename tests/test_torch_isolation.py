"""The port stands alone: importing every module of it (the probes under
lz4_flex_tpu_torch/experiments included, and chip_smoke.py) loads neither
JAX nor the JAX package, its entry points never drop to the
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
    "lz4_flex_tpu_torch.cli",
    "lz4_flex_tpu_torch.examples",
    "lz4_flex_tpu_torch.examples.compress",
    "lz4_flex_tpu_torch.examples.compress_block",
    "lz4_flex_tpu_torch.examples.decompress",
    "lz4_flex_tpu_torch.examples.decompress_block",
    "lz4_flex_tpu_torch.examples.device_pipeline",
    "lz4_flex_tpu_torch.experiments",
    "lz4_flex_tpu_torch.experiments.fire_probe",
    "lz4_flex_tpu_torch.experiments.gather_probe",
    "lz4_flex_tpu_torch.experiments.plane_time",
    "lz4_flex_tpu_torch.frame",
    "lz4_flex_tpu_torch.frame.decoder",
    "lz4_flex_tpu_torch.frame.device",
    "lz4_flex_tpu_torch.frame.encoder",
    "lz4_flex_tpu_torch.frame.errors",
    "lz4_flex_tpu_torch.frame.header",
    "lz4_flex_tpu_torch.models",
    "lz4_flex_tpu_torch.models.codec",
    "lz4_flex_tpu_torch.native",
    "lz4_flex_tpu_torch.ops",
    "lz4_flex_tpu_torch.ops._kernels",
    "lz4_flex_tpu_torch.ops.decode",
    "lz4_flex_tpu_torch.ops.encode",
    "lz4_flex_tpu_torch.ops.expand2",
    "lz4_flex_tpu_torch.ops.packing",
    "lz4_flex_tpu_torch.ops.parse",
    "lz4_flex_tpu_torch.ops.ringdecode",
    "lz4_flex_tpu_torch.ops.sequences",
    "lz4_flex_tpu_torch.parallel",
    "lz4_flex_tpu_torch.parallel.executor",
    "lz4_flex_tpu_torch.parallel.mesh",
    "lz4_flex_tpu_torch.parallel.pipeline",
    "lz4_flex_tpu_torch.spec",
    "lz4_flex_tpu_torch.spec.constants",
    "lz4_flex_tpu_torch.spec.golden",
    "lz4_flex_tpu_torch.spec.xxhash32",
    "lz4_flex_tpu_torch.utils",
    "lz4_flex_tpu_torch.utils.checksum",
    "lz4_flex_tpu_torch.utils.trace",
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
    import io

    import numpy as np

    from lz4_flex_tpu import block, frame
    from lz4_flex_tpu_torch.examples import device_pipeline
    from lz4_flex_tpu_torch.frame import (
        BlockSize,
        FrameDecoder,
        FrameEncoder,
        FrameInfo,
        compress_frame_device,
        decompress_frame_device,
    )
    from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec
    from lz4_flex_tpu_torch.ops import encode as E
    from lz4_flex_tpu_torch.ops import ringdecode as R
    from lz4_flex_tpu_torch.ops.decode import decode_block_device, decode_parts_fused
    from lz4_flex_tpu_torch.ops.encode import compress_block_device, compress_block_hybrid
    from lz4_flex_tpu_torch.ops.parse import parse_sequences_device
    from lz4_flex_tpu_torch.parallel import codec_mesh, decode_blocks_sharded
    from lz4_flex_tpu_torch.parallel.pipeline import encode_blocks, encode_blocks_sharded

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = b"hello hello hello " * 100
    comp = block.compress(data)
    f = frame.compress(data)
    before = dict(R.stats), dict(E.stats)
    big = FrameInfo(block_size=BlockSize.Max1MB)
    for call in (
        lambda: decode_block_device(comp, len(data)),
        lambda: decompress_frame_device(f),
        lambda: LZ4Codec().decompress(f),
        lambda: LZ4Codec().decompress_block(comp, len(data)),
        lambda: R.decode_parts_ring([(comp, True)]),
        lambda: decode_block_device(comp, len(data), device="cuda"),
        lambda: decode_block_device(comp, len(data), parse="host"),
        lambda: decode_block_device(comp, len(data), parse="device"),
        lambda: decode_parts_fused([(comp, True)]),
        lambda: parse_sequences_device(comp),
        lambda: LZ4Codec().decode_step(np.frombuffer(comp + b"\0", np.uint8)[None], [len(comp)]),
        lambda: FrameDecoder(io.BytesIO(f), engine="device").read_all(),
        lambda: FrameEncoder(io.BytesIO(), big, engine="device").write(data),
        lambda: compress_block_hybrid(data),
        lambda: compress_block_hybrid(data, device="cuda"),
        lambda: compress_frame_device(data, big),
        lambda: encode_blocks(data, 1 << 20),
        lambda: LZ4Codec(CodecConfig(block_size=BlockSize.Max1MB)).compress(data),
        lambda: LZ4Codec().compress(data),
        lambda: compress_block_device(data),
        lambda: compress_block_device(data * 400, device="cuda"),
        lambda: LZ4Codec().compress_block(data),
        lambda: LZ4Codec().encode_step(np.zeros((2, 4096), np.uint8), [0, 0], [100, 0]),
        lambda: encode_blocks(data, 65536),
        lambda: compress_frame_device(data),
        lambda: FrameEncoder(io.BytesIO(), FrameInfo(block_size=BlockSize.Max256KB),
                             engine="device").write(data),
        lambda: codec_mesh(),
        lambda: encode_blocks_sharded(data, 65536),
        lambda: decode_blocks_sharded([comp], 65536),
        lambda: decompress_frame_device(f, mesh=["cuda:0"] * 2),
        lambda: LZ4Codec(mesh=["cuda"]).compress(data),
        lambda: device_pipeline.main([]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert (R.stats, E.stats) == before
    # the host engines need no card
    assert FrameDecoder(io.BytesIO(f)).read_all() == data


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
