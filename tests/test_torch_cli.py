"""The port's CLI (``python -m lz4_flex_tpu_torch.cli``) against the JAX
package's, on inputs made in the repo: the seven scenarios of
tests/test_cli.py (file and stdin/stdout modes, extension autodetection,
``-o``/``--clean``, linked mode with checksums, legacy frames, the device
engine), each compressed file byte-equal to the JAX CLI's. The device
engine runs here on the CPU through the copy helpers (``device="cpu"``);
from the command line it needs the card and fails without one."""

import io
import os
import subprocess
import sys

import pytest
import torch

from lz4_flex_tpu import cli as jax_cli
from lz4_flex_tpu.frame import FrameInfo as JFrameInfo
from lz4_flex_tpu_torch import cli
from lz4_flex_tpu_torch.frame import FrameInfo

from .torch_inputs import word_soup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_34K = word_soup(34000, seed=71)
TEXT_1K = word_soup(1000, seed=72)
TEXT_65K = word_soup(65000, seed=73)


def _jax_file(tmp_path, data: bytes, *args) -> bytes:
    """The JAX CLI's output for ``data`` under ``args`` (a file mode run)."""
    d = tmp_path / "jax"
    d.mkdir(exist_ok=True)
    src, out = d / "in.bin", d / "out.lz4"
    src.write_bytes(data)
    assert jax_cli.main([str(src), "-f", "-o", str(out), *args]) == 0
    return out.read_bytes()


def test_file_roundtrip(tmp_path):
    src = tmp_path / "data.txt"
    src.write_bytes(TEXT_34K)
    assert cli.main([str(src), "-f"]) == 0
    comp = tmp_path / "data.txt.lz4"
    assert comp.read_bytes() == _jax_file(tmp_path, TEXT_34K)
    src.unlink()
    assert cli.main([str(comp), "-f"]) == 0  # .lz4 => decompress
    assert (tmp_path / "data.txt").read_bytes() == TEXT_34K


def test_file_explicit_out_and_clean(tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(TEXT_1K)
    out = tmp_path / "out.lz4"
    assert cli.main([str(src), "-o", str(out), "--clean"]) == 0
    assert not src.exists()
    assert out.read_bytes() == _jax_file(tmp_path, TEXT_1K)
    dec = tmp_path / "roundtrip.bin"
    assert cli.main([str(out), "-d", "-o", str(dec)]) == 0
    assert dec.read_bytes() == TEXT_1K


def test_decompress_needs_lz4_ext_or_out(tmp_path):
    src = tmp_path / "noext"
    src.write_bytes(b"x")
    assert cli.main([str(src), "-d"]) == 1


def test_linked_mode_and_checksums(tmp_path):
    data = TEXT_65K * 4
    src = tmp_path / "data.bin"
    src.write_bytes(data)
    out = tmp_path / "data.lz4"
    args = ["--mode", "linked", "--block-size", "Max64KB", "--block-checksums",
            "--content-checksum"]
    assert cli.main([str(src), "-o", str(out), *args]) == 0
    assert out.read_bytes() == _jax_file(tmp_path, data, *args)
    dec = tmp_path / "back.bin"
    assert cli.main([str(out), "-d", "-o", str(dec)]) == 0
    assert dec.read_bytes() == data


def test_stdin_stdout_pipe():
    env = dict(os.environ, PYTHONPATH=REPO)
    run = [sys.executable, "-m", "lz4_flex_tpu_torch.cli"]
    comp = subprocess.run(run, input=TEXT_34K, capture_output=True, check=True, cwd=REPO,
                          env=env, timeout=120).stdout
    assert len(comp) < len(TEXT_34K)
    want = io.BytesIO()
    jax_cli._copy_compress(io.BytesIO(TEXT_34K), want, JFrameInfo())  # the JAX CLI's stdin mode
    assert comp == want.getvalue()
    back = subprocess.run(run + ["-d"], input=comp, capture_output=True, check=True, cwd=REPO,
                          env=env, timeout=120).stdout
    assert back == TEXT_34K


def test_legacy_flag(tmp_path):
    src = tmp_path / "leg.bin"
    src.write_bytes(TEXT_1K)
    out = tmp_path / "leg.lz4"
    assert cli.main([str(src), "-o", str(out), "--legacy"]) == 0
    assert out.read_bytes()[:4] == bytes.fromhex("02214c18")
    assert out.read_bytes() == _jax_file(tmp_path, TEXT_1K, "--legacy")
    dec = tmp_path / "leg.out"
    assert cli.main([str(out), "-d", "-o", str(dec)]) == 0
    assert dec.read_bytes() == TEXT_1K


def test_device_engine_roundtrip(tmp_path):
    # The copy helpers the CLI's --engine device runs, on the CPU: the same
    # bytes as the JAX CLI's device engine, decoded back by the device and
    # the host engines.
    comp = io.BytesIO()
    n_in, n_out = cli._copy_compress(io.BytesIO(TEXT_34K), comp, FrameInfo(), "device",
                                     device="cpu")
    assert (n_in, n_out) == (len(TEXT_34K), len(comp.getvalue()))
    want = io.BytesIO()
    jax_cli._copy_compress(io.BytesIO(TEXT_34K), want, JFrameInfo(), "device")
    assert comp.getvalue() == want.getvalue()
    f = tmp_path / "d.txt.lz4"
    f.write_bytes(comp.getvalue())
    back = io.BytesIO()
    with open(f, "rb") as src:
        assert cli._copy_decompress(src, back, "device", device="cpu") == len(TEXT_34K)
    assert back.getvalue() == TEXT_34K
    out2 = tmp_path / "d2.out"  # cross-engine: the host engine reads the device-written file
    assert cli.main([str(f), "-f", "-o", str(out2)]) == 0
    assert out2.read_bytes() == TEXT_34K


def test_device_engine_fails_without_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "d.txt"
    src.write_bytes(TEXT_1K)
    assert cli.main([str(src), "-f", "--engine", "device"]) == 1
    assert not (tmp_path / "d.txt.lz4").exists()
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        cli._copy_compress(io.BytesIO(TEXT_1K), io.BytesIO(), FrameInfo(), "device")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli._copy_decompress(io.BytesIO(b""), io.BytesIO(), "device")
