"""The port's five examples (lz4_flex_tpu_torch/examples/) against the JAX
package's (examples/), on the same stdin and arguments: each port
example's ``main`` on the CPU writes byte for byte what the JAX script
writes, run as a subprocess with ``JAX_PLATFORMS=cpu``. The JAX scripts all
start at once, when the module's first test asks for them. The host
examples also run as ``python -m``; ``device_pipeline`` run that way needs a
card and fails without one. Tolerance: exact."""

import io
import os
import subprocess
import sys

import pytest
import torch

from lz4_flex_tpu_torch import frame
from lz4_flex_tpu_torch.block import compress_prepend_size
from lz4_flex_tpu_torch.examples import (
    compress,
    compress_block,
    decompress,
    decompress_block,
    device_pipeline,
)

from .torch_inputs import word_soup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOUP = word_soup(300_000, seed=81)
SENTENCE = b"The quick brown fox jumps over the lazy dog. " * 2000  # the pipeline's default


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """Each JAX example's stdout, by (name, input label); the five scripts
    run in parallel."""
    tmp = tmp_path_factory.mktemp("examples")
    (tmp / "sentence.txt").write_bytes(SENTENCE)
    runs = {
        ("compress", "soup"): (SOUP, []),
        ("decompress", "soup"): (frame.compress(SOUP), []),
        ("compress_block", "soup"): (SOUP, []),
        ("decompress_block", "soup"): (compress_prepend_size(SOUP), []),
        ("device_pipeline", "sentence"): (b"", [str(tmp / "sentence.txt")]),
    }
    procs = {key: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", f"{key[0]}.py"), *args], cwd=REPO,
        env=_env(), stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for key, (_, args) in runs.items()}
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(runs[key][0], timeout=600)
            assert p.returncode == 0, (key, stderr.decode()[-2000:])
            out[key] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    out["sentence_file"] = str(tmp / "sentence.txt")
    return out


def _main(module, stdin: bytes = b"", argv=None, device=None) -> bytes:
    """``module.main`` with ``stdin`` on standard input; its standard output."""
    saved = sys.stdin, sys.stdout
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    out = io.BytesIO()
    sys.stdout = io.TextIOWrapper(out, write_through=True)
    try:
        assert module.main(argv, device=device) == 0
        sys.stdout.flush()
        return out.getvalue()
    finally:
        sys.stdin, sys.stdout = saved


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_compress_and_decompress_equal_jax(jax_outputs):
    f = _main(compress, SOUP)
    assert f == jax_outputs[("compress", "soup")]
    assert _main(decompress, f) == jax_outputs[("decompress", "soup")] == SOUP


def test_block_examples_equal_jax(jax_outputs):
    comp = _main(compress_block, SOUP)
    assert comp == jax_outputs[("compress_block", "soup")]
    assert _main(decompress_block, comp) == jax_outputs[("decompress_block", "soup")] == SOUP


@pytest.mark.parametrize("argv", ["file", "default"])
def test_device_pipeline_equals_jax(jax_outputs, argv):
    # the JAX script ran on a file holding the default input, so one line
    # checks both the file argument and the default
    want = jax_outputs[("device_pipeline", "sentence")]
    assert want.startswith(b"90000 -> ") and want.endswith(b"roundtrip OK\n")
    args = [jax_outputs["sentence_file"]] if argv == "file" else []
    assert _main(device_pipeline, argv=args, device="cpu") == want


def test_examples_run_as_modules():
    def run(name, stdin=b""):
        return subprocess.run([sys.executable, "-m", f"lz4_flex_tpu_torch.examples.{name}"],
                              input=stdin, capture_output=True, cwd=REPO, env=_env(), timeout=300)

    data = SOUP[:50_000]
    f = run("compress", data)
    assert f.returncode == 0 and frame.decompress(f.stdout) == data
    back = run("decompress", f.stdout)
    assert back.returncode == 0 and back.stdout == data
    b = run("compress_block", data)
    assert b.returncode == 0 and run("decompress_block", b.stdout).stdout == data
    if not torch.cuda.is_available():
        r = run("device_pipeline")
        assert r.returncode != 0 and b"CUDA" in r.stderr
