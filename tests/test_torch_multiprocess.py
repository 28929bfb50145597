"""Multi-process meshes on the CPU: two gloo processes (tests/torch_mp_worker.py),
each with a mesh of two ``cpu`` entries, so a global mesh of 4.

Every case is held byte for byte to the JAX package on its 4-device
virtual CPU mesh (tests/conftest.py) and to the port in one process at
N = 4: the routing and so the bytes depend only on the global entry count.
The cases: the sharded encode (independent, and linked with a carry),
``roundtrip_step_sharded``, the ring decode (one grouped launch a process),
its resident route when one rank's plans overflow (both ranks take it), the
frame entry points and ``LZ4Codec`` with ``mesh=``, a malformed block on
one rank (the same error type on both, on the ring and the resident route),
unequal entry counts (ValueError on both) and ``fetch_global``.

One module-scoped pair of workers runs every case once, in order, and each
test reads its case's outcome. The workers have a hard deadline: a hang
kills them and fails the tests whose cases did not finish, within this
module's own time. Tolerance: exact everywhere."""

import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from lz4_flex_tpu.block import errors as JBE
from lz4_flex_tpu.frame import BlockSize, FrameInfo
from lz4_flex_tpu.frame.device import compress_frame_device as jax_compress_frame
from lz4_flex_tpu.parallel import pipeline as JP
from lz4_flex_tpu.parallel.mesh import codec_mesh as jax_codec_mesh
from lz4_flex_tpu_torch import frame, native
from lz4_flex_tpu_torch.block import errors as PBE
from lz4_flex_tpu_torch.frame import FrameInfo as PortFrameInfo
from lz4_flex_tpu_torch.frame import BlockMode as PortBlockMode
from lz4_flex_tpu_torch.frame.device import compress_frame_device
from lz4_flex_tpu_torch.parallel import pipeline as PP

from . import torch_mp_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
DEADLINE_S = 300  # both workers, every case; alone they take ~10 s


class _Workers:
    """The two worker processes, started at once; :meth:`results` waits for
    them until the deadline, then kills what is left."""

    def __init__(self, out_dir) -> None:
        with socket.socket() as s:  # a free port, never a fixed one
            s.bind(("127.0.0.1", 0))
            address = f"127.0.0.1:{s.getsockname()[1]}"
        self.out_dir = str(out_dir)
        env = dict(os.environ, PYTHONPATH=REPO)
        self.procs = [
            subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_mp_worker.py"),
                              address, str(r), str(WORLD), self.out_dir],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(WORLD)]
        self.deadline = time.monotonic() + DEADLINE_S
        self._results = None
        self.logs = []

    def results(self) -> list[dict]:
        if self._results is None:
            for p in self.procs:
                try:
                    out, _ = p.communicate(timeout=max(1.0, self.deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    self.close()
                    out, _ = p.communicate()
                self.logs.append(f"rc {p.returncode}: {out.decode(errors='replace')[-3000:]}")
            self._results = []
            for r in range(WORLD):
                path = os.path.join(self.out_dir, f"rank{r}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        self._results.append(pickle.load(f))
                else:
                    self._results.append({})
        return self._results

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=30)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    native._lib()  # built here once, not by both workers
    w = _Workers(tmp_path_factory.mktemp("mp"))
    yield w
    w.close()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcomes(workers, case: str) -> list:
    """Each rank's outcome of ``case``; fails when a rank never finished it."""
    res = workers.results()
    for r in range(WORLD):
        assert case in res[r], f"rank {r} did not finish {case!r}: {workers.logs}"
    return [res[r][case] for r in range(WORLD)]


def _values(workers, case: str) -> list:
    outs = _outcomes(workers, case)
    for r, o in enumerate(outs):
        assert o[0] == "ok", f"rank {r} raised in {case!r}: {o}"
    return [o[1] for o in outs]


def _jax_mesh():
    return jax_codec_mesh(jax.devices()[: 2 * W.LOCAL])


PORT_MESH = ["cpu"] * (2 * W.LOCAL)  # the port in one process, the same global count


def _dec_blocks() -> list[bytes]:
    return [W.DEC_DATA[i : i + W.DEC_BS] for i in range(0, len(W.DEC_DATA), W.DEC_BS)]


# -- encode ---------------------------------------------------------------------------


@pytest.mark.parametrize("linked", [False, True], ids=["independent", "linked"])
def test_encode_blocks_sharded_across_processes(workers, linked):
    kw = dict(linked=True, carry=W.CARRY) if linked else {}
    want = JP.encode_blocks_sharded(W.ENC_DATA, W.ENC_BS, mesh=_jax_mesh(), **kw)
    assert PP.encode_blocks_sharded(W.ENC_DATA, W.ENC_BS, mesh=PORT_MESH, **kw) == want
    case = "encode_linked" if linked else "encode_independent"
    for got in _values(workers, case):
        assert got == want


def test_roundtrip_step_sharded_across_processes(workers):
    want = [np.asarray(a) for a in JP.roundtrip_step_sharded(W.ENC_DATA, W.ENC_BS, mesh=_jax_mesh())]
    single = [t.numpy() for t in PP.roundtrip_step_sharded(W.ENC_DATA, W.ENC_BS, mesh=PORT_MESH)]
    assert bool(want[3]) and bool(single[3])
    for got in [single, *_values(workers, "roundtrip_step")]:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# -- decode ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_decoded():
    """JAX's decode of the decode cases' payloads on its 4-device mesh (the
    data; its resident route gives the same bytes, test_torch_mesh.py)."""
    want = JP.decode_blocks_sharded(W.dec_payloads(), W.DEC_BS, mesh=_jax_mesh())
    assert want == _dec_blocks()
    return want


def test_ring_decode_across_processes(workers, jax_decoded):
    want = jax_decoded
    assert PP.decode_blocks_sharded(W.dec_payloads(), W.DEC_BS, mesh=PORT_MESH) == want
    for got in _values(workers, "ring_decode"):
        assert got["out"] == want
        assert got["grouped_calls"] == [W.LOCAL]  # one launch a process, its two plans
        assert got["overflows"] == 0


def test_overflow_on_one_rank_sends_every_rank_to_the_resident_decoder(workers, jax_decoded):
    # rank 1's plans overflow; rank 0's fit, yet it launches nothing and
    # both decode through the resident decoder, JAX's route on an overflow
    assert PP._decode_blocks_sharded_resident(W.dec_payloads(), W.DEC_BS,
                                              mesh=PORT_MESH) == jax_decoded
    for got in _values(workers, "overflow_on_one_rank"):
        assert got["out"] == jax_decoded
        assert got["grouped_calls"] == []
        assert got["overflows"] == 1


@pytest.mark.parametrize("case", ["malformed_ring", "malformed_resident"])
def test_malformed_block_on_one_rank_raises_the_same_error_on_every_rank(workers, case):
    # JAX's ring route raises the type in its host plan build, and its
    # resident route raises the same (test_torch_mesh.py holds both routes
    # of the port to JAX's in one process)
    with pytest.raises(JBE.OffsetOutOfBounds):
        JP.decode_blocks_sharded(W.bad_payloads(), W.DEC_BS, mesh=_jax_mesh())
    with pytest.raises(PBE.OffsetOutOfBounds):
        PP.decode_blocks_sharded(W.bad_payloads(), W.DEC_BS, mesh=PORT_MESH)
    for outcome in _outcomes(workers, case):
        assert outcome[:2] == ("raised", JBE.OffsetOutOfBounds.__name__)


def test_unequal_entry_counts_raise_on_every_rank(workers):
    for outcome in _outcomes(workers, "unequal_entries"):
        assert outcome[:2] == ("raised", "ValueError")
        assert "[2, 3]" in outcome[2]


# -- frame layer and gathers ----------------------------------------------------------------


def test_frame_entry_points_with_a_mesh_across_processes(workers):
    jm = _jax_mesh()
    fi = dict(block_size=BlockSize.Max64KB, content_checksum=True)  # W.FRAME_INFO in JAX's types
    want = jax_compress_frame(W.FRAME_DATA, FrameInfo(**fi), mesh=jm)
    assert compress_frame_device(W.FRAME_DATA, PortFrameInfo(**W.FRAME_INFO), mesh=PORT_MESH) == want
    # the linked frame against the port's one process (JAX's linked bytes at
    # a global N = 4 are held by the encode_linked case)
    want_linked = compress_frame_device(
        W.FRAME_DATA, PortFrameInfo(block_mode=PortBlockMode.Linked, **W.FRAME_INFO), mesh=PORT_MESH)
    assert frame.decompress(want_linked) == W.FRAME_DATA
    for got in _values(workers, "frames"):
        assert got["frame"] == want and got["codec"] == want
        assert got["linked"] == want_linked
        assert got["back"] == W.FRAME_DATA and got["codec_back"] == W.FRAME_DATA


def test_fetch_global_gathers_every_process(workers):
    want = np.concatenate([np.full((2, 3), 10 * r + d, np.int32)
                           for r in range(WORLD) for d in range(W.LOCAL)])
    for got in _values(workers, "fetch_global"):
        np.testing.assert_array_equal(got, want)
