"""The port's sharded encode (on the CPU) against the JAX package's, on the
same inputs, at N = 1, 2 and 8 (the mesh pairs of test_torch_mesh.py):
frames through a mesh in both block modes under ``compress_frame_device``
(a device ``FrameEncoder``), ``LZ4Codec`` and the device ``FrameDecoder``,
the linked carry, the one-entry hybrid route at ``_CHUNK_C`` and the 1 MiB
blocks whose route changes between N = 1 and N = 2. Every wire decodes back
through the host decoder. Tolerance: exact everywhere."""

import io

import pytest
import torch

from lz4_flex_tpu import block as JB
from lz4_flex_tpu.frame import BlockMode, BlockSize, FrameInfo
from lz4_flex_tpu.frame.device import compress_frame_device as jax_compress_frame
from lz4_flex_tpu.parallel import pipeline as JP
from lz4_flex_tpu_torch import frame
from lz4_flex_tpu_torch.frame.device import compress_frame_device, decompress_frame_device
from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec
from lz4_flex_tpu_torch.ops import encode as PE
from lz4_flex_tpu_torch.ops import ringdecode as R
from lz4_flex_tpu_torch.parallel import pipeline as PP

from .test_torch_mesh import BS, DATA, NS, _meshes
from .torch_inputs import word_soup


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pfi(**kw) -> frame.FrameInfo:
    return frame.FrameInfo(**{k: getattr(frame, type(v).__name__)[v.name]
                              if isinstance(v, (BlockMode, BlockSize)) else v
                              for k, v in kw.items()})


def _roundtrip(payloads, lens, data: bytes, linked: bool, skip: int = 0) -> None:
    """Every payload decodes by the JAX package's host decoder to its block
    of ``data[skip:]`` (a linked block with the 64 KiB before it as its
    dictionary)."""
    pos = skip
    for comp, blen in zip(payloads, lens):
        d = data[max(0, pos - 65536) : pos] if linked else b""
        assert JB.decompress_with_dict(comp, blen, d) == data[pos : pos + blen]
        pos += blen
    assert pos == len(data)


# -- encode ---------------------------------------------------------------------------


def _hybrid_calls() -> int:
    """The hybrid encoder's device dispatches so far (candidate planes of
    inputs under 512 KiB, plane quads of larger ones)."""
    return PE.stats["candidate_calls"] + PE.stats["plane_quads"]


@pytest.mark.parametrize("mode", [BlockMode.Independent, BlockMode.Linked])
@pytest.mark.parametrize("n", NS)
def test_frame_through_a_mesh_equals_jax(n, mode):
    # the sharded encode under compress_frame_device, FrameEncoder and
    # LZ4Codec; the independent frame decodes through the sharded decode
    data = word_soup(140000, seed=49)  # three blocks
    pm, jm = _meshes(n)
    linked = mode == BlockMode.Linked
    fi = dict(block_size=BlockSize.Max64KB, block_mode=mode, block_checksums=linked,
              content_checksum=linked)
    want = jax_compress_frame(data, FrameInfo(**fi), mesh=jm)
    if linked:  # a device FrameEncoder given all of data in one write
        assert compress_frame_device(data, _pfi(**fi), mesh=pm) == want
    else:
        assert LZ4Codec(CodecConfig(), pm).compress(data) == want
    assert frame.decompress(want) == data
    assert frame.FrameDecoder(io.BytesIO(want), engine="device", mesh=pm,
                              device="cpu").read_all() == data
    before = dict(R.stats)
    assert decompress_frame_device(want, mesh=pm) == data
    assert LZ4Codec(mesh=pm).decompress(want) == data
    assert R.stats["overflow_sharded_decodes"] == before["overflow_sharded_decodes"]


def test_encode_blocks_sharded_linked_carry_equals_jax():
    carry = word_soup(70000, seed=43)
    pm, jm = _meshes(8)
    got = PP.encode_blocks_sharded(DATA, BS, linked=True, mesh=pm, carry=carry)
    assert got == JP.encode_blocks_sharded(DATA, BS, linked=True, mesh=jm, carry=carry)
    payloads, lens = got
    _roundtrip(payloads, lens, carry[-65536:] + DATA, True, skip=min(len(carry), 65536))
    assert PP.encode_blocks(DATA, BS, linked=True, carry=carry, mesh=pm) == (
        payloads, lens, (carry + DATA)[-65536:])
    indep, _ = PP.encode_blocks_sharded(DATA, BS, mesh=pm)
    _roundtrip(indep, lens, DATA, False)
    assert sum(map(len, payloads)) <= sum(map(len, indep))  # linked is no larger


def test_encode_hybrid_route_on_one_entry_equals_jax():
    # a one-entry mesh sends chunk-scale blocks to the hybrid encoder
    data = word_soup(PE._CHUNK_C + 70000, seed=44)  # two blocks, the second short
    pm, jm = _meshes(1)
    for linked in (False, True):
        before = _hybrid_calls()
        payloads, lens = PP.encode_blocks_sharded(data, PE._CHUNK_C, linked=linked, mesh=pm)
        assert _hybrid_calls() > before
        assert len(payloads) == 2 and sum(lens) == len(data)
        assert (payloads, lens) == JP.encode_blocks_sharded(data, PE._CHUNK_C, linked=linked,
                                                            mesh=jm)
        _roundtrip(payloads, lens, data, linked)


def test_one_mib_blocks_change_route_with_the_mesh_size():
    # 1 MiB blocks: the hybrid encoder on one entry, compress_block_device
    # per block on more; each is JAX's bytes at its N, and the two differ.
    data = word_soup(600000, seed=45)
    fi = dict(block_size=BlockSize.Max1MB, content_checksum=True)
    got = {}
    for n in (1, 2):
        pm, jm = _meshes(n)
        before = _hybrid_calls(), PE.stats["match_calls"]
        got[n] = compress_frame_device(data, _pfi(**fi), mesh=pm)
        assert got[n] == jax_compress_frame(data, FrameInfo(**fi), mesh=jm)
        hybrid, matched = _hybrid_calls() > before[0], PE.stats["match_calls"] > before[1]
        assert (hybrid, matched) == ((True, False) if n == 1 else (False, True))
        assert frame.decompress(got[n]) == data
    assert got[1] != got[2]


# -- decode ---------------------------------------------------------------------------
