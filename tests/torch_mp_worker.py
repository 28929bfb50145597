"""One rank of the two-process CPU mesh that tests/test_torch_multiprocess.py
drives: ``python tests/torch_mp_worker.py ADDRESS RANK WORLD OUT_DIR``.

It joins a gloo group through ``parallel.distributed_init``, runs every case
of CASES in order on a mesh of two ``cpu`` entries (a global mesh of 4), and
after each case rewrites ``OUT_DIR/rank<RANK>.pkl`` with every outcome so
far: ("ok", value) or ("raised", exception class name, message). Its inputs
come from tests/torch_inputs.py, so both ranks and the test agree on them.
Imports neither JAX nor the JAX package."""

from __future__ import annotations

import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lz4_flex_tpu_torch import block, native  # noqa: E402
from lz4_flex_tpu_torch.frame import BlockMode, BlockSize, FrameInfo  # noqa: E402
from lz4_flex_tpu_torch.frame.device import (  # noqa: E402
    compress_frame_device,
    decompress_frame_device,
)
from lz4_flex_tpu_torch.models import CodecConfig, LZ4Codec  # noqa: E402
from lz4_flex_tpu_torch.ops import ringdecode as R  # noqa: E402
from lz4_flex_tpu_torch.parallel import distributed_init, fetch_global  # noqa: E402
from lz4_flex_tpu_torch.parallel import pipeline as PP  # noqa: E402
from tests.torch_inputs import word_soup  # noqa: E402

LOCAL = 2  # mesh entries a process
ENC_BS = 4096
ENC_DATA = word_soup(40000, seed=42)  # 10 blocks over 4 global entries
CARRY = word_soup(70000, seed=52)  # linked-mode window context before ENC_DATA
DEC_BS = 65536
DEC_DATA = word_soup(8 * 65536 - 1000, seed=47)  # 8 blocks: 2 a global entry
# a match reaching before the block's start: OffsetOutOfBounds
BAD_BLOCK = bytes([0x10, 0x41, 100, 0, 0x00])
BAD_INDEX = 5  # in global group 2, which rank 1 holds
FRAME_DATA = word_soup(300000, seed=43)
FRAME_INFO = dict(block_size=BlockSize.Max64KB, content_checksum=True)


def dec_payloads() -> list[bytes]:
    return [block.compress(DEC_DATA[i : i + DEC_BS]) for i in range(0, len(DEC_DATA), DEC_BS)]


def bad_payloads() -> list[bytes]:
    p = dec_payloads()
    p[BAD_INDEX] = BAD_BLOCK
    return p


def tiny_ladder():
    """A one-step NFMAX ladder: every plan of two 64 KiB blocks of
    DEC_DATA overflows."""
    R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0] = (1,), 1, 1


def _counted_decode(payloads, rank: int, *, overflow_on):
    """decode_blocks_sharded on the mesh, with the grouped kernel's calls
    and the overflow counter of this rank; ``overflow_on`` are the ranks
    that force their plans to overflow."""
    saved = R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0], R.ring_decode_grouped
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return saved[3](*a, **kw)

    R.ring_decode_grouped = counted
    if rank in overflow_on:
        tiny_ladder()
    before = R.stats["overflow_sharded_decodes"]
    try:
        out = PP.decode_blocks_sharded(payloads, DEC_BS, mesh=["cpu"] * LOCAL)
    finally:
        R.NFMAX_STEPS, R.NFMAX_RETRY, R._nfmax_hint[0], R.ring_decode_grouped = saved
    return dict(out=out, grouped_calls=calls,
                overflows=R.stats["overflow_sharded_decodes"] - before)


def _frames(rank: int):
    mesh = ["cpu"] * LOCAL
    fi = FrameInfo(**FRAME_INFO)
    f = compress_frame_device(FRAME_DATA, fi, mesh=mesh)
    linked = compress_frame_device(FRAME_DATA, FrameInfo(block_mode=BlockMode.Linked, **FRAME_INFO),
                                   mesh=mesh)
    codec = LZ4Codec(CodecConfig(**FRAME_INFO), mesh)
    return dict(frame=f, linked=linked, back=decompress_frame_device(f, mesh=mesh),
                codec=codec.compress(FRAME_DATA), codec_back=codec.decompress(f))


CASES = {
    "encode_independent": lambda rank: PP.encode_blocks_sharded(
        ENC_DATA, ENC_BS, mesh=["cpu"] * LOCAL),
    "encode_linked": lambda rank: PP.encode_blocks_sharded(
        ENC_DATA, ENC_BS, linked=True, carry=CARRY, mesh=["cpu"] * LOCAL),
    "roundtrip_step": lambda rank: tuple(
        t.numpy() for t in PP.roundtrip_step_sharded(ENC_DATA, ENC_BS, mesh=["cpu"] * LOCAL)),
    "ring_decode": lambda rank: _counted_decode(dec_payloads(), rank, overflow_on=()),
    "overflow_on_one_rank": lambda rank: _counted_decode(dec_payloads(), rank, overflow_on=(1,)),
    "frames": _frames,
    "malformed_ring": lambda rank: _counted_decode(bad_payloads(), rank, overflow_on=()),
    "malformed_resident": lambda rank: PP._decode_blocks_sharded_resident(
        bad_payloads(), DEC_BS, mesh=["cpu"] * LOCAL),
    "unequal_entries": lambda rank: PP.decode_blocks_sharded(
        dec_payloads(), DEC_BS, mesh=["cpu"] * (LOCAL + rank)),
    "fetch_global": lambda rank: fetch_global(
        [torch.full((2, 3), 10 * rank + d, dtype=torch.int32) for d in range(LOCAL)]),
}


def main(argv) -> int:
    address, rank, world, out_dir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    native._lib()  # built by the test process already; loaded before any case
    if not distributed_init(address, num_processes=world, process_id=rank):
        raise SystemExit("distributed_init did not start a process group")
    results = {}
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    for name, case in CASES.items():
        try:
            results[name] = ("ok", case(rank))
        except Exception as e:  # the outcome under test; recorded, not hidden
            results[name] = ("raised", type(e).__name__, str(e))
        with open(path + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(path + ".tmp", path)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
