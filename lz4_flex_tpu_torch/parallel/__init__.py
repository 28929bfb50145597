"""Multi-device scale-out for the codec (the JAX package's ``parallel/``).

Independent frame blocks shard data-parallel over a mesh, a list of torch
devices (mesh.py): encode in both block modes (a linked block's dictionary
is a slice of the input, known upfront), and decode of independent blocks,
whose per-entry ring plans go to each card in one grouped kernel launch.
``executor.plan_executor`` is the persistent host pool for native walks and
concurrent plan builds. In a ``torch.distributed`` group of several
processes, the global mesh is every process's mesh in rank order; each
process works on its own entries and the results are gathered as host
copies (mesh.py, pipeline.py).
"""

from .mesh import codec_mesh, distributed_init, local_codec_mesh
from .pipeline import (
    decode_blocks_sharded,
    encode_blocks,
    encode_blocks_sharded,
    fetch_global,
    roundtrip_step_sharded,
    stage_blocks,
)

__all__ = [
    "codec_mesh",
    "distributed_init",
    "fetch_global",
    "local_codec_mesh",
    "encode_blocks",
    "encode_blocks_sharded",
    "decode_blocks_sharded",
    "roundtrip_step_sharded",
    "stage_blocks",
]
