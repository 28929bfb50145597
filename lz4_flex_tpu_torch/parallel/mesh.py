"""Device meshes for the codec (the JAX package's ``parallel/mesh.py``).

A mesh is a plain list of ``torch.device``: one axis, ``BLOCK_AXIS``, over
which frame blocks shard data-parallel, entry i holding the i-th contiguous
span of blocks. Entries may repeat: ``["cuda:0"] * 4`` puts four device
groups on one card (their plans then go to the card in one grouped launch),
and ``["cpu"] * 8`` is the 8-device virtual CPU mesh the tests use. The
pipelines route on ``len(mesh)``, as the JAX package's route on the mesh's
device count.

This port runs one process: a mesh holds this process's devices only.
``distributed_init`` keeps the JAX package's contract (False and nothing
done without a coordinator; False on a second call), but the pipelines
gather nothing across processes yet (``pipeline.fetch_global`` raises on a
cross-process tensor).
"""

from __future__ import annotations

import os

import torch

BLOCK_AXIS = "blocks"


def codec_mesh(devices=None) -> list[torch.device]:
    """A 1-D mesh over ``devices`` (device names or ``torch.device``s, in
    order; repeats allowed). ``None`` means every visible CUDA card, and
    raises when there is none; a CUDA entry needs a card of compute
    capability 9.0+."""
    from ..ops.ringdecode import resolve_device

    if devices is None:
        resolve_device(None)  # raises without a card
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    # one name per card, so that entries on one card group together
    mesh = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in mesh]
    if not mesh:
        raise ValueError("a codec mesh needs at least one device")
    return mesh


def local_codec_mesh() -> list[torch.device]:
    """A mesh over this process's devices: :func:`codec_mesh` ``()``."""
    return codec_mesh()


_distributed_initialized = False


def distributed_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Bootstrap a multi-process group with ``torch.distributed``.

    With no coordinator given and none in the environment
    (``MASTER_ADDR``, ``COORDINATOR_ADDRESS``) this is a single-process run:
    it returns False and does nothing. Called a second time it returns
    False. Otherwise it calls ``torch.distributed.init_process_group`` (NCCL
    where a card is present, else gloo) with ``coordinator_address`` as a
    ``host:port`` TCP address, and returns True. ``local_device_ids`` picks
    this process's card (its first entry). Meshes still span one process;
    see the module docstring."""
    global _distributed_initialized
    if _distributed_initialized:
        return False
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not any(v in os.environ for v in ("MASTER_ADDR", "COORDINATOR_ADDRESS")):
        return False  # single-process run: nothing to bootstrap
    import torch.distributed as dist

    if dist.is_initialized():
        _distributed_initialized = True
        return False
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    kw = {}
    if address is not None:
        kw["init_method"] = f"tcp://{address}"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if local_device_ids and torch.cuda.is_available():
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo", **kw)
    _distributed_initialized = True
    return True
