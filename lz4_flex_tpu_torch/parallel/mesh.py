"""Device meshes for the codec (the JAX package's ``parallel/mesh.py``).

A mesh is a plain list of ``torch.device``: one axis, ``BLOCK_AXIS``, over
which frame blocks shard data-parallel, entry i holding the i-th contiguous
span of blocks. Entries may repeat: ``["cuda:0"] * 4`` puts four device
groups on one card (their plans then go to the card in one grouped launch),
and ``["cpu"] * 8`` is the 8-device virtual CPU mesh the tests use.

In a process group of W > 1 processes (``distributed_init``, or any
``torch.distributed`` group), the *global* mesh is the W processes' meshes
in rank order, and every process must hold the same number of entries
(:func:`mesh_layout` checks it with one gather of the counts).
``codec_mesh()`` still returns this process's entries only. The pipelines
route on the global entry count, as the JAX package's route on the mesh's
device count; block group g belongs to the process that holds global entry
g, which stages, plans and launches only its own groups. What crosses
processes are host copies, gathered over a gloo group (:func:`host_group`)
whatever the default group's backend, so that two processes may share one
card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..block import errors as block_errors

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
    this process's card (its first entry). When the default group is not
    gloo, the gloo group of :func:`host_group` is made here too, on every
    rank in the same order."""
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
    host_group()
    _distributed_initialized = True
    return True


def process_rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the running ``torch.distributed`` group, or
    (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


_host_groups: dict = {}  # default group -> its gloo group for host copies


def host_group():
    """The group the pipelines gather host copies over: the default group
    when its backend is gloo (returned as None, the collectives' name for
    it), else one ``dist.new_group(backend="gloo")`` made at the first call
    and kept. Making a group is collective: every rank makes the same calls
    in the same order. A gloo group never touches a card, so NCCL's refusal
    of two ranks on one card does not arise; an on-device gather would be a
    later optimisation."""
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if world not in _host_groups:
        _host_groups[world] = dist.new_group(backend="gloo")
    return _host_groups[world]


def all_gather_arrays(a: np.ndarray, counts=None) -> list[np.ndarray]:
    """Every rank's array ``a``, in rank order, gathered over
    :func:`host_group`. The ranks' arrays may differ in their first axis
    only; ``counts``, the ranks' first-axis lengths where every rank knows
    them, saves the gather of the lengths. Each rank's array is padded to
    the longest, since gloo gathers tensors of one size."""
    import torch.distributed as dist

    group = host_group()
    world = dist.get_world_size()
    if a.dtype == np.bool_:  # gloo has no bool
        return [g.view(np.bool_) for g in all_gather_arrays(a.view(np.uint8), counts)]
    if counts is None:
        mine = torch.tensor([a.shape[0]], dtype=torch.int64)
        got = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(got, mine, group=group)
        counts = [int(c) for c in got]
    if a.shape[0] != counts[dist.get_rank()]:
        raise ValueError(f"this rank's array has {a.shape[0]} rows, not {counts[dist.get_rank()]}")
    pad = np.zeros((max(1, max(counts)), *a.shape[1:]), a.dtype)  # gloo takes no empty tensors
    pad[: a.shape[0]] = a
    pad = torch.from_numpy(pad)
    got = [torch.empty_like(pad) for _ in range(world)]
    dist.all_gather(got, pad, group=group)
    return [g[:c].numpy() for g, c in zip(got, counts)]


@dataclass(frozen=True)
class MeshLayout:
    """Where this process's mesh entries sit in the global mesh: its rank
    and the world size, the global index of its entry 0, and the global
    entry count."""

    rank: int
    world: int
    first: int
    total: int

    def entries(self, local: int) -> range:
        """The global indices of this process's ``local`` entries."""
        return range(self.first, self.first + local)


def mesh_layout(mesh) -> MeshLayout:
    """The global layout of ``mesh``, this process's entries. With one
    process the mesh is global. In a group of W > 1 it is this rank's part
    of a mesh of W times its length: one gather of the ranks' entry counts,
    and ValueError on every rank when they differ."""
    rank, world = process_rank_and_world()
    if world == 1:
        return MeshLayout(0, 1, 0, len(mesh))
    counts = [int(c[0]) for c in all_gather_arrays(np.array([len(mesh)], np.int64), [1] * world)]
    if len(set(counts)) != 1:
        raise ValueError(
            f"every process must hold the same number of mesh entries; the ranks hold {counts}")
    return MeshLayout(rank, world, rank * len(mesh), len(mesh) * world)



# The errors a rank can raise that every rank raises again as the same type
# (the block decode's taxonomy); any other type becomes RuntimeError there.
_SHARED_ERRORS = (block_errors.DecompressError, block_errors.OutputTooSmall,
                  block_errors.LiteralOutOfBounds, block_errors.ExpectedAnotherByte,
                  block_errors.OffsetZero, block_errors.OffsetOutOfBounds)


def agree(fn, layout: MeshLayout):
    """``fn()`` on this rank, its outcome agreed with every rank before any
    bulk gather (one gather of a 4-word status a rank), so that no rank
    waits in a gather that another never enters. Returns the result when
    every rank's call returned one, and None when any rank's call returned
    None (a plan overflow: every rank then takes the same fallback) and none
    raised. When any raised, every rank raises the exception of the lowest
    such rank: that rank its own, the others one of the same block-error
    type (RuntimeError for another type). With one process it is ``fn()``."""
    if layout.world == 1:
        return fn()
    out = err = None
    try:
        out = fn()
    except Exception as e:  # every rank raises it below, once all have heard
        err = e
    word = np.zeros((1, 4), np.int64)  # (status, error type, expected, actual)
    if err is not None:
        kind = _SHARED_ERRORS.index(type(err)) if type(err) in _SHARED_ERRORS else -1
        word[0] = (2, kind, getattr(err, "expected", 0), getattr(err, "actual", 0))
    elif out is None:
        word[0, 0] = 1
    words = np.concatenate(all_gather_arrays(word, [1] * layout.world))
    raised = np.flatnonzero(words[:, 0] == 2)
    if raised.size:
        r = int(raised[0])
        if r == layout.rank:
            raise err
        kind, expected, actual = (int(v) for v in words[r, 1:])
        if kind < 0:
            raise RuntimeError(f"rank {r} of the codec mesh raised")
        cls = _SHARED_ERRORS[kind]
        if cls is block_errors.OutputTooSmall:
            raise cls(expected, actual)
        if cls is block_errors.DecompressError:
            raise cls(f"rank {r} of the codec mesh found malformed input")
        raise cls()
    return None if (words[:, 0] == 1).any() else out
