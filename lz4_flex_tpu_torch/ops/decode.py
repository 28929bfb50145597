"""Device block decode: the ``parse="ring"`` engine.

The native size walk measures the block (raising the structural errors of
the checked-decode error set, lz4_flex src/block/mod.rs:82-98), the native
planner turns it into a ring plan while it checks every match offset against
the output so far, and the ring kernel (ops/ringdecode.py) decodes the plan
on the card.
"""

from __future__ import annotations

from .. import native as _native
from ..block import errors as block_errors
from .ringdecode import decode_block_ring, decode_parts_ring, resolve_device


def decode_block_device(
    data,
    max_output_size: int,
    ext_dict=b"",
    *,
    parse: str = "ring",
    device=None,
    as_array: bool = False,
):
    """Decompress one raw LZ4 block on the device.

    ``parse="ring"`` (the only engine ported so far) builds the host plan and
    runs the ring kernel; a dictionary rides as a stored pseudo-block of its
    last 64 KiB ahead of the payload, resolved through the kernel's linked
    window, and is sliced off the output. ``device=None`` means the CUDA
    card; ``device="cpu"`` runs the kernel's plain PyTorch version.

    Returns bytes, or a uint8 tensor on ``device`` when ``as_array`` is true.
    Raises the block error taxonomy on malformed input.
    """
    if parse in ("host", "device"):
        raise NotImplementedError(f"parse={parse!r} is not ported yet; use parse='ring'")
    if parse != "ring":
        raise ValueError(f"unknown parse engine {parse!r}")
    dev = resolve_device(device)
    comp = _native.as_u8(data)
    dic = _native.as_u8(ext_dict)
    if not dic.shape[0]:
        total = _native.measure_block(comp)
        if total > max_output_size:
            raise block_errors.OutputTooSmall(total, max_output_size)
        return decode_block_ring(comp, total, device=dev, as_array=as_array)
    # Only the dict's last 64 KiB is reachable (LZ4 offsets cap at 65535).
    dtail = dic[-65536:]
    out = decode_parts_ring(
        [(dtail, False), (comp, True)], independent=False,
        max_block_size=max_output_size, device=dev, as_array=as_array,
    )
    return out[dtail.shape[0]:]
