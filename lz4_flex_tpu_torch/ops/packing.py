"""Shape buckets, padding, and the byte, scan and scatter helpers of the
device programs (the JAX package's ``ops/packing.py``).

Words travel as int32 tensors holding the bit patterns of the JAX package's
little-endian uint32 words: the programs only take bytes out of them with
arithmetic right shifts and ``& 0xFF``, which read the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace

# Shape buckets: pad array lengths to the next bucket so that the number of
# distinct shapes, and the plans of buffers of each, stay small.
_BUCKET_MIN = 4096


def host_read(cast, t: torch.Tensor):
    """``cast(t)`` (``bool`` or ``int``) of a device tensor, which waits for
    the device: every read of a loop's state in the resident decode's
    programs goes through here, in the span ``resident.sync``."""
    with trace.span("resident.sync"):
        return cast(t)


def size_bucket(n: int, minimum: int = _BUCKET_MIN) -> int:
    """Round ``n`` up to the next power-of-two (or 1.5×power-of-two) bucket."""
    b = minimum
    while b < n:
        if (b + b // 2) >= n:
            return b + b // 2
        b *= 2
    return b


def pad_to(arr: np.ndarray, size: int, fill: int = 0) -> np.ndarray:
    """Pad a 1-D numpy array up to ``size`` with ``fill``."""
    if arr.shape[0] == size:
        return arr
    out = np.full(size, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def bytes_to_words(u8: torch.Tensor) -> torch.Tensor:
    """Pack a uint8 tensor (last dim divisible by 4) into little-endian
    words along its last dim, as int32 bit patterns."""
    b = u8.reshape(*u8.shape[:-1], -1, 4).to(torch.int64)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """Unpack little-endian words (int32 bit patterns) into a uint8 tensor,
    along the last dim."""
    b = torch.stack([(w >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
    return b.reshape(*w.shape[:-1], -1).to(torch.uint8)


def gather_bytes(words: torch.Tensor, byte_idx: torch.Tensor) -> torch.Tensor:
    """Bytes at ``byte_idx`` of a packed word buffer (int32), the indices
    clamped to the buffer: a word gather and a shift. A batch of buffers,
    (B, W) words, takes (B, ...) indices, each row into its own buffer."""
    idx = byte_idx.clamp(0, words.shape[-1] * 4 - 1)
    w = words[idx >> 2] if words.dim() == 1 else torch.gather(words, -1, (idx >> 2).long())
    return (w >> ((idx & 3) * 8)) & 0xFF


def gather_words_unaligned(words: torch.Tensor, byte_idx: torch.Tensor) -> torch.Tensor:
    """The 4-byte little-endian values starting at arbitrary byte offsets of
    a packed word buffer (int32 bit patterns in, int32 bit patterns out):
    two aligned word gathers and a funnel shift, the offsets clamped so that
    all four bytes lie in the buffer."""
    nw = words.shape[0]
    idx = byte_idx.clamp(0, nw * 4 - 4)
    lo = words[idx >> 2].to(torch.int64) & 0xFFFFFFFF
    hi = words[((idx >> 2) + 1).clamp(0, nw - 1)].to(torch.int64) & 0xFFFFFFFF
    sh = (idx & 3).to(torch.int64) * 8
    # sh == 0 takes no bits of hi (a shift by 32 is masked out, as in JAX)
    w = (lo >> sh) | torch.where(sh == 0, 0, (hi << (32 - sh)) & 0xFFFFFFFF)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def per_row(x):
    """A per-row count (int, () or (B,) tensor) as (B, 1), to broadcast
    against a batch's (B, n) rows; an int stays an int."""
    return x.reshape(-1, 1) if isinstance(x, torch.Tensor) else x


def doubling_scan(x: torch.Tensor, fn) -> torch.Tensor:
    """Inclusive scan along the last dim by log-step doubling (Hillis-Steele)
    with an associative elementwise ``fn`` (``torch.add``, ``torch.maximum``,
    ...): ceil(log2(width)) elementwise passes, each reading the previous
    pass. Exact for integers (an int32 sum wraps)."""
    x = x.clone()
    k = 1
    while k < x.shape[-1]:
        x[..., k:] = fn(x[..., k:], x[..., :-k])
        k *= 2
    return x


def tiled_scan(kind: str, x: torch.Tensor, *, reverse: bool = False) -> torch.Tensor:
    """Inclusive cumulative scan ("sum", "max" or "min") along the last dim,
    in the tensor's own dtype (an int32 sum wraps as the JAX package's does).

    The JAX package tiles the scan to dodge an XLA:TPU compile-time trap;
    here the name stays so the two read side by side. A sum is
    ``torch.cumsum``; a max or min is :func:`doubling_scan`, because CUDA's
    ``cummax``/``cummin`` scan one long row in one slow kernel (33 ms over
    12.6 M int32 on an H100, PERF.md)."""
    if reverse:
        return tiled_scan(kind, x.flip(-1)).flip(-1)
    if kind == "sum":
        return torch.cumsum(x, -1).to(x.dtype)
    if kind == "max":
        return doubling_scan(x, torch.maximum)
    if kind == "min":
        return doubling_scan(x, torch.minimum)
    raise ValueError(f"unknown scan {kind!r}")


def tiled_cumsum(x: torch.Tensor) -> torch.Tensor:
    return tiled_scan("sum", x)


def tiled_cummax(x: torch.Tensor) -> torch.Tensor:
    return tiled_scan("max", x)


def lsic_tables(u8: torch.Tensor):
    """Vectorized LSIC (Linear Small-Integer Code) run decode, along the
    last dim of ``u8`` (one payload, or a batch of rows).

    For every byte position q of ``u8`` (taken as the first byte of an LSIC
    extension run; lz4_flex reads these one byte at a time in read_integer,
    src/block/decompress.rs:126-157), returns int32 tensors:

      value[q]  the decoded extension value (the 0xFF run plus the
                terminating byte)
      nbytes[q] how many bytes the run occupies (run length + 1)

    A reversed cumulative minimum finds the first byte at or after q that
    is not 0xFF. A run that reaches the end reads the last byte as its
    terminator, so callers pad the payload with at least one zero byte.
    """
    n = u8.shape[-1]
    pos = torch.arange(n, dtype=torch.int32, device=u8.device)
    cand = torch.where(u8 != 0xFF, pos, n - 1)
    nz_next = tiled_scan("min", cand, reverse=True)
    run = nz_next - pos
    value = run * 255 + torch.gather(u8, -1, nz_next.long()).to(torch.int32)
    return value, run + 1


def scatter_drop(base: torch.Tensor, idx: torch.Tensor, vals, op: str = "set") -> torch.Tensor:
    """``base.at[idx].<op>(vals, mode="drop")`` of the JAX package along the
    last dim, for op "set", "add" or "max"; returns a new tensor. ``base``
    is (n,) or a batch (B, n) whose row b takes the targets of ``idx``'s
    row b; ``vals`` is a tensor that broadcasts to ``idx`` or a number.
    Duplicate targets of "set" must carry equal values (the scatter order
    is not fixed on CUDA).

    As in JAX, a negative index counts from the end, and whatever then lies
    outside [0, n) is dropped: it goes to a sink slot n of each row, one
    longer than ``base``'s, which is sliced off. Never a clamp: that would
    write into a real position, and no row writes into another."""
    n = base.shape[-1]
    out = torch.cat([base, base.new_zeros(*base.shape[:-1], 1)], -1)
    idx = torch.where(idx < 0, idx + n, idx)
    tgt = torch.where((idx >= 0) & (idx < n), idx, n).long()
    if not isinstance(vals, torch.Tensor):
        vals = torch.full(idx.shape, vals, dtype=base.dtype, device=base.device)
    vals = vals.to(base.dtype).expand(idx.shape)
    if op == "add":
        out.scatter_add_(-1, tgt, vals)
    elif op == "max":
        out.scatter_reduce_(-1, tgt, vals, reduce="amax")
    elif op == "set":
        out.scatter_(-1, tgt, vals)
    else:
        raise ValueError(f"unknown scatter op {op!r}")
    return out[..., :n]
