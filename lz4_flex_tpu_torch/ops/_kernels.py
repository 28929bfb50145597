"""Build and bind the CUDA kernels in ``csrc/``.

Each source is compiled with nvcc for ``sm_90a`` into a shared library with a
plain C interface, at first use, into the checkout's ``build/`` directory
(cached by a hash of the source and its headers), and loaded with ctypes.
Nothing here runs at import time, and nothing falls back: a failed build or
launch raises.

  ring_decode      K1, the ring decoder, on one plan or (K1c) several (ops/ringdecode.py)
  resident_decode  the resident decode of a batch of payload rows (ops/decode.py)
  encode_rows      the all-device encode of a batch of block rows (ops/encode.py)
  fire_probe       K1's fire loop in variants (experiments/fire_probe.py)
  gather_probe     shared-memory gather forms (experiments/gather_probe.py)
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

from ..native import build_cached

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# Headers each source includes (part of its build hash).
_HEADERS = {
    "ring_decode": ("ring_decode.cuh",),
    "resident_decode": (),
    "encode_rows": (),
    "fire_probe": ("ring_decode.cuh",),
    "gather_probe": (),
}
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_vp = ctypes.c_void_p
_ci = ctypes.c_int
# C signatures: name -> (restype, argtypes), per library.
_SIGNATURES = {
    "ring_decode": {
        "tlz4_ring_decode": (_ci, [_vp] * 6 + [_ci] * 4 + [ctypes.c_longlong, _vp, _vp]),
        "tlz4_cuda_error_string": (ctypes.c_char_p, [_ci]),
    },
    "resident_decode": {
        "tlz4_resident_decode": (_ci, [_vp, ctypes.c_longlong, _ci, _vp] + [_ci] * 4 + [_vp] * 4),
        "tlz4_resident_error_string": (ctypes.c_char_p, [_ci]),
    },
    "encode_rows": {
        "tlz4_encode_rows": (_ci, [_vp] * 4 + [_ci] * 6 + [_vp, ctypes.c_longlong, _vp, _ci]
                             + [_vp] * 3),
        "tlz4_encode_rows_ranks": (_ci, [_ci]),
        "tlz4_encode_rows_error_string": (ctypes.c_char_p, [_ci]),
    },
    "fire_probe": {
        "tlz4_fire_probe": (_ci, [_ci] + [_vp] * 6 + [_ci] * 3 + [_vp]),
        "tlz4_fire_probe_variants": (_ci, []),
        "tlz4_fire_probe_error_string": (ctypes.c_char_p, [_ci]),
    },
    "gather_probe": {
        "tlz4_gather_probe": (_ci, [_ci, _vp, _vp, _vp, _ci, _vp]),
        "tlz4_gather_probe_variants": (_ci, []),
        "tlz4_gather_probe_error_string": (ctypes.c_char_p, [_ci]),
    },
}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def build(stem: str) -> str:
    """Compile csrc/<stem>.cu (if not cached) and return the library path.
    ``-Xptxas -v`` leaves registers and spills in ``<path>.log``."""
    nvcc = find_nvcc()
    src = os.path.join(_CSRC, stem + ".cu")
    return build_cached(
        src, stem,
        lambda out: [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", out, src,
        ],
        deps=[os.path.join(_CSRC, h) for h in _HEADERS[stem]],
    )


def lib(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, built at first use."""
    found = _LIBS.get(stem)
    if found is None:
        with _LOCK:
            found = _LIBS.get(stem)
            if found is None:
                found = ctypes.CDLL(build(stem))
                for name, (restype, argtypes) in _SIGNATURES[stem].items():
                    fn = getattr(found, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _LIBS[stem] = found
    return found


def check_launch(err: int, what: str, error_string) -> None:
    """Raise RuntimeError when a C launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {error_string(err).decode()} ({err})")


def launch_ring_decode(init, f0, f1, f2, nf_tot, out, *, tile_rows: int,
                       ntot: int | None, acc, stream: int) -> None:
    """Launch K1 on ``stream`` over one plan (``nf_tot`` of shape (ntiles,):
    K1a, or K1b with ``acc``) or over G stacked plans (``nf_tot`` of shape
    (G, ntiles): K1c, one CTA per plan). The tensors are already checked by
    the caller. Raises RuntimeError when the launch is refused."""
    rl = lib("ring_decode")
    nplans = 1 if nf_tot.dim() == 1 else nf_tot.shape[0]
    err = rl.tlz4_ring_decode(
        init.data_ptr(), f0.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        nf_tot.data_ptr(), out.data_ptr(),
        nplans, f0.shape[-3], f0.shape[-2], tile_rows,
        -1 if ntot is None else int(ntot),
        None if acc is None else acc.data_ptr(),
        stream,
    )
    check_launch(err, "ring_decode", rl.tlz4_cuda_error_string)


def launch_resident_decode(u8, clen, out, total, flags, *, nseq_pad: int, capacity: int,
                           stream: int) -> None:
    """Launch the resident decode on ``stream`` over the (B, width) payload
    rows ``u8`` (rows contiguous, any row stride) with their (B,) int32
    lengths ``clen``, into ``out`` (B, out_pad) uint8, ``total`` (B,) int32
    and ``flags`` (B, 5) bool. The tensors are already checked by the
    caller. Raises RuntimeError when the launch is refused."""
    rl = lib("resident_decode")
    err = rl.tlz4_resident_decode(
        u8.data_ptr(), u8.stride(0), u8.shape[1], clen.data_ptr(), u8.shape[0], out.shape[1],
        nseq_pad, capacity, out.data_ptr(), total.data_ptr(), flags.data_ptr(), stream,
    )
    check_launch(err, "resident_decode", rl.tlz4_resident_error_string)


def encode_rows_ranks(nrows: int) -> int:
    """CTAs a row (one cluster) for a launch of the all-device encode over
    ``nrows`` rows: the most, up to 4, at which every row's cluster is
    resident on the card at once, else 1."""
    return lib("encode_rows").tlz4_encode_rows_ranks(nrows)


def launch_encode_rows(u8, words, d, n, out, total, scratch, tables, *, levels: int,
                       nseq_pad: int, stream: int) -> None:
    """Launch the all-device encode on ``stream`` over the (B, width) rows
    ``u8`` (dictionary ++ data, the match source), their (B, width / 4)
    int32 ``words`` (the literal source) and (B,) int32 dictionary and
    dictionary + data lengths ``d``, ``n``, into ``out`` (B, comp_pad) uint8
    and ``total`` (B,) int32, with the (B, row_ints) int32 ``scratch`` and
    the (B, ranks, 2^bits) int64 hash ``tables``, a cluster of ``ranks``
    CTAs a row. The tensors are already checked by the caller. Raises
    RuntimeError when the launch is refused."""
    el = lib("encode_rows")
    err = el.tlz4_encode_rows(
        u8.data_ptr(), words.data_ptr(), d.data_ptr(), n.data_ptr(), u8.shape[0],
        tables.shape[1], u8.shape[1], levels, out.shape[1], nseq_pad, scratch.data_ptr(),
        scratch.shape[1], tables.data_ptr(), tables.shape[2].bit_length() - 1, out.data_ptr(),
        total.data_ptr(), stream,
    )
    check_launch(err, "encode_rows", el.tlz4_encode_rows_error_string)
