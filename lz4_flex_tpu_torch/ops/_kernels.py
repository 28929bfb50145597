"""Build and bind the CUDA kernels in ``csrc/``.

Each source is compiled with nvcc for ``sm_90a`` into a shared library with a
plain C interface, at first use, into the checkout's ``build/`` directory
(cached by source hash), and loaded with ctypes. Nothing here runs at import
time, and nothing falls back: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

from ..native import build_cached

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
RING_DECODE_SRC = os.path.join(_CSRC, "ring_decode.cu")
_LOCK = threading.Lock()
_RING: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def build_ring_decode() -> str:
    """Compile csrc/ring_decode.cu (if not cached) and return the library
    path. ``-Xptxas -v`` leaves registers and spills in ``<path>.log``."""
    nvcc = find_nvcc()
    return build_cached(
        RING_DECODE_SRC, "ring_decode",
        lambda out: [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", out, RING_DECODE_SRC,
        ],
    )


def ring_lib() -> ctypes.CDLL:
    global _RING
    if _RING is None:
        with _LOCK:
            if _RING is None:
                lib = ctypes.CDLL(build_ring_decode())
                vp = ctypes.c_void_p
                ci = ctypes.c_int
                lib.tlz4_ring_decode.restype = ci
                lib.tlz4_ring_decode.argtypes = [
                    vp, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_longlong, vp, vp,
                ]
                lib.tlz4_cuda_error_string.restype = ctypes.c_char_p
                lib.tlz4_cuda_error_string.argtypes = [ci]
                _RING = lib
    return _RING


def launch_ring_decode(init, f0, f1, f2, nf_tot, out, *, tile_rows: int,
                       ntot: int | None, acc, stream: int) -> None:
    """Launch K1 on ``stream`` (tensors already checked by the caller).
    Raises RuntimeError when the launch is refused."""
    lib = ring_lib()
    err = lib.tlz4_ring_decode(
        init.data_ptr(), f0.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        nf_tot.data_ptr(), out.data_ptr(),
        f0.shape[0], f0.shape[1], tile_rows,
        -1 if ntot is None else int(ntot),
        None if acc is None else acc.data_ptr(),
        stream,
    )
    if err != 0:
        msg = lib.tlz4_cuda_error_string(err).decode()
        raise RuntimeError(f"ring_decode kernel launch failed: {msg} ({err})")
