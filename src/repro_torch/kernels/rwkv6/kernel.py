"""Build and bind the CUDA WKV kernels (``csrc/wkv.cu``, which replaces
``repro/kernels/rwkv6/kernel.py::_wkv_kernel``): two C entry points of one
signature, ``wkv_forward`` (f32 r/k/v, CUDA cores) and ``wkv_forward_mma``
(bf16 r/k/v, tensor cores); and the backward (``csrc/wkv_bwd.cu``, the
kernel counterpart of JAX's autodiff of ``repro/models/rwkv6.py::
wkv_chunked``), C entries ``wkv_backward`` (f32 r/k/v, CUDA cores; bf16
too) and ``wkv_backward_mma`` (bf16 r/k/v, tensor cores) of one signature,
in a library of its own.

The library is compiled by ``nvcc`` at first use and loaded with ``ctypes``;
every pointer and the stream are declared ``c_void_p`` so none is cut to 32
bits.  Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv.cu"
BACKWARD_SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv_bwd.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]
ENTRIES = ("wkv_forward", "wkv_forward_mma")
# r, k, v, w, u, state in, dout, d(state out), dr, dk, dv, d(log w), du,
# d(state in), chunk-state scratch, du partials; B, S, H, D, chunk, dtype;
# stream
BACKWARD_ARGTYPES = [_P] * 16 + [_I] * 6 + [_P]
BACKWARD_ENTRIES = ("wkv_backward", "wkv_backward_mma")

_lib = None
_bwd_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Raises when it
    cannot be built (no ``nvcc``, or the compiler refuses the source)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name in ENTRIES:
            getattr(lib, name).argtypes = _ARGTYPES
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def backward_library() -> ctypes.CDLL:
    """The loaded backward library, built on first call; raises as
    ``library`` does."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(BACKWARD_SOURCE)
        for name in BACKWARD_ENTRIES:
            getattr(lib, name).argtypes = BACKWARD_ARGTYPES
            getattr(lib, name).restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib
