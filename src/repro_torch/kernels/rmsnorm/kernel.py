"""Build and bind the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``, which
replaces ``repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel``) and its
backward (``csrc/rmsnorm_bwd.cu``, C entry ``rmsnorm_backward``: the
gradient JAX takes by autodiff of the norm), in a library of its own.

The library is compiled by ``nvcc`` at first use and loaded with ``ctypes``;
every pointer and the stream are declared ``c_void_p`` and the row count
and strides ``c_longlong``, so none is cut to 32 bits.  Nothing here runs at
import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_L, _I, _I, _L, _L, ctypes.c_float] + [_I] * 6 + [_P]
BACKWARD_SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm_bwd.cu"
# x, scale, residual, dy, dx, partial scratch, dscale; outer, inner, d,
# outer stride, inner stride; eps; vec, dtype, group, nv, rows a group,
# grid; stream
BACKWARD_ARGTYPES = [_P] * 7 + [_L, _I, _I, _L, _L, ctypes.c_float] + [_I] * 6 + [_P]

_lib = None
_bwd_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Raises when it
    cannot be built (no ``nvcc``, or the compiler refuses the source)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        lib.rmsnorm_forward.argtypes = _ARGTYPES
        lib.rmsnorm_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def backward_library() -> ctypes.CDLL:
    """The loaded backward library, built on first call; raises as
    ``library`` does."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(BACKWARD_SOURCE)
        lib.rmsnorm_backward.argtypes = BACKWARD_ARGTYPES
        lib.rmsnorm_backward.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib
