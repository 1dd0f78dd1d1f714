"""Build and bind the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``, which
replaces ``repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel``).

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

_lib = None


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
