"""Build and bind the CUDA MM PU kernel (``csrc/mm_pu.cu``, which replaces
``repro/kernels/mm_pu/kernel.py::_mm_kernel``).

The library is compiled by ``nvcc`` at first use and loaded with ``ctypes``;
every pointer and the stream are declared ``c_void_p`` so none is cut to 32
bits.  Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mm_pu.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 8 + [_P]

_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Raises when it
    cannot be built (no ``nvcc``, or the compiler refuses the source)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        lib.mm_pu_forward.argtypes = _ARGTYPES
        lib.mm_pu_forward.restype = ctypes.c_int
        _lib = lib
    return _lib
