"""Build and bind the CUDA MM PU kernels (``csrc/mm_pu.cu``, which replaces
``repro/kernels/mm_pu/kernel.py::_mm_kernel``): ``mm_pu_forward`` (f32 x,
CUDA cores) and ``mm_pu_forward_mma`` (bf16 x, tensor cores, with split-K).

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
_ARGTYPES = {
    "mm_pu_forward": [_P] * 6 + [_I] * 8 + [_P],
    "mm_pu_forward_mma": [_P] * 7 + [_I] * 10 + [_P],
}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Raises when it
    cannot be built (no ``nvcc``, or the compiler refuses the source)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name, argtypes in _ARGTYPES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib
