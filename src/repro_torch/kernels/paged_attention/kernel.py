"""Build and bind the CUDA paged-attention kernels (``csrc/paged_attention.cu``,
which replace ``repro/kernels/paged_attention/kernel.py::_paged_kernel``).

The library is compiled by ``nvcc`` at first use and loaded with ``ctypes``;
every pointer and the stream are declared ``c_void_p`` so none is cut to 32
bits.  Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "paged_attention_forward": [_P] * 9 + [_I] * 9 + [ctypes.c_float, _I, _I, _P],
    "paged_attention_forward_mma": [_P] * 11 + [_I] * 12 + [ctypes.c_float, _P],
}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Raises when it
    cannot be built (no ``nvcc``, or the compiler refuses the source)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name, types in _ARGTYPES.items():
            getattr(lib, name).argtypes = types
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib
