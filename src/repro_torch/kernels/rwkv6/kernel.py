"""Build and bind the CUDA WKV kernels (``csrc/wkv.cu``, which replaces
``repro/kernels/rwkv6/kernel.py::_wkv_kernel``): two C entry points of one
signature, ``wkv_forward`` (f32 r/k/v, CUDA cores) and ``wkv_forward_mma``
(bf16 r/k/v, tensor cores).

The library is compiled by ``nvcc`` at first use and loaded with ``ctypes``;
every pointer and the stream are declared ``c_void_p`` so none is cut to 32
bits.  Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]
ENTRIES = ("wkv_forward", "wkv_forward_mma")

_lib = None


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
