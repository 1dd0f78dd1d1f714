"""Build and bind the CUDA flash-attention kernels
(``csrc/flash_attention.cu``, which replaces
``repro/kernels/flash_attention/kernel.py::_flash_kernel``): two C entry
points of one signature, ``flash_attention_forward`` (f32, CUDA cores) and
``flash_attention_forward_mma`` (bf16, tensor cores).

The library is compiled by ``nvcc`` at first use and loaded with ``ctypes``;
every pointer and the stream are declared ``c_void_p`` and the token strides
``c_longlong``, so none is cut to 32 bits.  Nothing here runs at import: the
CPU tests import every module.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_L] * 3 + [_I] * 4 + [ctypes.c_float, _P]
ENTRIES = ("flash_attention_forward", "flash_attention_forward_mma")

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
