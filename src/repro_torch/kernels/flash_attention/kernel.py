"""Build and bind the CUDA flash-attention kernels
(``csrc/flash_attention.cu``, which replaces
``repro/kernels/flash_attention/kernel.py::_flash_kernel``): two C entry
points of one signature, ``flash_attention_forward`` (f32, CUDA cores) and
``flash_attention_forward_mma`` (bf16, tensor cores), each writing the
rows' logsumexp when given a buffer for it; and the backward
(``csrc/flash_attention_bwd.cu``, the kernel counterpart of the jnp
``repro/kernels/flash_attention/backward.py::_vjp_bwd``), C entry
``flash_attention_backward`` (bf16 on tensor cores, f32 on CUDA cores,
picked by its dtype argument; D 32-256), in a library of its own.

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
BACKWARD_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, out, lse; B, Sq, Sk, H, KH, D; token strides; causal, window,
# prefix, rows a CTA; scale; stream
_ARGTYPES = [_P] * 5 + [_I] * 6 + [_L] * 3 + [_I] * 4 + [ctypes.c_float, _P]
ENTRIES = ("flash_attention_forward", "flash_attention_forward_mma")
# q, k, v, o, lse, do, dq, dk, dv, delta scratch; B, Sq, Sk, H, KH, D;
# q, k, v token strides; causal, window, prefix, dtype; scale; stream
BACKWARD_ARGTYPES = [_P] * 10 + [_I] * 6 + [_L] * 3 + [_I] * 4 + [ctypes.c_float, _P]

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
        lib.flash_attention_backward.argtypes = BACKWARD_ARGTYPES
        lib.flash_attention_backward.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib
