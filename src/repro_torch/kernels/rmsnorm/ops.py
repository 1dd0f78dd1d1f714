"""Wrapper of the RMSNorm kernel in the model's layout (the port's
``repro/kernels/rmsnorm/ops.py``).

x keeps its (..., d) shape.  The kernel indexes rows as (outer, inner) with
an element stride each, so any view whose leading dimensions fold into two
strided ones is read in place: the qk-norm input, a (B, S, H, D) view of the
fused QKV projection, needs no copy.  A view that does not fold is copied
first.  The output is a new dense tensor in x's dtype.  CPU tensors go to
the plain version (``ref.rmsnorm_ref``); CUDA tensors launch the kernel or
raise: there is no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

# Kernel launches so far; a run resets it to show which path it took.
LAUNCHES = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rmsnorm: {msg}")


def row_layout(x: torch.Tensor) -> Optional[tuple]:
    """``(outer, inner, outer stride, inner stride)`` in elements such that
    row ``o * inner + i`` of ``x`` (all dimensions but the last, in order)
    starts at ``o * outer stride + i * inner stride``; None when the leading
    dimensions do not fold into two strided ones or the last is not dense."""
    if x.dim() == 0 or (x.shape[-1] > 1 and x.stride(-1) != 1):
        return None
    dims = []  # (size, stride), outermost first, adjacent dense runs merged
    for n, s in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if dims and dims[-1][1] == n * s:
            dims[-1] = (dims[-1][0] * n, s)
        else:
            dims.append((n, s))
    if not dims:
        return 1, 1, 0, 0
    if len(dims) == 1:
        return dims[0][0], 1, dims[0][1], dims[0][1]
    if len(dims) == 2:
        (no, so), (ni, si) = dims
        return no, ni, so, si
    return None


def rmsnorm(
    x: torch.Tensor,
    scale: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """x: (..., d) f32 or bf16; scale: (d,) f32; residual: x's shape and
    dtype, or None.  Returns RMSNorm(x [+ residual]) * (1 + scale) in x's
    dtype, computed in f32."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, residual, eps)
    lib = kernel.library()
    _require(x.is_cuda, f"x must be a CUDA or CPU tensor, got {x.device}")
    _require(x.dtype in _CODES, f"dtype {x.dtype} (f32 or bf16)")
    d = x.shape[-1] if x.dim() else 0
    _require(d > 0, f"x must be (..., d) with d > 0, got {tuple(x.shape)}")
    _require(scale.shape == (d,) and scale.dtype == torch.float32 and scale.is_contiguous(),
             f"scale must be a contiguous ({d},) f32 vector")
    _require(scale.device == x.device, "scale on x's device")
    if residual is not None:
        _require(residual.shape == x.shape and residual.dtype == x.dtype
                 and residual.device == x.device, "residual must match x's shape, dtype, device")
        residual = residual.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    layout = row_layout(x)
    if layout is None:
        x = x.contiguous()
        layout = row_layout(x)
    outer, inner, so, si = layout
    es = x.element_size()
    vec = (d * es) % 16 == 0 and all(p % 16 == 0 for p in (
        x.data_ptr(), scale.data_ptr(), so * es, si * es,
        residual.data_ptr() if residual is not None else 0))
    rc = lib.rmsnorm_forward(
        x.data_ptr(), scale.data_ptr(), residual.data_ptr() if residual is not None else None,
        out.data_ptr(), outer, inner, d, so, si, float(eps), int(vec), _CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed (code {rc})")
    global LAUNCHES
    LAUNCHES += 1
    return out
