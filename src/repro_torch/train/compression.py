"""Gradient compression at the accumulation boundary (the port's
``repro/train/compression.py``, its dtype path): each gradient leaf is
quantized to the wire format and back, and the quantization error is
carried to the next step in an f32 residual (error feedback), so the
noise is unbiased over steps.  ``quantize(..., scale=)`` is also the grid
of the wire path (``dist.collectives.compressed_psum``, a shared scale over
the data-parallel ranks; JAX's grid bit for bit), which needs no residual.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten

Tree = Any


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"  # none | bf16 | int8
    error_feedback: bool = True


def quantize(g: torch.Tensor, mode: str, scale: Optional[torch.Tensor] = None):
    """One gradient leaf in the wire format: (bf16 values, None), or (int8
    values, the f32 scale: max |g| / 127 unless given), or (g, None)."""
    if mode == "bf16":
        return g.to(torch.bfloat16), None
    if mode == "int8":
        if scale is None:
            scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q, scale
    return g, None


def dequantize(q: torch.Tensor, scale, mode: str) -> torch.Tensor:
    if mode == "bf16":
        return q.float()
    if mode == "int8":
        return q.float() * scale
    return q


def init_residual(grads_shape: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_shape)


def compress_grads(grads: Tree, residual: Tree, cc: CompressionConfig) -> tuple:
    """Quantize and dequantize each gradient leaf (plus its residual),
    carrying the quantization error into the new residual (zeros without
    error feedback).  Returns (gradients in their dtypes, residual)."""
    if cc.mode == "none":
        return grads, residual
    new_g, new_r = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
        g32 = g.float() + r
        q, scale = quantize(g32, cc.mode)
        deq = dequantize(q, scale, cc.mode)
        new_r.append(g32 - deq if cc.error_feedback else torch.zeros_like(g32))
        new_g.append(deq.to(g.dtype))
    return tree_unflatten(grads, new_g), tree_unflatten(grads, new_r)
