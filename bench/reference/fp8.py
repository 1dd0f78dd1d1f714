"""Matrix products of the references, in float32 or in float8.

``mm(a, b, prec)``: ``prec="f32"`` is a plain float32 product (TF32 off:
``strict_f32`` sets it); ``prec="fp8"`` rounds both operands to float8 e4m3
with a per-tensor scale (amax to 448, the format's largest) and, in the
backward, the incoming gradient to e5m2 (amax to 57344) before the same
products: the usual recipe of float8 training, and the precision the
benchmark's control computes in.  ``prec="bf16"`` rounds the operands
(forward and backward) to bfloat16 the same way, a witness of what the
configuration's own precision does to a reading."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def strict_f32() -> None:
    """float32 products stay float32 (no TF32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def quantize(x: torch.Tensor, fmt=torch.float8_e4m3fn, fmax: float = E4M3_MAX) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under one scale for the tensor, back in f32;
    the gradient passes straight through."""
    x = x.float()
    with torch.no_grad():
        s = fmax / x.abs().amax().clamp(min=1e-30)
        q = (x * s).to(fmt).float() / s
    return x + (q - x).detach() if x.requires_grad else q


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.bfloat16).float()


class _MM8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, half=False):
        a8, b8 = (_bf16(a), _bf16(b)) if half else (quantize(a), quantize(b))
        ctx.save_for_backward(a8, b8)
        ctx.half = half
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g5 = _bf16(g) if ctx.half else quantize(g, torch.float8_e5m2, E5M2_MAX)
        ga = g5 @ b8.transpose(-1, -2)
        gb = a8.transpose(-1, -2) @ g5
        # broadcast batch dimensions of b are summed back
        while gb.dim() > b8.dim():
            gb = gb.sum(0)
        return ga, gb, None


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    if prec == "f32":
        return a.float() @ b.float()
    if prec in ("fp8", "bf16"):
        return _MM8.apply(a, b, prec == "bf16")
    raise ValueError(f"precision {prec!r} (f32, bf16 or fp8)")
