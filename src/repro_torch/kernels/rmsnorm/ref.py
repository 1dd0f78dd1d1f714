"""Plain PyTorch version of the RMSNorm kernel (the port's
``repro/kernels/rmsnorm/ref.py``): f32 compute, cast to x's dtype.  Without
a residual it is the model's norm, ``repro_torch.models.layers.rmsnorm``."""
from __future__ import annotations

import torch

from repro_torch.models.layers import rmsnorm


def rmsnorm_ref(x, scale, residual=None, eps: float = 1e-6):
    """RMSNorm of ``x`` (of ``x + residual``, summed in f32) over the last
    axis, times ``1 + scale``."""
    if residual is None:
        return rmsnorm(x, scale, eps)
    return rmsnorm(x.float() + residual.float(), scale, eps).to(x.dtype)


def rmsnorm_backward_ref(x, scale, dy, residual=None, eps: float = 1e-6, *,
                         one_plus: bool = True):
    """The backward of ``rmsnorm_ref``: (dx in x's dtype, d(scale) f32).
    With s = x (+ residual) in f32, r = rsqrt(mean(s^2) + eps), w = 1 +
    scale and g = dy w: dx = r g - s r^3 mean(g s), d(scale) = the sum over
    rows of dy s r; d(residual) is dx.  ``one_plus=False`` takes w = scale:
    the planted fault the card's checks must reject."""
    s = x.float() if residual is None else x.float() + residual.float()
    r = torch.rsqrt(s.square().mean(dim=-1, keepdim=True) + eps)
    w = 1.0 + scale.float() if one_plus else scale.float()
    g = dy.float() * w
    dx = r * g - s * r.pow(3) * (g * s).mean(dim=-1, keepdim=True)
    dscale = (dy.float() * s * r).reshape(-1, s.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale
