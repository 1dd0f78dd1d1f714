"""Plain PyTorch version of the RMSNorm kernel (the port's
``repro/kernels/rmsnorm/ref.py``): f32 compute, cast to x's dtype.  Without
a residual it is the model's norm, ``repro_torch.models.layers.rmsnorm``.
``rmsnorm_backward_ref`` is its backward; ``rmsnorm_backward_split_ref``
sums d(scale) in the backward kernel's fixed order, for the tests."""
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


def rmsnorm_backward_split_ref(x, scale, dy, residual=None, eps: float = 1e-6, *, order,
                               lanes: int = 8):
    """The backward kernel's d(scale) sum, in its order, in f32:
    ``order[cta][group]`` lists the rows each group of lanes takes, in the
    order it takes them (as ``csrc/rmsnorm_bwd.cu`` loops under the launch
    plan); each group adds dy s inv of its rows in turn into its own column
    sums; a CTA's groups are added in group order into its partial row;
    lane l of ``lanes`` adds the partial rows l, l + lanes, ... in order,
    then the lanes are added in order.  dx is ``rmsnorm_backward_ref``'s.
    Returns (dx, d(scale))."""
    dx, _ = rmsnorm_backward_ref(x, scale, dy, residual, eps)
    d = x.shape[-1]
    s = (x.float() if residual is None else x.float() + residual.float()).reshape(-1, d)
    inv = torch.rsqrt(s.square().mean(dim=-1, keepdim=True) + eps)
    terms = dy.float().reshape(-1, d) * s * inv
    zero = torch.zeros(d, dtype=torch.float32)
    parts = []
    for groups in order:
        part = zero
        for rows in groups:
            acc = zero
            for r in rows:
                acc = acc + terms[r]
            part = part + acc
        parts.append(part)
    total = zero
    for lane in range(lanes):
        t = zero
        for p in parts[lane::lanes]:
            t = t + p
        total = total + t
    return dx, total
