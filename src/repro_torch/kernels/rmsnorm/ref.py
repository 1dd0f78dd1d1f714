"""Plain PyTorch version of the RMSNorm kernel (the port's
``repro/kernels/rmsnorm/ref.py``): f32 compute, cast to x's dtype.  Without
a residual it is the model's norm, ``repro_torch.models.layers.rmsnorm``."""
from __future__ import annotations

from repro_torch.models.layers import rmsnorm


def rmsnorm_ref(x, scale, residual=None, eps: float = 1e-6):
    """RMSNorm of ``x`` (of ``x + residual``, summed in f32) over the last
    axis, times ``1 + scale``."""
    if residual is None:
        return rmsnorm(x, scale, eps)
    return rmsnorm(x.float() + residual.float(), scale, eps).to(x.dtype)
