"""Plain PyTorch version of the MM PU kernel (the port's
``repro/kernels/mm_pu/ref.py``), and the per-output-channel int8 weight
quantizer of the paper's int8 deployment mode."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")
    if activation == "silu":
        return F.silu(x)
    if activation == "relu":
        return F.relu(x)
    if activation == "relu2":
        return torch.square(F.relu(x))
    return x


def mm_pu_ref(x, w, *, bias=None, residual=None, w_scale=None, activation="none",
              out_dtype=None):
    """``act((x @ (w * w_scale)) + bias) + residual`` in f32, cast to
    ``out_dtype`` (x's dtype by default)."""
    out_dtype = out_dtype or x.dtype
    wf = w.float()
    if w_scale is not None:
        wf = wf * w_scale.float()
    r = x.float() @ wf
    if bias is not None:
        r = r + bias.float()
    r = _act(r, activation)
    if residual is not None:
        r = r + residual.float()
    return r.to(out_dtype)


def quantize_weights_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8: ``(q (K, N) int8, scale (1, N)
    f32)`` with ``w ~ q * scale``; computed in w's dtype, rounding half to
    even, clipped to +-127."""
    scale = torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.float()
