"""Model building blocks (the port's ``repro/models/layers.py``, serve-path
subset): norms, RoPE, the MLPs and the gather-path paged attention.

Conventions carried over from the JAX package: norms compute in f32 and
cast back, RoPE rotates split halves (not interleaved pairs), gelu is the
tanh approximation, and masks use ``-1e30`` rather than ``-inf``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
        / d
    )  # (D/2,)
    ang = positions[..., :, None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: the gather path of the unified serve step
# ---------------------------------------------------------------------------
def paged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    window: int = 0,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention against gathered KV pages with per-slot positions.

    q: (B, S, H, D); k/v: (B, Skv, KH, D) page gather where key j sits at
    sequence position j (``models/cache.paged_gather``); q_positions: (B, S)
    absolute positions, so every slot masks by its own length.  This is the
    unified step's gather path (``fused=False``) and, with ``paged_gather``,
    an oracle for the fused kernel on live rows."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qr = q.reshape(B, S, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float()) * scale
    j = torch.arange(k.shape[1], device=q.device)
    qp = q_positions.long()
    valid = j[None, None, :] <= qp[:, :, None]  # (B, S, Skv)
    if window > 0:
        valid &= (qp[:, :, None] - j[None, None, :]) < window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p / p.sum(dim=-1, keepdim=True), v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def _gelu_tanh(t: torch.Tensor) -> torch.Tensor:
    return F.gelu(t, approximate="tanh")


def mlp(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation in ("swiglu", "geglu"):
        h = x @ params["w1"]
        g = x @ params["w3"]
        act = F.silu if activation == "swiglu" else _gelu_tanh
        h = act(h) * g
    elif activation == "gelu":
        h = _gelu_tanh(x @ params["w1"])
    else:
        raise ValueError(f"mlp does not handle activation={activation!r}")
    return h @ params["w2"]
