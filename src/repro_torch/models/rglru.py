"""RG-LRU recurrent block (the port's ``repro/models/rglru.py``; Griffin /
RecurrentGemma, arXiv:2402.19427).

Structure per block:
    branch a: x -> W_x -> causal depthwise conv1d (width 4) -> RG-LRU
    branch b: x -> W_g -> GeLU
    out     : (a * b) @ W_out

RG-LRU recurrence (per channel, block-diagonal input/recurrence gates, f32):
    r_t = sigmoid(gate_r(u_t));  i_t = sigmoid(gate_i(u_t))
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Three forms, as in JAX:
  * ``rglru``             -- the prefill: a log-depth scan over (a_t, b_t)
    pairs (JAX: ``lax.associative_scan``), here by recursive doubling: after
    the step of offset d each position holds the composition of the d-wide
    window ending at it, so ceil(log2 S) steps of whole-tensor products
    cover the sequence, with no loop over positions.  Not the closed form
    ``exp(cumsum(log a))``: log a reaches about -10.5 a step, so the
    running sum overflows and its differences cancel.
  * ``rglru_scan_ref``    -- the sequential oracle the tests use.
  * ``rglru_decode_step`` -- one token's update.

RG-LRU, the conv and the projections are jnp in JAX, not Pallas: they stay
plain PyTorch here.  Where the JAX decode step returned a new cache, the
port writes ``h`` and the conv state in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_C = 8.0


def _block_gate(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Block-diagonal linear gate: u (..., W) with (heads, W/h, W/h) weights."""
    shape = u.shape
    uh = u.reshape(*shape[:-1], n_heads, shape[-1] // n_heads)
    y = torch.einsum("...hi,hij->...hj", uh, w.to(u.dtype)) + b.to(u.dtype).reshape(n_heads, -1)
    return y.reshape(shape)


def _gates(params: dict, u: torch.Tensor, n_heads: int):
    r = torch.sigmoid(_block_gate(u, params["w_gate_a"], params["b_gate_a"], n_heads))
    i = torch.sigmoid(_block_gate(u, params["w_gate_x"], params["b_gate_x"], n_heads))
    log_a = -_C * F.softplus(params["lam"].float()) * r  # (..., W), <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * u)
    return a, b


def rglru(params: dict, u: torch.Tensor, n_heads: int, h0: Optional[torch.Tensor] = None):
    """u: (B, S, W), upcast to f32 inside; returns (y (B, S, W) in u's dtype,
    h_last (B, W) f32)."""
    a, b = _gates(params, u.float(), n_heads)
    # in place when autograd does not record (serving); under autograd
    # (training), whose backward needs every step's a and b, each step
    # builds new tensors (chip_smoke.py phase 24 times both forms)
    in_place = not b.requires_grad
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    S, d = u.shape[1], 1
    while d < S:
        # (a2, b2) o (a1, b1) = (a2 a1, a2 b1 + b2) with the pair d back
        bd, ad = torch.addcmul(b[:, d:], a[:, d:], b[:, :-d]), a[:, d:] * a[:, :-d]
        if in_place:
            b[:, d:], a[:, d:] = bd, ad
        else:
            b, a = torch.cat([b[:, :d], bd], dim=1), torch.cat([a[:, :d], ad], dim=1)
        d *= 2
    return b.to(u.dtype), b[:, -1].clone()


def rglru_scan_ref(params: dict, u: torch.Tensor, n_heads: int,
                   h0: Optional[torch.Tensor] = None):
    """Sequential oracle for ``rglru``."""
    a, b = _gates(params, u.float(), n_heads)
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0.float()
    hs = []
    for t in range(u.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(u.dtype), h


def rglru_decode_step(params: dict, u1: torch.Tensor, h: torch.Tensor, n_heads: int):
    """u1: (B, W) one step; h: (B, W) carried f32 state."""
    a, b = _gates(params, u1.float(), n_heads)
    h_new = a * h + b
    return h_new.to(u1.dtype), h_new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, W); w: (cw, W); state: (B, cw-1, W).
    Returns (out, the last cw - 1 inputs in x's dtype)."""
    cw = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    new_state = xp[:, -(cw - 1):] if cw > 1 else None
    return out, new_state


def rglru_block(params: dict, x: torch.Tensor, *, n_heads: int, cache: Optional[dict] = None,
                collect: bool = False, tp=None):
    """The recurrent block. x: (B, S, d).  ``cache`` ({"h", "conv"}) is a
    decode step (S == 1), written in place; ``collect`` (prefill) returns a
    new ``{"h", "conv"}`` of the final states.  Returns (y (B, S, d), entry
    or None).

    ``tp`` (a mesh; no cache): tensor parallelism on this rank's W/n
    channels and ``n_heads`` gate heads: ``x`` enters through f
    (``column_input``), ``w_x`` / ``w_g`` are column blocks, the depthwise
    conv and the scan run per channel as they are, ``w_out`` is a row block
    whose partial output g (``row_sum``) sums; the whole per-channel and
    per-head leaves (``conv_w``'s columns, the gates, ``lam``) are read as
    this rank's block (``tp_slice``, whose backward gathers their
    gradients)."""
    if tp is not None:
        from repro_torch.dist.collectives import column_input, tp_slice

        x = column_input(x, mesh=tp)
        params = dict(params)
        for n, dim in (("conv_w", 1), ("w_gate_a", 0), ("b_gate_a", 0), ("w_gate_x", 0),
                       ("b_gate_x", 0), ("lam", 0)):
            params[n] = tp_slice(params[n], dim, mesh=tp)
    u = x @ params["w_x"]
    g = F.gelu(x @ params["w_g"], approximate="tanh")
    u, new_conv = causal_conv1d(u, params["conv_w"], None if cache is None else cache["conv"])
    if cache is None:
        h, h_last = rglru(params, u, n_heads)
    else:
        h1, h_last = rglru_decode_step(params, u[:, 0], cache["h"], n_heads)
        h = h1[:, None]
    y = (h * g) @ params["w_out"]
    if tp is not None:
        from repro_torch.dist.collectives import row_sum

        y = row_sum(y, mesh=tp)
    if cache is not None:
        cache["h"].copy_(h_last)
        cache["conv"].copy_(new_conv)
        return y, cache
    return y, ({"h": h_last, "conv": new_conv} if collect else None)
