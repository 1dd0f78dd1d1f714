"""Plain PyTorch version of the flash-attention kernel in the kernel layout
(the port's ``repro/kernels/flash_attention/ref.py``): the exact masked
softmax, scores materialized.  The model-layout plain version, which
``ops.flash_attention`` runs for CPU tensors, is
``repro_torch.models.layers.blocked_attention``."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, n_q_per_kv: int, causal: bool, window: int = 0,
                        prefix: int = 0, softmax_scale: Optional[float] = None):
    """q (BH, Sq, D); k/v (BKH, Sk, D), q row b reading kv row b // n_q_per_kv.
    Returns (BH, Sq, D) in q's dtype."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    kk = torch.repeat_interleave(k, n_q_per_kv, dim=0)
    vv = torch.repeat_interleave(v, n_q_per_kv, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kk.float()) * scale
    iq = torch.arange(Sq, device=q.device)[:, None]
    ik = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        c = iq >= ik
        if prefix > 0:
            c |= ik < prefix
        mask &= c
    if window > 0:
        mask &= (iq - ik) < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bqk,bkd->bqd", p, vv.float()).to(q.dtype)


def flash_attention_mma_ref(q, k, v, *, n_q_per_kv: int, causal: bool, window: int = 0,
                            prefix: int = 0, p_split: bool = True, tile: int = 64):
    """The bf16 tensor-core kernel's numeric scheme in plain PyTorch, kernel
    layout as ``flash_attention_ref``: bf16 q k^T summed in f32, an f32
    online softmax over ``tile``-key tiles, l summed from the f32 p, and P V
    with P as bf16 hi + lo (hi = bf16(p), lo = bf16(p - hi)), or, with
    ``p_split=False``, P rounded once to bf16.  Returns q's dtype."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    kk = torch.repeat_interleave(k, n_q_per_kv, dim=0).float()
    vv = torch.repeat_interleave(v, n_q_per_kv, dim=0).float()
    qf = q.float()
    iq = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((BH, Sq, 1), -math.inf, device=q.device)
    l = torch.zeros((BH, Sq, 1), device=q.device)
    acc = torch.zeros((BH, Sq, D), device=q.device)
    for t0 in range(0, Sk, tile):
        ik = torch.arange(t0, min(Sk, t0 + tile), device=q.device)[None, :]
        mask = torch.ones((Sq, ik.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= (iq >= ik) | (ik < prefix)
        if window > 0:
            mask &= (iq - ik) < window
        s = torch.einsum("bqd,bkd->bqk", qf, kk[:, t0:t0 + tile]) * scale
        s = torch.where(mask[None], s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        base = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - base)
        corr = torch.exp(m - base)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vv[:, t0:t0 + tile]
        if p_split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vv[:, t0:t0 + tile]
        acc = acc * corr + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


# ---------------------------------------------------------------- training
def attention_mask(Sq: int, Sk: int, causal: bool, window: int, prefix: int,
                   device=None) -> torch.Tensor:
    """(Sq, Sk) bool: query i sees key j (JAX's ``backward._mask``)."""
    iq = torch.arange(Sq, device=device)[:, None]
    ik = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        c = iq >= ik
        if prefix > 0:
            c |= ik < prefix
        m &= c
    if window > 0:
        m &= (iq - ik) < window
    return m


def _scores(q, k, G, causal, window, prefix, scale):
    """Masked f32 scores (BH, Sq, Sk), kernel layout."""
    kk = torch.repeat_interleave(k, G, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kk.float()) * scale
    mask = attention_mask(q.shape[1], k.shape[1], causal, window, prefix, q.device)
    return torch.where(mask[None], s, NEG_INF)


def fwd_with_lse(q, k, v, *, n_q_per_kv: int, causal: bool, window: int = 0,
                 prefix: int = 0, scale: Optional[float] = None):
    """JAX's ``backward._fwd_with_lse``, kernel layout: (out in q's dtype,
    the f32 logsumexp of every row's scaled scores (BH, Sq), natural log)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, n_q_per_kv, causal, window, prefix, scale)
    m = s.amax(dim=-1)
    lse = m + torch.log(torch.exp(s - m[..., None]).sum(dim=-1))
    p = torch.exp(s - lse[..., None])
    vv = torch.repeat_interleave(v, n_q_per_kv, dim=0)
    return torch.einsum("bqk,bkd->bqd", p, vv.float()).to(q.dtype), lse


def vjp_bwd(q, k, v, o, lse, do, *, n_q_per_kv: int, causal: bool, window: int = 0,
            prefix: int = 0, scale: Optional[float] = None, drop_delta: bool = False,
            fold_first_only: bool = False, split: Optional[bool] = None):
    """JAX's ``backward._vjp_bwd``, kernel layout: (dq, dk, dv) in the
    inputs' dtypes, from the saved (q, k, v, o, lse) and the output's
    gradient ``do``.  P is recomputed from q, k and ``lse``; delta =
    rowsum(do * o); dS = P (dO V^T - delta); dV = P^T dO, dQ = dS K scale,
    dK = dS^T Q scale; the G query heads of a kv head are summed onto it.
    Every product in f32, or, with ``split``, the bf16 tensor-core
    kernel's scheme: P and dS enter dV, dQ and dK as bf16 hi + lo (hi =
    bf16(x), lo = bf16(x - hi)), or rounded once to bf16 with ``split=
    False``.  ``drop_delta`` and ``fold_first_only`` (only the first query
    head of each group folded) plant the faults the card's checks must
    reject."""
    G = n_q_per_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    q32, do32, o32 = q.float(), do.float(), o.float()
    kk = torch.repeat_interleave(k, G, dim=0).float()
    vv = torch.repeat_interleave(v, G, dim=0).float()
    p = torch.exp(_scores(q, k, G, causal, window, prefix, scale) - lse[..., None].float())
    dp = torch.einsum("bqd,bkd->bqk", do32, vv)
    delta = 0.0 if drop_delta else (do32 * o32).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)

    def product(eq, x, y):
        if split is None:
            return torch.einsum(eq, x, y)
        hi = x.to(torch.bfloat16).float()
        out = torch.einsum(eq, hi, y)
        return out + torch.einsum(eq, (x - hi).to(torch.bfloat16).float(), y) if split else out

    dv_full = product("bqk,bqd->bkd", p, do32)
    dq = product("bqk,bkd->bqd", ds, kk) * scale
    dk_full = product("bqk,bqd->bkd", ds, q32) * scale
    BKH = k.shape[0]

    def fold(x):
        x = x.reshape(BKH, G, *x.shape[1:])
        return x[:, 0] if fold_first_only else x.sum(dim=1)

    return dq.to(q.dtype), fold(dk_full).to(k.dtype), fold(dv_full).to(v.dtype)


def _to_kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, S, heads, D) -> (B * heads, S, D)."""
    B, S, n, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * n, S, D)


def _to_model_layout(x: torch.Tensor, B: int) -> torch.Tensor:
    """(B * heads, S, D) -> (B, S, heads, D)."""
    n = x.shape[0] // B
    return x.reshape(B, n, *x.shape[1:]).permute(0, 2, 1, 3)


def flash_forward_lse_ref(q, k, v, *, causal: bool = True, window: int = 0, prefix: int = 0):
    """``fwd_with_lse`` in the model layout: q (B, Sq, H, D), k/v (B, Sk,
    KH, D) -> (out (B, Sq, H, D), lse (B, H, Sq) f32)."""
    B, Sq, H, _ = q.shape
    o, lse = fwd_with_lse(_to_kernel_layout(q), _to_kernel_layout(k), _to_kernel_layout(v),
                          n_q_per_kv=H // k.shape[2], causal=causal, window=window,
                          prefix=prefix)
    return _to_model_layout(o, B), lse.reshape(B, H, Sq)


def flash_backward_ref(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
                       prefix: int = 0, **controls):
    """``vjp_bwd`` in the model layout (lse (B, H, Sq)): the plain version
    of the CUDA backward kernel.  Returns (dq, dk, dv) in the model layout,
    contiguous."""
    B, Sq, H, _ = q.shape
    kl = _to_kernel_layout
    dq, dk, dv = vjp_bwd(kl(q), kl(k), kl(v), kl(o), lse.reshape(B * H, Sq), kl(do),
                         n_q_per_kv=H // k.shape[2], causal=causal, window=window,
                         prefix=prefix, **controls)
    return tuple(_to_model_layout(x, B).contiguous() for x in (dq, dk, dv))


def flash_backward_mma_ref(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
                           prefix: int = 0, split: bool = True):
    """What the bf16 backward kernel computes, up to the order of its f32
    sums: ``flash_backward_ref`` with P and dS as bf16 hi + lo in their
    products (``split=False``: rounded once)."""
    return flash_backward_ref(q, k, v, o, lse, do, causal=causal, window=window, prefix=prefix,
                              split=split)
