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
