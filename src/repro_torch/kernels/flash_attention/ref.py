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
