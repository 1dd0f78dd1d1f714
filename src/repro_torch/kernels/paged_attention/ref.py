"""Plain PyTorch version of the paged-attention kernel (the port's
``repro/kernels/paged_attention/ref.py``).

Same contract as the CUDA kernel (pool entry + block table + per-slot
lens/q_lens), but it does what the kernel exists to avoid: materializes the
dense gather and runs an exact masked softmax over it.  ``ops`` calls it for
CPU tensors; ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.cache import paged_gather

NEG_INF = -1e30


def paged_attention_ref(
    q: torch.Tensor,
    entry: dict,
    table: torch.Tensor,
    lens: torch.Tensor,
    q_lens: torch.Tensor,
    *,
    block_size: int,
    window: int = 0,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, W, H, D); entry: paged pool entry (models/cache layout);
    table: (B, MB) int32; lens: (B,) positions already cached per slot;
    q_lens: (B,) live query rows per slot (0 idle / 1 decode / <=W prefill).

    Query row i of slot b sits at absolute position ``lens[b] + i`` and is
    live iff ``i < q_lens[b]``; dead rows return zeros."""
    k, v = paged_gather(entry, table, block_size)  # (B, Skv, KH, D)
    valid = paged_mask(lens, q_lens, q.shape[1], k.shape[1], window)
    return masked_attention(q, k, v, valid, softmax_scale)


def paged_mask(lens: torch.Tensor, q_lens: torch.Tensor, W: int, Skv: int,
               window: int = 0) -> torch.Tensor:
    """(B, W, Skv) bool: key j is visible to query row i of slot b (causal,
    live row, and inside the sliding window when ``window > 0``)."""
    dev = lens.device
    i = torch.arange(W, device=dev)
    pos = lens.long()[:, None] + i[None, :]  # (B, W)
    j = torch.arange(Skv, device=dev)
    valid = j[None, None, :] <= pos[:, :, None]
    valid &= (i[None, :] < q_lens.long()[:, None])[..., None]
    if window > 0:
        valid &= (pos[:, :, None] - j[None, None, :]) < window
    return valid


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact f32 softmax attention of q (B, W, H, D) over dense k/v
    (B, Skv, KH, D) where ``valid`` (B, W, Skv) allows; rows with no valid
    key are zeros."""
    B, W, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qr = q.reshape(B, W, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float()) * scale
    vm = valid[:, None, None]  # (B, 1, 1, W, Skv)
    s = torch.where(vm, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vm, torch.exp(s - m), 0.0)  # dead rows stay exactly zero
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p / l, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, W, H, D).to(q.dtype)
