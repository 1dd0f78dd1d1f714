"""Sequential plain version of the WKV kernel in the kernel layout (the
port's ``repro/kernels/rwkv6/ref.py``).  The model-layout plain version,
which ``ops.wkv`` runs for CPU tensors, is ``repro_torch.models.rwkv6.
wkv_chunked``."""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, logw, u, *, n_heads: int):
    """r/k/v/logw: (BH, S, D) with BH = B * n_heads; u: (H, D).
    Returns (BH, S, D) in r's dtype."""
    BH, S, D = r.shape
    B = BH // n_heads
    w = torch.exp(logw.float())
    uu = u.float().repeat(B, 1)  # (BH, D): row b * H + h is u[h]
    r32, k32, v32 = r.float(), k.float(), v.float()
    state = torch.zeros((BH, D, D), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = k32[:, t, :, None] * v32[:, t, None, :]
        outs.append(torch.einsum("bk,bkd->bd", r32[:, t], state + uu[:, :, None] * kv))
        state = w[:, t, :, None] * state + kv
    return torch.stack(outs, dim=1).to(r.dtype)
