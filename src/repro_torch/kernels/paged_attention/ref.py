"""Plain PyTorch version of the paged-attention kernel (the port's
``repro/kernels/paged_attention/ref.py``).

Same contract as the CUDA kernel (pool entry + block table + per-slot
lens/q_lens), but it does what the kernel exists to avoid: materializes the
dense gather and runs an exact masked softmax over it.  ``ops`` calls it for
CPU tensors; ``chip_smoke.py`` holds the kernel against it on the card.
``paged_attention_split_ref`` emulates the tensor-core kernel's arithmetic
for bf16 q with bf16 or int8 pages (splits over keys, f32 partials, P as
bf16 hi + lo, int8 scales on S and P) for the tests and the planted
controls.
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


# The tensor-core kernel's schedule (csrc/paged_attention.cu, namespace tc).
TILE = 64  # keys a tile
DEC_ROWS = 16  # rows of a decode item: one mma row block
WARPS = 4


def _partial(qr, kr, vr, pos, chunks, window, scale2, p_split, ksc=None, vsc=None):
    """The online softmax of one warp (or CTA row block) over ``chunks``
    (key position tensors, in order): qr (KH, R, D), kr/vr (KH, S, D) f32,
    pos (R,) absolute row positions.  Scores in log2 units, masked ones
    -inf, l from the f32 p, P V with P as bf16 hi + lo (or rounded once).
    int8 pages: kr/vr hold the integer values and ksc/vsc (KH, S) their
    scales: S = (q . k) k_scale, and P' = P v_scale is what P V splits.
    Returns (m, l, acc): (KH, R), (KH, R), (KH, R, D)."""
    KH, R, D = qr.shape
    m = torch.full((KH, R), -math.inf, device=qr.device)
    l = torch.zeros((KH, R), device=qr.device)
    acc = torch.zeros((KH, R, D), device=qr.device)
    for idx in chunks:
        s = torch.einsum("hrd,hkd->hrk", qr, kr[:, idx])
        if ksc is not None:
            s = s * ksc[:, None, idx]
        s = s * scale2
        ok = idx[None] <= pos[:, None]
        if window > 0:
            ok &= (pos[:, None] - idx[None]) < window
        s = torch.where(ok[None], s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        base = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp2(s - base[..., None])
        corr = torch.exp2(m - base)
        l = l * corr + p.sum(dim=-1)
        if vsc is not None:
            p = p * vsc[:, None, idx]
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vr[:, idx]
        if p_split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vr[:, idx]
        acc = acc * corr[..., None] + pv
        m = m_new
    return m, l, acc


def _merge(parts):
    """(m, l, acc) partials merged in the order given."""
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    base = torch.where(torch.isinf(mx), 0.0, mx)
    lt = sum(torch.exp2(m - base) * l for m, l, _ in parts)
    at = sum(torch.exp2(m - base)[..., None] * a for m, _, a in parts)
    return mx, lt, at


def paged_attention_split_ref(
    q: torch.Tensor,
    entry: dict,
    table: torch.Tensor,
    lens: torch.Tensor,
    q_lens: torch.Tensor,
    *,
    block_size: int,
    window: int = 0,
    split: int = 512,
    p_split: bool = True,
    drop_split: Optional[int] = None,
) -> torch.Tensor:
    """The bf16-q tensor-core kernel's arithmetic in plain PyTorch (CPU,
    same contract as ``paged_attention_ref``), for bf16 or int8 pages.  A
    slot whose G * q_len rows fit one 16-row block is a decode slot: its
    keys are cut at absolute multiples of ``split``; in each split the four
    warps take a quarter of every 64-key tile each (own online softmax),
    merged in warp order, and the splits' f32 partials are merged in split
    order.  Other slots run one online softmax a row over 64-key tiles.
    int8 pages enter the products as their integer values (exact in bf16),
    with k_scale on S's columns and v_scale on P before its split.
    ``p_split=False`` rounds P (P') once to bf16; ``drop_split`` leaves that
    split index out of every merge (both planted controls).  Returns q's
    dtype; dead rows are 0."""
    B, W, H, D = q.shape
    KH = entry["k"].shape[2]
    G = H // KH
    MB = table.shape[1]
    scale2 = 1.0 / math.sqrt(D) * math.log2(math.e)
    k, v = paged_gather({"k": entry["k"], "v": entry["v"]}, table, block_size, MB)
    quant = "k_scale" in entry
    if quant:  # (B, MB*bs, KH, 1) scales beside the integer pages
        ks, vs = paged_gather({"k": entry["k_scale"], "v": entry["v_scale"]}, table,
                              block_size, MB)
    dev = q.device
    out = torch.zeros((B, W, H, D), dtype=torch.float32, device=dev)
    lens, q_lens = lens.tolist(), q_lens.tolist()
    for b in range(B):
        base, nq = int(lens[b]), int(q_lens[b])
        hi = min(base + nq - 1, MB * block_size - 1)
        lo = max(0, base - window + 1) if window > 0 else 0
        if nq == 0 or hi < lo:
            continue
        qr = q[b, :nq].float().reshape(nq, KH, G, D).permute(1, 0, 2, 3).reshape(KH, nq * G, D)
        pos = base + torch.arange(nq * G, device=dev) // G
        kr = k[b].float().permute(1, 0, 2)  # (KH, S, D)
        vr = v[b].float().permute(1, 0, 2)
        sc = (ks[b, :, :, 0].T, vs[b, :, :, 0].T) if quant else (None, None)  # (KH, S)
        if G * nq <= DEC_ROWS:
            parts = []
            for s in range(lo // split, hi // split + 1):
                k_lo, k_hi = max(lo, s * split), min(hi, (s + 1) * split - 1)
                tiles = range(k_lo // TILE * TILE, k_hi + 1, TILE)
                warps = []
                for w in range(WARPS):  # warp w: keys 16 w .. 16 w + 15 of every tile
                    spans = [(max(k_lo, t + 16 * w), min(k_hi + 1, t + 16 * w + 16)) for t in tiles]
                    chunks = [torch.arange(a, e, device=dev) for a, e in spans if e > a]
                    warps.append(_partial(qr, kr, vr, pos, chunks, window, scale2, p_split,
                                          *sc))
                if s != drop_split:
                    parts.append(_merge(warps))
            if not parts:
                continue
            _, lt, at = _merge(parts)
        else:
            chunks = [torch.arange(t, min(hi + 1, t + TILE), device=dev)
                      for t in range(lo // TILE * TILE, hi + 1, TILE)]
            _, lt, at = _partial(qr, kr, vr, pos, chunks, window, scale2, p_split, *sc)
        o = at / torch.clamp(lt, min=1e-30)[..., None]  # (KH, nq*G, D)
        out[b, :nq] = o.reshape(KH, nq, G, D).permute(1, 0, 2, 3).reshape(nq, H, D)
    return out.to(q.dtype)
