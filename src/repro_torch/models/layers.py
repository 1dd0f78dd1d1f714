"""Model building blocks (the port's ``repro/models/layers.py``): norms,
RoPE and sinusoidal positions, the MLPs, the blocked online-softmax
attention of the prefill (the plain version of the flash kernel) and its
cross-attention form, one-token attention over a dense cache, the
gather-path paged attention, and the Megatron-SP gather / scatter
matmuls and MLP (``sp_*``, over ``dist.collectives``).

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


def sinusoidal_positions(seq_len: int, d_model: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """(seq_len, d_model) f32 table of positions ``offset .. offset +
    seq_len - 1``: sines of the even frequencies, then their cosines."""
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Blocked online-softmax attention: the plain version of the flash kernel
# ---------------------------------------------------------------------------
def _chunk_scores(qi: torch.Tensor, kj: torch.Tensor, softmax_scale: float) -> torch.Tensor:
    # qi: (B, qc, KH, G, D); kj: (B, kc, KH, D) -> (B, KH, G, qc, kc)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qi.float(), kj.float())
    return s * softmax_scale


def _chunk_mask(q_off: int, k_off: int, qc: int, kc: int, causal: bool, window: int,
                prefix_len: int = 0, device=None) -> torch.Tensor:
    iq = q_off + torch.arange(qc, device=device)[:, None]
    ik = k_off + torch.arange(kc, device=device)[None, :]
    m = torch.ones((qc, kc), dtype=torch.bool, device=device)
    if causal:
        c = iq >= ik
        if prefix_len > 0:  # prefix-LM: the prefix attends bidirectionally
            c |= ik < prefix_len
        m &= c
    if window > 0:
        m &= (iq - ik) < window
    return m


def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    q_chunk: int = 512,
    k_chunk: int = 512,
    softmax_scale: Optional[float] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D); GQA via H = KH * G.

    Online softmax over k-chunks inside a loop over q-chunks (the JAX
    version's two ``lax.scan``s): peak temp is O(qc * kc) per head.  Every
    k-chunk is visited, masked ones included, exactly as in JAX; a row's
    masked keys get weight 0 once any key of the row is visible."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    if H % KH:
        raise ValueError(f"heads H={H} not a multiple of kv heads KH={KH}")
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qc, kc = min(q_chunk, Sq), min(k_chunk, Sk)
    while Sq % qc:
        qc //= 2
    while Sk % kc:
        kc //= 2
    dev = q.device
    out = []
    for q_off in range(0, Sq, qc):
        qi = q[:, q_off:q_off + qc].reshape(B, qc, KH, G, D)
        m = torch.full((B, KH, G, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KH, G, qc), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KH, G, qc, D), dtype=torch.float32, device=dev)
        for k_off in range(0, Sk, kc):
            s = _chunk_scores(qi, k[:, k_off:k_off + kc], scale)
            mask = _chunk_mask(q_off, k_off, qc, kc, causal, window, prefix_len, dev)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, k_off:k_off + kc].float())
            o = o * corr[..., None] + pv
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-30)
        out.append(o.permute(0, 3, 1, 2, 4).reshape(B, qc, H, D))
    return torch.cat(out, dim=1).to(q.dtype)


def plain_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_chunk: int = 512) -> torch.Tensor:
    """Bidirectional cross-attention (decoder -> encoder memory): the plain
    version of the flash kernel with ``causal=False`` and Sq != Sk."""
    return blocked_attention(q, k, v, causal=False, window=0, q_chunk=q_chunk,
                             k_chunk=k.shape[1])


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: int,
    *,
    window: int = 0,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention against a dense cache.

    q: (B, 1, H, D); caches: (B, S, KH, D); ``cur_len`` the filled length
    (the new token sits at slot cur_len - 1)."""
    B, _, H, D = q.shape
    _, S, KH, _ = k_cache.shape
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qr = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(), k_cache.float()) * scale
    idx = torch.arange(S, device=q.device)
    valid = idx < cur_len
    if window > 0:
        valid &= idx >= (cur_len - window)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhgk,bkhd->bhgd", p / p.sum(dim=-1, keepdim=True), v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


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


# ---------------------------------------------------------------------------
# Megatron-SP primitives (on this rank's shards; ``dist.collectives``).
#
# The sequence-parallel residual lives sequence-sharded over the `model`
# axis; the pair below is each stage's collective envelope: one ring
# gather-matmul on the way up, one reduce-scatter on the way down, so the
# SP layer stack makes no all-gather.
# ---------------------------------------------------------------------------
def sp_gather_matmul(x_local: torch.Tensor, w_shard: torch.Tensor, axis: str, n_shards: int,
                     *, mesh) -> torch.Tensor:
    """Seq-sharded ``x_local`` (B, S/n, D) times the column shard ``w_shard``
    (D, N/n) -> full-sequence (B, S, N/n), S gathered over the ring."""
    from repro_torch.dist.collectives import ring_gather_matmul

    return ring_gather_matmul(x_local, w_shard, axis, n_shards, gather_dim=1, mesh=mesh)


def sp_scatter_matmul(x_full: torch.Tensor, w_shard: torch.Tensor, axis: str, *,
                      mesh) -> torch.Tensor:
    """Row-parallel tail: full-sequence partials ``x_full`` (B, S, K/n) times
    ``w_shard`` (K/n, D), summed over ``axis`` and handed back as this rank's
    sequence chunk (B, S/n, D) in one reduce-scatter."""
    from repro_torch.dist.collectives import seq_scatter

    return seq_scatter(x_full @ w_shard, axis, scatter_dim=1, mesh=mesh)


def sp_mlp(params: dict, x_local: torch.Tensor, activation: str, axis: str, n_shards: int,
           *, mesh) -> torch.Tensor:
    """The FFN stage under Megatron-SP: one ring gather feeds the (w1 | w3)
    column shards, one reduce-scatter returns the row-parallel w2 product to
    the seq-sharded residual.  ``mlp`` up to the f32 reduction order."""
    if activation in ("swiglu", "geglu"):
        w13 = torch.cat([params["w1"], params["w3"]], dim=-1)
        hg = sp_gather_matmul(x_local, w13, axis, n_shards, mesh=mesh)
        h, g = torch.split(hg, [params["w1"].shape[-1], params["w3"].shape[-1]], dim=-1)
        act = F.silu if activation == "swiglu" else _gelu_tanh
        h = act(h) * g
    elif activation == "gelu":
        h = _gelu_tanh(sp_gather_matmul(x_local, params["w1"], axis, n_shards, mesh=mesh))
    else:
        raise ValueError(f"sp_mlp does not handle activation={activation!r}")
    return sp_scatter_matmul(h, params["w2"], axis, mesh=mesh)
