"""RWKV-6 "Finch" time-mix and channel-mix (the port's
``repro/models/rwkv6.py``; arXiv:2404.05892): data-dependent decay WKV.

Per head (d_k = d_v = d_head), with decay w_t in (0,1) per channel and bonus u:

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Three forms of the recurrence:
  * ``wkv_scan_ref``   — sequential oracle (tests).
  * ``wkv_chunked``    — chunked parallel form in log-decay space with the
    state carried across chunks: the plain version of the CUDA WKV kernel
    (``repro_torch/kernels/rwkv6``), which the time-mix calls.
  * ``wkv_decode_step`` — one token's state update (plain torch, as in JAX).

Where the JAX decode step returned a new cache, the port writes the state,
the token-shift rows and the channel-mix row in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import ops as wkv_ops


# ---------------------------------------------------------------------------
# WKV core
# ---------------------------------------------------------------------------
def wkv_scan_ref(r, k, v, w, u):
    """Sequential oracle.  r/k/v: (B, S, H, D); w: (B, S, H, D) decay in
    (0,1); u: (H, D) bonus.  Returns (B, S, H, D) f32."""
    B, S, H, D = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    state = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, D, D)
        outs.append(torch.einsum("bhk,bhkd->bhd", r[:, t], state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1)


def wkv_chunked(r, k, v, w, u, chunk: int = 32, state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Chunked parallel WKV.  Same signature and semantics as the oracle, f32
    out; ``state`` (B, H, D, D) is the state before the first token (zero by
    default), and ``return_state`` also returns the state after the last.

    Within a chunk (length c), with L_t = sum_{m<=t} log w_m (per channel):
      intra: o_t += sum_{j<t} (r_t * exp(L_{t-1} - L_j))^T k_j v_j^T, as a
             masked (c x c) product over D with decay-ratio weights
      bonus: o_t += (r_t * u)^T k_t v_t            (the j = t term)
      cross: o_t += (r_t * exp(L_{t-1})) @ S_prev
      carry: S = diag(exp(L_c)) S_prev + sum_j (k_j exp(L_c - L_j)) v_j^T
    """
    B, S, H, D = r.shape
    c = min(chunk, S)
    while S % c:
        c //= 2
    N = S // c
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    logw = torch.log(torch.clamp(w, min=1e-12)).reshape(B, N, c, H, D)
    rr, kk, vv = (t.reshape(B, N, c, H, D) for t in (r, k, v))
    L = torch.cumsum(logw, dim=2)  # inclusive cumulative log decay
    Lc = L[:, :, -1]  # (B, N, H, D) total chunk decay
    Lq = L - logw  # L_{t-1}: decay accumulated before t
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    S_state = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
               if state is None else state.float())
    outs = []
    for n in range(N):
        Li, Lqi, Lci = L[:, n], Lq[:, n], Lc[:, n]
        ri, ki, vi = rr[:, n], kk[:, n], vv[:, n]
        # exp(L_{t-1} - L_j), j < t: the exponent is <= 0 wherever the mask
        # is true, so this form never overflows (the factored
        # exp(L) * exp(-L) form does for strong decays).
        delta = Lqi[:, :, None] - Li[:, None]  # (B, t, s, H, D)
        delta = torch.where(mask[None, :, :, None, None], delta, -torch.inf)
        att = torch.einsum("bthd,bshd,btshd->bhts", ri, ki, torch.exp(delta))
        o = torch.einsum("bhts,bshd->bthd", att, vi)
        rdec = ri * torch.exp(Lqi)  # r_t * exp(L_{t-1}), exponent <= 0
        o = o + torch.einsum("bthd,bthd,bthe->bthe", ri * u[None, None], ki, vi)
        o = o + torch.einsum("bthk,bhkd->bthd", rdec, S_state)
        kfut = ki * torch.exp(Lci[:, None] - Li)  # decay from j to chunk end
        S_state = torch.exp(Lci)[..., None] * S_state + torch.einsum(
            "bshk,bshd->bhkd", kfut, vi
        )
        outs.append(o)
    out = torch.stack(outs, dim=1).reshape(B, S, H, D)
    if return_state:
        return out, S_state
    return out


def wkv_decode_step(r1, k1, v1, w1, u, S_state):
    """One token.  r1/k1/v1/w1: (B, H, D); S_state: (B, H, D, D).
    Returns (out (B, H, D) f32, new state)."""
    r1, k1, v1, w1 = (t.float() for t in (r1, k1, v1, w1))
    kv = k1[..., :, None] * v1[..., None, :]
    out = torch.einsum("bhk,bhkd->bhd", r1, S_state + u.float()[None, :, :, None] * kv)
    return out, w1[..., :, None] * S_state + kv


# ---------------------------------------------------------------------------
# Full time-mix and channel-mix blocks
# ---------------------------------------------------------------------------
def _token_shift(x: torch.Tensor, mix: torch.Tensor, x_prev: Optional[torch.Tensor] = None):
    """lerp(x, shift(x), mix).  x: (B, S, d); x_prev: (B, d) decode state."""
    if x_prev is None:
        shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        shifted = torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return x + (shifted - x) * mix.to(x.dtype)


def _tp_time_mix(params: dict, x: torch.Tensor, tp):
    """The time-mix's inputs on this rank's heads (``rwkv6_time_mix``'s
    ``tp``): ``x`` enters through f (``column_input``) once; the token-shift
    weights and ``lora_a``, read before the column split, get their partial
    gradients summed by an f each (a d-vector's or (d, lora)'s all-reduce,
    not one of each shifted (B, S, d) activation); the whole per-head leaves
    (``w0``, ``u``, the group norm, ``lora_b``'s columns) are read as this
    rank's block (``tp_slice``)."""
    from repro_torch.dist.collectives import column_input, tp_slice

    p = dict(params)
    for n in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "lora_a"):
        p[n] = column_input(params[n], mesh=tp)
    for n, dim in (("w0", 0), ("u", 0), ("gn_scale", 0), ("gn_bias", 0), ("lora_b", 1)):
        p[n] = tp_slice(params[n], dim, mesh=tp)
    return p, column_input(x, mesh=tp)


def rwkv6_time_mix(params: dict, x: torch.Tensor, *, n_heads: int, d_head: int,
                   cache: Optional[dict] = None, chunk: int = 32, collect: bool = False,
                   fused: bool = True, tp=None):
    """x: (B, S, d).  cache: {"S": (B,H,D,D), "shift": (B,d)} or None.
    Returns (y (B,S,d), new_cache): with ``cache`` (one decode token) the
    cache is updated in place and returned; with ``collect`` (prefill) a new
    one is built from the pass.  ``fused`` runs the WKV through its kernel
    wrapper (``ops.wkv``); False runs the plain ``wkv_chunked`` on any
    device, the oracle the kernel path is held to.

    ``tp`` (a mesh; no cache): tensor parallelism on this rank's ``n_heads``
    of the whole, the column blocks of ``w_r`` / ``w_k`` / ``w_v`` /
    ``w_g`` and the row block of ``w_o`` (``_tp_time_mix``); the WKV and the
    per-head group norm run on those heads, and g (``row_sum``) sums
    ``w_o``'s partial output."""
    B, S, d = x.shape
    H, D = n_heads, d_head
    if tp is not None:
        params, x = _tp_time_mix(params, x, tp)
    shift_state = None if cache is None else cache["shift"]

    xr = _token_shift(x, params["mix_r"], shift_state)
    xk = _token_shift(x, params["mix_k"], shift_state)
    xv = _token_shift(x, params["mix_v"], shift_state)
    xg = _token_shift(x, params["mix_g"], shift_state)
    xw = _token_shift(x, params["mix_w"], shift_state)

    r = (xr @ params["w_r"]).reshape(B, S, H, D)
    k = (xk @ params["w_k"]).reshape(B, S, H, D)
    v = (xv @ params["w_v"]).reshape(B, S, H, D)
    g = F.silu(xg @ params["w_g"])
    # data-dependent decay via a low-rank adapter (Finch), in f32
    dw = torch.tanh(xw.float() @ params["lora_a"]) @ params["lora_b"]
    logit = params["w0"].float() + dw  # (B, S, H*D)
    w = torch.exp(-torch.exp(logit)).reshape(B, S, H, D)  # in (0, 1)

    new_cache = None
    if cache is None:
        wkv = wkv_ops.wkv if fused else wkv_chunked
        if collect:
            o, S_last = wkv(r, k, v, w, params["u"], chunk=chunk, return_state=True)
            new_cache = {"S": S_last, "shift": x[:, -1].float()}
        else:
            o = wkv(r, k, v, w, params["u"], chunk=chunk)
    else:
        o1, S_new = wkv_decode_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], params["u"],
                                    cache["S"])
        o = o1[:, None]
        cache["S"].copy_(S_new)
        cache["shift"].copy_(x[:, -1])
        new_cache = cache

    # per-head group norm of the wkv output (RWKV-6 normalises each head)
    o = o.reshape(B, S, H, D)
    mu = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, unbiased=False, keepdim=True)
    o = (o - mu) * torch.rsqrt(var + 1e-5)
    o = o * params["gn_scale"].reshape(H, D) + params["gn_bias"].reshape(H, D)
    o = o.reshape(B, S, H * D).to(x.dtype) * g.to(x.dtype)
    y = o @ params["w_o"]
    if tp is not None:
        from repro_torch.dist.collectives import row_sum

        y = row_sum(y, mesh=tp)
    return y, new_cache


def rwkv6_channel_mix(params: dict, x: torch.Tensor, cache: Optional[torch.Tensor] = None,
                      collect: bool = False, tp=None, d_ff: int = 0):
    """RWKV channel-mix: relu(xk @ Wk)^2 @ Wv gated by sigmoid(xr @ Wr).
    ``cache`` is the (B, d) f32 shift row, updated in place.

    ``tp`` (a mesh; no cache): tensor parallelism.  Where this rank holds
    column / row blocks of ``w1`` / ``w2`` (narrower than ``d_ff``), g sums
    their partial product.  Where it holds a column block of the gate
    ``w_r`` (JAX shards it so), ``sigmoid(xr @ w_r)`` is this rank's d/n
    columns, gathered whole (``tp_gather``: its backward keeps this rank's
    block, the gradient after it being replicated) before it multiplies the
    whole ``h @ w2``.  One f on ``x`` feeds the column-parallel products;
    the token-shift weight read before each gets its partial gradient
    summed by its own f."""
    ffn_split = tp is not None and params["w1"].shape[-1] < d_ff
    gate_split = tp is not None and params["w_r"].shape[-1] < x.shape[-1]
    mk, mr, xs = params["mix_k"], params["mix_r"], x
    if ffn_split or gate_split:
        from repro_torch.dist.collectives import column_input

        xs = column_input(x, mesh=tp)
        mk = column_input(mk, mesh=tp) if ffn_split else mk
        mr = column_input(mr, mesh=tp) if gate_split else mr
    xk = _token_shift(xs if ffn_split else x, mk, cache)
    xr = _token_shift(xs if gate_split else x, mr, cache)
    h = torch.square(torch.relu(xk @ params["w1"]))
    v = h @ params["w2"]
    gate = torch.sigmoid(xr @ params["w_r"])
    if ffn_split:
        from repro_torch.dist.collectives import row_sum

        v = row_sum(v, mesh=tp)
    if gate_split:
        from repro_torch.dist.collectives import tp_gather

        gate = tp_gather(gate, -1, mesh=tp)
    y = gate * v
    if cache is not None:
        cache.copy_(x[:, -1])
        return y, cache
    return y, (x[:, -1].float() if collect else None)
