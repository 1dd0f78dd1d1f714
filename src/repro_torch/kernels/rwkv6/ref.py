"""Plain versions of the WKV kernels (the port's ``repro/kernels/rwkv6/
ref.py``).

``wkv_ref`` is the sequential recurrence in the kernel layout.  The
model-layout plain version, which ``ops.wkv`` runs for CPU tensors, is
``repro_torch.models.rwkv6.wkv_chunked``.  ``wkv_split_ref`` emulates the
tensor-core entry's arithmetic (``csrc/wkv.cu`` ``wkv_forward_mma``) for the
tests and the planted controls: 16-token tiles factored at their edges,
8-token diagonal halves in per-element form, log2-domain decays, and every
tensor-core operand rounded to TF32 as hi + lo.  ``wkv_backward_ref`` is the
backward kernel's (``csrc/wkv_bwd.cu``) chunked reverse pass in plain
PyTorch: what ``ops.WKV`` runs on the CPU, and what the card's kernel is
held to.
"""
from __future__ import annotations

from typing import Optional

import torch

TILE = 16  # tokens of a tensor-core row tile of the intra-chunk weights
HALF = 8   # tokens of a diagonal half, the only per-element block


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


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32`` on a finite x): the low 13 bits cleared
    after adding half of their range."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """x as the kernel's TF32 hi + lo: hi rounded (``tf32``), lo = x - hi
    (exact in f32) truncated to TF32; hi + lo is within 2^-21 of x."""
    hi = tf32(x)
    lo = ((x - hi).contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _mm(eq: str, x, y, split: bool):
    """One tensor-core product: x and y as TF32 hi + lo, the three terms
    hi.hi + hi.lo + lo.hi (``split=False``: hi.hi alone, one rounding).
    An operand exact in TF32 (bf16 r/k/v) has lo = 0."""
    (xh, xl), (yh, yl) = tf32_split(x), tf32_split(y)
    out = torch.einsum(eq, xh, yh)
    if split:
        out = out + torch.einsum(eq, xh, yl) + torch.einsum(eq, xl, yh)
    return out


def wkv_split_ref(r, k, v, w, u, *, chunk: int = 32, state: Optional[torch.Tensor] = None,
                  return_state: bool = False, split: bool = True, drop_diagonal: bool = False):
    """The tensor-core WKV entry's arithmetic in plain PyTorch, with the
    contract of ``wkv_chunked`` (model layout (B, S, H, D), f32 out,
    optional state in and out).  Per chunk of ``chunk`` tokens (a multiple
    of 16; a ragged last chunk is padded with r = k = v = 0, log w = 0),
    with L the inclusive cumsum of log2 w and Lq = L - log2 w:

    * tile T (tokens 16T..16T+15) against an earlier tile: r_t 2^(Lq_t - P)
      times k_s 2^(E_s - L_s) 2^(P - E_s), P = Lq at the tile's first token,
      E_s = L at the end of s's tile;
    * inside a tile, its second half against its first: r_t 2^(Lq_t - Q) and
      k_s 2^(Q - L_s), Q = L at the first half's last token;
    * inside a half: sum_d r k 2^(Lq_t - L_s) per element, and the bonus
      sum_d r u k on the diagonal;
    every exponent <= 0.  Then o = A v + rdec S and S = 2^Lc S + kfut^T v
    (rdec = rhat 2^P and kfut = kbar 2^(Lc - E), by multiplication),
    each product on TF32 hi + lo operands (``_mm``).  Controls:
    ``split=False`` rounds each operand once; ``drop_diagonal`` leaves out
    the halves' per-element weights."""
    B, S, H, D = r.shape
    C = chunk
    assert C % TILE == 0, C
    NT, N = C // TILE, -(-S // C)
    pad = N * C - S
    r, k, v, w = (t.float() for t in (r, k, v, w))
    lw = torch.log2(torch.clamp(w, min=1e-12))
    if pad:
        r, k, v, lw = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    # (B, H, N, C, D)
    rr, kk, vv, lw = (t.reshape(B, N, C, H, D).permute(0, 3, 1, 2, 4) for t in (r, k, v, lw))
    u = u.float()[None, :, None, :]  # (1, H, 1, D)
    L = torch.cumsum(lw, dim=3)
    Lq = L - lw
    tiles = torch.arange(C, device=r.device) // TILE
    first, last = tiles * TILE, tiles * TILE + TILE - 1
    mid = tiles * TILE + HALF - 1
    ex2 = torch.exp2
    S_state = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
               if state is None else state.float().clone())
    tri = torch.tril(torch.ones((HALF, HALF), dtype=torch.bool, device=r.device), -1)
    outs = []
    for n in range(N):
        ri, ki, vi, Li, Lqi = (t[:, :, n] for t in (rr, kk, vv, L, Lq))  # (B, H, C, D)
        P, E, Q = Lqi[:, :, first], Li[:, :, last], Li[:, :, mid]
        Lc = Li[:, :, -1]
        rhat = ri * ex2(Lqi - P)
        kbar = ki * ex2(E - Li)
        rdec = rhat * ex2(P)
        kfut = kbar * ex2(Lc[:, :, None] - E)
        A = torch.zeros((B, H, C, C), dtype=torch.float32, device=r.device)
        for T in range(1, NT):
            rows = slice(T * TILE, (T + 1) * TILE)
            cols = slice(0, T * TILE)
            cross = ex2(P[:, :, T * TILE, None] - E[:, :, cols])  # (B, H, s, D)
            A[:, :, rows, cols] = _mm("bhtd,bhsd->bhts", rhat[:, :, rows], kbar[:, :, cols] * cross,
                                      split)
        for T in range(NT):
            lo, hi = T * TILE, T * TILE + HALF
            Qt = Q[:, :, lo, None]
            rt = ri[:, :, hi:hi + HALF] * ex2(Lqi[:, :, hi:hi + HALF] - Qt)
            kt = ki[:, :, lo:hi] * ex2(Qt - Li[:, :, lo:hi])
            A[:, :, hi:hi + HALF, lo:hi] = _mm("bhtd,bhsd->bhts", rt, kt, split)
        for h0 in range(0, C, HALF):
            hs = slice(h0, h0 + HALF)
            diag = torch.einsum("bhtd,bhtd->bht", ri[:, :, hs] * u, ki[:, :, hs])
            blk = torch.diag_embed(diag)
            if not drop_diagonal:
                wgt = ex2((Lqi[:, :, hs, None] - Li[:, :, None, hs]).masked_fill(
                    ~tri[None, None, :, :, None], -torch.inf))
                blk = blk + torch.einsum("bhtd,bhsd,bhtsd->bhts", ri[:, :, hs], ki[:, :, hs], wgt)
            A[:, :, hs, hs] = blk
        outs.append(_mm("bhts,bhse->bhte", A, vi, split)
                    + _mm("bhtk,bhke->bhte", rdec, S_state, split))
        S_state = ex2(Lc)[..., None] * S_state + _mm("bhsk,bhse->bhke", kfut, vi, split)
    out = torch.stack(outs, dim=2).reshape(B, H, N * C, D).permute(0, 2, 1, 3)[:, :S]
    out = out.contiguous()
    return (out, S_state) if return_state else out


def _chunks(x, B, N, C, H, D):
    """(B, N * C, H, D) -> (B, H, N, C, D)."""
    return x.reshape(B, N, C, H, D).permute(0, 3, 1, 2, 4)


def wkv_backward_ref(r, k, v, w, u, dout, *, chunk: int = 32, state: Optional[torch.Tensor] = None,
                     dstate: Optional[torch.Tensor] = None, carry: bool = True,
                     state_out_term: bool = True, du_rows: Optional[int] = None):
    """The gradients of ``wkv_chunked``'s function (``o`` and, with
    ``dstate``, the final state) given ``dout`` (B, S, H, D) and ``dstate``
    (B, H, D, D) or None.  Returns (dr, dk, dv in r's dtype, d(log w) f32
    (the gradient of the clamped log, log(max(w, 1e-12))), du (H, D) f32,
    d(state) (B, H, D, D) f32, None without ``state``).

    Chunks of ``chunk`` tokens (a ragged last one padded with r = k = v = dO
    = 0, log w = 0), L the inclusive cumsum of log w, Lq = L - log w.  A
    forward pass keeps each chunk's start state S0; the reverse pass carries
    G, the gradient of the state after the chunk (dstate, or 0, after the
    last), and per chunk, with M = dO V^T and the decay ratios
    E_ts = exp(Lq_t - L_s) (s < t, exponent <= 0):
      dr_t = exp(Lq_t) S0 dO_t + sum_{s<t} M_ts E_ts k_s + u k_t M_tt
      dk_s = exp(Lc - L_s) G v_s + sum_{t>s} M_ts E_ts r_t + u r_s M_ss
      dv   = A^T dO + kfut^T G          (A: the forward's weights, bonus on
                                         the diagonal; kfut = k exp(Lc - L))
      du   = sum over b, t of r k M_tt
      G   <- exp(Lc) G + (r exp(Lq))^T dO   (the transposed state update).
    d(log w)_i = w_i sum_e G_i S_{i-1} (G_i the gradient of the state after
    token i) is the sum of the terms r_t' k_s E ... M_t's of the pairs s < i
    < t' (s before the chunk or the state in, t' after it or the state out
    included), taken per chunk as four parts, each without cancellation
    between large terms: exp(Lc) sum_e G S0 (pairs across the whole chunk);
    the suffix over t' > i of r exp(Lq) S0 dO (s before the chunk); the
    prefix over s < i of k exp(Lc - L) G v (t' after it); and the pairs
    inside the chunk, as the suffix over t' > i of a_t' minus the suffix
    over s >= i of b_s, where a and b leave out the adjacent pairs (t' = s +
    1), which straddle no token: under strong decay those are the large
    ones, and with them in, the two suffixes would cancel to a small
    difference.

    Controls (each gives a wrong gradient the tests must reject):
    ``carry=False`` starts every chunk but the last from G = 0 (dS not
    carried across chunks); ``state_out_term=False`` leaves dstate out of
    d(log w) only; ``du_rows=n`` sums du over the first n batch rows."""
    if not state_out_term and dstate is not None:
        full = wkv_backward_ref(r, k, v, w, u, dout, chunk=chunk, state=state, dstate=dstate,
                                carry=carry, du_rows=du_rows)
        part = wkv_backward_ref(r, k, v, w, u, dout, chunk=chunk, state=state, carry=carry,
                                du_rows=du_rows)
        return full[:3] + (part[3],) + full[4:]
    B, S, H, D = r.shape
    C = chunk
    N = -(-S // C)
    pad = N * C - S
    dtype = r.dtype
    r, k, v, w, dout = (t.float() for t in (r, k, v, w, dout))
    lw = torch.log(torch.clamp(w, min=1e-12))
    if pad:
        r, k, v, lw, dout = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                             for t in (r, k, v, lw, dout))
    rr, kk, vv, lw, do = (_chunks(t, B, N, C, H, D) for t in (r, k, v, lw, dout))
    uu = u.float()[None, :, None, :]  # (1, H, 1, D)
    L = torch.cumsum(lw, dim=3)
    Lq = L - lw
    Lc = L[:, :, :, -1]  # (B, H, N, D)
    dev = r.device
    below = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev), -1)
    far = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev), -2)
    adj = below & ~far
    # the forward state pass: each chunk's start state
    S0 = []
    st = (torch.zeros((B, H, D, D), dtype=torch.float32, device=dev) if state is None
          else state.float())
    for n in range(N):
        S0.append(st)
        kfut = kk[:, :, n] * torch.exp(Lc[:, :, n, None] - L[:, :, n])
        st = torch.exp(Lc[:, :, n])[..., None] * st + torch.einsum("bhsk,bhse->bhke", kfut,
                                                                   vv[:, :, n])
    G = (torch.zeros((B, H, D, D), dtype=torch.float32, device=dev) if dstate is None
         else dstate.float())
    grads = [torch.zeros_like(rr) for _ in range(4)]  # dr, dk, dv, dlogw
    rows = slice(None) if du_rows is None else slice(0, du_rows)
    du = torch.zeros(u.shape, dtype=torch.float32, device=dev)
    suffix = lambda x: torch.flip(torch.cumsum(torch.flip(x, [2]), 2), [2])  # noqa: E731
    for n in reversed(range(N)):
        if not carry and n < N - 1:
            G = torch.zeros_like(G)
        ri, ki, vi, doi, Li, Lqi = (t[:, :, n] for t in (rr, kk, vv, do, L, Lq))
        Lci = Lc[:, :, n]
        M = torch.einsum("bhte,bhse->bhts", doi, vi)
        E = torch.exp((Lqi[:, :, :, None] - Li[:, :, None, :]).masked_fill(
            ~below[None, None, :, :, None], -torch.inf))  # (B, H, t, s, D)
        Ef, Ea = E * far[None, None, :, :, None], E * adj[None, None, :, :, None]
        r_far = torch.einsum("bhts,bhsd,bhtsd->bhtd", M, ki, Ef)
        r_adj = torch.einsum("bhts,bhsd,bhtsd->bhtd", M, ki, Ea)
        k_far = torch.einsum("bhts,bhtd,bhtsd->bhsd", M, ri, Ef)
        k_adj = torch.einsum("bhts,bhtd,bhtsd->bhsd", M, ri, Ea)
        r_cross = torch.exp(Lqi) * torch.einsum("bhke,bhte->bhtk", S0[n], doi)
        decay_end = torch.exp(Lci[:, :, None] - Li)
        k_cross = decay_end * torch.einsum("bhke,bhse->bhsk", G, vi)
        Mtt = torch.diagonal(M, dim1=-2, dim2=-1)[..., None]
        grads[0][:, :, n] = r_cross + r_far + r_adj + uu * ki * Mtt
        grads[1][:, :, n] = k_cross + k_far + k_adj + uu * ri * Mtt
        kfut = ki * decay_end
        A = (torch.einsum("bhtd,bhsd,bhtsd->bhts", ri, ki, E)
             + torch.diag_embed(torch.einsum("bhtd,bhtd->bht", ri * uu, ki)))
        grads[2][:, :, n] = (torch.einsum("bhts,bhte->bhse", A, doi)
                             + torch.einsum("bhsk,bhke->bhse", kfut, G))
        du = du + (ri * ki * Mtt)[rows].sum(dim=(0, 2))
        whole = torch.exp(Lci) * (G * S0[n]).sum(-1)  # (B, H, D)
        a = ri * (r_cross + r_far)
        b_cross, b_far = ki * k_cross, ki * k_far
        grads[3][:, :, n] = (whole[:, :, None] + suffix(a) - a + torch.cumsum(b_cross, 2)
                             - b_cross - suffix(b_far))
        G = torch.exp(Lci)[..., None] * G + torch.einsum("bhtk,bhte->bhke",
                                                         ri * torch.exp(Lqi), doi)
    dr, dk, dv, dlogw = (g.permute(0, 2, 3, 1, 4).reshape(B, N * C, H, D)[:, :S].contiguous()
                         for g in grads)
    return (dr.to(dtype), dk.to(dtype), dv.to(dtype), dlogw, du,
            G if state is not None else None)


# The tensor-core backward's longest chunk: a 64-token chunk runs as two
# 32-token chunks (its arrays would not fit one SM's shared memory; the
# gradients do not depend on the chunk beyond rounding).
BWD_MMA_CHUNK = 32


def wkv_backward_split_ref(r, k, v, w, u, dout, *, chunk: int = 32,
                           state: Optional[torch.Tensor] = None,
                           dstate: Optional[torch.Tensor] = None, split: bool = True,
                           drop_diagonal: bool = False, keep_adjacent: bool = False):
    """The tensor-core backward entry's arithmetic (``csrc/wkv_bwd.cu``
    ``wkv_backward_mma``) in plain PyTorch, with ``wkv_backward_ref``'s
    contract and outputs.  Chunks of min(chunk, 32) tokens (a ragged last
    one padded with r = k = v = dO = 0, log w = 0); L the inclusive cumsum of
    log2 w, Lq_t = L_{t-1} (0 at the first token), Lc = L at the last.

    * 16-token tiles factor at their edges as in ``wkv_split_ref``: with
      P_T = Lq at tile T's first token, E_T = L at its last and Q_T = L at
      its first half's last, rhat = r 2^(Lq - P_T), kbar = k 2^(E_T - L) and,
      in each tile, rtil = r 2^(Lq - Q_T) (second half), ktil = k 2^(Q_T - L)
      (first half);
    * the state products on the tensor cores: the forward state pass S <-
      2^Lc S + kfut^T v, X = dO S0^T, Y = v G^T, dv's kfut G and G <- 2^Lc
      G + rdec^T dO (kfut = k 2^(Lc - L), rdec = rhat 2^P_T); M = dO v^T;
    * the intra-chunk sums: dr's sum_{s<t} M_ts k_s 2^(Lq_t - L_s) as
      2^(Lq_t - P_T) (M block) (kbar 2^(P_T - E_s)) against earlier tiles
      and 2^(Lq_t - Q_T) (M block) ktil inside a tile; dk's with M^T, rhat
      and rtil; the forward weights A (for dv's A^T dO) the same way, as
      ``wkv_split_ref``; only the 8-token diagonal halves per element;
    * the adjacent pairs (s = t - 1), whose decay is 2^0 = 1, stay out of
      the products (M's first sub-diagonal is zeroed in the operand they
      read) and out of d(log w)'s a and b, and go to dr and dk per element;
    * d(log w) = 2^Lc sum_e G S0 + the suffix over t > i of a + the prefix
      over s < i of k 2^(Lc - L) Y - the suffix over s >= i of b, with a =
      r (dr's cross and intra sums) and b = k (dk's intra sums).
    Every exponent is <= 0, and every product takes TF32 hi + lo operands
    (``_mm``).  Controls: ``split=False`` rounds each operand once;
    ``drop_diagonal`` leaves out the halves' per-element sums;
    ``keep_adjacent`` counts the adjacent pairs in the products, a and b."""
    B, S, H, D = r.shape
    C = min(chunk, BWD_MMA_CHUNK)
    assert C % TILE == 0, C
    NT, N = C // TILE, -(-S // C)
    pad = N * C - S
    dtype, dev = r.dtype, r.device
    r, k, v, w, dout = (t.float() for t in (r, k, v, w, dout))
    lw = torch.log2(torch.clamp(w, min=1e-12))
    if pad:
        r, k, v, lw, dout = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                             for t in (r, k, v, lw, dout))
    rr, kk, vv, lw, do = (_chunks(t, B, N, C, H, D) for t in (r, k, v, lw, dout))
    uu = u.float()[None, :, None, :]  # (1, H, 1, D)
    L = torch.cumsum(lw, dim=3)
    Lq = torch.nn.functional.pad(L[:, :, :, :-1], (0, 0, 1, 0))
    ex2 = torch.exp2
    tiles = torch.arange(C, device=dev) // TILE
    first, last = tiles * TILE, tiles * TILE + TILE - 1
    mid = tiles * TILE + HALF - 1
    second = (torch.arange(C, device=dev) % TILE) >= HALF  # rows of rtil; ktil elsewhere
    halves = torch.arange(C, device=dev) // HALF
    same_half = halves[:, None] == halves[None, :]
    t_idx = torch.arange(C, device=dev)
    gap = t_idx[:, None] - t_idx[None, :]  # t - s
    in_half = same_half & (gap >= (1 if keep_adjacent else 2))  # per-element pairs of dr / dk
    in_half_a = same_half & (gap >= 1)  # per-element pairs of A
    mm = lambda eq, x, y: _mm(eq, x, y, split)  # noqa: E731

    def decays(n):
        Li, Lqi = L[:, :, n], Lq[:, :, n]
        P, E, Q = Lqi[:, :, first], Li[:, :, last], Li[:, :, mid]
        Lc = Li[:, :, -1]
        ri, ki = rr[:, :, n], kk[:, :, n]
        rhat, kbar = ri * ex2(Lqi - P), ki * ex2(E - Li)
        til = torch.where(second[:, None], ri * ex2(Lqi - Q), ki * ex2(Q - Li))
        return Li, Lqi, P, E, Q, Lc, rhat, kbar, til

    # the forward state pass: each chunk's start state
    st = (torch.zeros((B, H, D, D), dtype=torch.float32, device=dev) if state is None
          else state.float())
    S0 = []
    for n in range(N):
        S0.append(st)
        Li, Lc = L[:, :, n], L[:, :, n, -1]
        kfut = kk[:, :, n] * ex2(Lc[:, :, None] - Li)
        st = ex2(Lc)[..., None] * st + mm("bhsk,bhse->bhke", kfut, vv[:, :, n])
    G = (torch.zeros((B, H, D, D), dtype=torch.float32, device=dev) if dstate is None
         else dstate.float())
    grads = [torch.zeros_like(rr) for _ in range(4)]  # dr, dk, dv, dlogw
    du = torch.zeros(u.shape, dtype=torch.float32, device=dev)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev), -1)
    sub = tri & (gap == 1)
    excl_suffix = lambda x: torch.flip(torch.cumsum(torch.flip(x, [2]), 2), [2]) - x  # noqa: E731
    for n in reversed(range(N)):
        ri, ki, vi, doi = rr[:, :, n], kk[:, :, n], vv[:, :, n], do[:, :, n]
        Li, Lqi, P, E, Q, Lc, rhat, kbar, til = decays(n)
        rdec, kfut = rhat * ex2(P), ki * ex2(Lc[:, :, None] - Li)
        M = mm("bhte,bhse->bhts", doi, vi)
        Mdiag = torch.diagonal(M, dim1=-2, dim2=-1)[..., None]  # (B, H, C, 1)
        Msub = torch.nn.functional.pad(torch.diagonal(M, -1, dim1=-2, dim2=-1), (1, 0))[..., None]
        Mp = M.masked_fill(~tri if keep_adjacent else ~tri | sub, 0.0)
        rb = ex2(Lqi) * mm("bhte,bhke->bhtk", doi, S0[n])  # dr's cross term
        ky = ex2(Lc[:, :, None] - Li) * mm("bhse,bhke->bhsk", vi, G)  # dk's
        fr, fk = torch.zeros_like(rb), torch.zeros_like(rb)
        A = torch.zeros((B, H, C, C), dtype=torch.float32, device=dev)
        for T in range(NT):
            rows = slice(T * TILE, (T + 1) * TILE)
            if T:  # tile T against every earlier token
                cols = slice(0, T * TILE)
                kk_T = kbar[:, :, cols] * ex2(P[:, :, T * TILE, None] - E[:, :, cols])
                fr[:, :, rows] = ex2(Lqi[:, :, rows] - P[:, :, rows]) * mm(
                    "bhts,bhsd->bhtd", Mp[:, :, rows, cols], kk_T)
                A[:, :, rows, cols] = mm("bhtd,bhsd->bhts", rhat[:, :, rows], kk_T)
            if T < NT - 1:  # tile T's tokens against every later one
                later = slice((T + 1) * TILE, C)
                rr_T = rhat[:, :, later] * ex2(P[:, :, later] - E[:, :, T * TILE, None])
                fk[:, :, rows] = ex2(E[:, :, rows] - Li[:, :, rows]) * mm(
                    "bhts,bhtd->bhsd", Mp[:, :, later, rows], rr_T)
            lo, hi = slice(T * TILE, T * TILE + HALF), slice(T * TILE + HALF, (T + 1) * TILE)
            mh = Mp[:, :, hi, lo]
            fr[:, :, hi] += ex2(Lqi[:, :, hi] - Q[:, :, hi]) * mm("bhts,bhsd->bhtd", mh, til[:, :, lo])
            fk[:, :, lo] += ex2(Q[:, :, lo] - Li[:, :, lo]) * mm("bhts,bhtd->bhsd", mh, til[:, :, hi])
            A[:, :, hi, lo] = mm("bhtd,bhsd->bhts", til[:, :, hi], til[:, :, lo])
        # the 8-token diagonal halves, per element (exponents <= 0 where masked in)
        wgt = ex2((Lqi[:, :, :, None] - Li[:, :, None, :]).masked_fill(
            ~same_half[None, None, :, :, None] | (gap <= 0)[None, None, :, :, None], -torch.inf))
        dgr = dgk = torch.zeros_like(rb)
        if not drop_diagonal:
            Mh = M.masked_fill(~in_half, 0.0)
            dgr = torch.einsum("bhts,bhsd,bhtsd->bhtd", Mh, ki, wgt)
            dgk = torch.einsum("bhts,bhtd,bhtsd->bhsd", Mh, ri, wgt)
            A = A + torch.einsum("bhtd,bhsd,bhtsd->bhts", ri, ki,
                                 wgt * in_half_a[None, None, :, :, None])
        A = A + torch.diag_embed(torch.einsum("bhtd,bhtd->bht", ri * uu, ki))
        adj = adj2 = 0.0
        if not keep_adjacent:
            adj = Msub * torch.nn.functional.pad(ki[:, :, :-1], (0, 0, 1, 0))
            adj2 = torch.nn.functional.pad(Msub[:, :, 1:] * ri[:, :, 1:], (0, 0, 0, 1))
        r_sum, k_far = rb + fr + dgr, fk + dgk
        grads[0][:, :, n] = r_sum + adj + uu * ki * Mdiag
        grads[1][:, :, n] = ky + k_far + adj2 + uu * ri * Mdiag
        grads[2][:, :, n] = mm("bhts,bhte->bhse", A, doi) + mm("bhsk,bhke->bhse", kfut, G)
        du = du + (ri * ki * Mdiag).sum(dim=(0, 2))
        whole = ex2(Lc) * (G * S0[n]).sum(-1)  # (B, H, D)
        bc = ki * ky
        grads[3][:, :, n] = (whole[:, :, None] + excl_suffix(ri * r_sum)
                             + torch.cumsum(bc, 2) - bc - excl_suffix(ki * k_far) - ki * k_far)
        G = ex2(Lc)[..., None] * G + mm("bhtk,bhte->bhke", rdec, doi)
    dr, dk, dv, dlogw = (g.permute(0, 2, 3, 1, 4).reshape(B, N * C, H, D)[:, :S].contiguous()
                         for g in grads)
    return (dr.to(dtype), dk.to(dtype), dv.to(dtype), dlogw, du,
            G if state is not None else None)
