"""EDPU forward (the port's ``repro/models/transformer.py``): one
``edpu_layer`` = one decoder layer, MHA (or RWKV-6 time-mix) stage then the
FFN (dense, MoE through ``models/moe.py``, or channel-mix) stage.  Three cache modes, as in JAX:

* no cache: the whole prompt at once (prefill); attention goes through the
  flash-attention kernel wrapper, RWKV-6 through the WKV kernel wrapper,
  and ``collect_cache=True`` harvests what the decode cache needs;
* a dense cache (``models/cache.init_cache`` / ``cache_from_prefill``): one
  decode token, the eager ``greedy_generate`` path;
* a paged cache (``init_paged_cache`` + ``page_state``): one continuous-
  batching serve step over the block pools.

Every RMSNorm (each layer's two, qk-norm, the final norm) goes through the
RMSNorm kernel's wrapper, in all three modes; ``fused=False`` runs every
kernel's plain version instead (the oracle).  LayerNorm archs keep the plain
norm.

The JAX package scans the stacked pattern-groups with ``lax.scan``; here
that is a Python loop over their leading dimension, then the tail layers.
Caches and pools are written in place (JAX returned new ones or took them
donated).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models import cache as C
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv6 as R


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, fused: bool) -> torch.Tensor:
    return rmsnorm_ops.rmsnorm(x, scale) if fused else L.rmsnorm(x, scale)


def _norm(p: dict, x: torch.Tensor, kind: str, fused: bool) -> torch.Tensor:
    """The model's norm: RMSNorm through the kernel's wrapper (``fused``)
    or the plain ``layers.rmsnorm``; LayerNorm always plain."""
    if kind == "rmsnorm":
        return _rmsnorm(x, p["scale"], fused)
    return L.apply_norm(p, x, kind)


def _project_qkv(ap: dict, h: torch.Tensor, cfg: ArchConfig, plan: ExecutionPlan,
                 fused: bool):
    B, S, _ = h.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if plan.fuse_qkv and "wqkv" in ap:
        qkv = h @ ap["wqkv"]  # C5: one large MM instead of 3 narrow ones
        q, k, v = torch.split(qkv, [H * Dh, KV * Dh, KV * Dh], dim=-1)
    else:
        q, k, v = h @ ap["wq"], h @ ap["wk"], h @ ap["wv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KV, Dh)
    v = v.reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        # q and k are views of the fused projection: the kernel reads them
        # in place, token stride and all
        q = _rmsnorm(q, ap["q_norm"], fused)
        k = _rmsnorm(k, ap["k_norm"], fused)
    return q, k, v


def attention_stage(
    ap: dict,
    h: torch.Tensor,
    *,
    cfg: ArchConfig,
    plan: ExecutionPlan,
    kind: str,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    page_state: Optional[dict] = None,
    fused: bool = True,
):
    """Returns ``(out, kv_out)``: ``kv_out`` is this pass's (k, v) with no
    cache (the prefill harvests it), else None.

    * paged cache: write this step's KV at each slot's own positions, then
      attend off the block table, through the CUDA kernel
      (``page_state["fused"]``) or by gathering the pages (the fallback and
      oracle);
    * no cache: causal (windowed) attention over the whole input, through
      the flash kernel's wrapper, or, with ``fused=False``, the plain
      ``blocked_attention`` on any device;
    * dense cache (one token): write K/V at slot ``t % Sc`` (ring, windowed
      layers) or ``min(t, Sc - 1)``, in place, then attend over the
      ``min(t + 1, Sc)`` filled slots."""
    B, S, _ = h.shape
    H, Dh = cfg.n_heads, cfg.d_head
    window = C.layer_window(cfg, kind)
    q, k, v = _project_qkv(ap, h, cfg, plan, fused)
    if cfg.pos_embedding == "rope":
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    kv_out = None
    if cache is not None and "paged" in cache:
        bs = page_state["block_size"]
        table = page_state["table"]
        q_lens = page_state["q_lens"]
        pos2d = positions.expand(B, S)
        valid = torch.arange(S, device=h.device)[None, :] < q_lens[:, None]
        entry = C.paged_update(cache["paged"], k, v, pos2d, table, bs, valid)
        if page_state["fused"]:
            o = paged_attention(q, entry, table, pos2d[:, 0], q_lens, block_size=bs,
                                window=window)
        else:
            kf, vf = C.paged_gather(entry, table, bs, page_state.get("max_blocks"))
            o = L.paged_attention(q, kf, vf, pos2d, window=window)
    elif cache is None:
        if fused:
            o = flash_ops.flash_attention(q, k, v, causal=cfg.causal, window=window)
        else:
            o = L.blocked_attention(q, k, v, causal=cfg.causal, window=window,
                                    q_chunk=flash_ops.PLAIN_CHUNK,
                                    k_chunk=flash_ops.PLAIN_CHUNK)
        kv_out = (k, v)
    else:
        Sc = cache["k"].shape[1]
        t = int(cache["t"])  # positions filled before this token
        idx = t % Sc if window else min(t, Sc - 1)
        cache["k"][:, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, idx] = v[:, 0].to(cache["v"].dtype)
        cache["t"] += 1
        o = L.decode_attention(q, cache["k"], cache["v"], min(t + 1, Sc))
    return o.reshape(B, S, H * Dh) @ ap["wo"], kv_out


def edpu_layer(
    lp: dict,
    x: torch.Tensor,
    *,
    cfg: ArchConfig,
    plan: ExecutionPlan,
    kind: str,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    collect: bool = False,
    page_state: Optional[dict] = None,
    fused: bool = True,
):
    """One decoder layer: MHA (or RWKV-6 time-mix) stage, then the FFN (MoE
    on an MoE arch, with the plan's dispatch, or channel-mix) stage.  Returns ``(x, cache)``: with a cache, the same
    cache updated in place; with ``collect`` (prefill), a new entry of what
    the decode cache needs (``kv_out`` for attention layers, the states for
    RWKV-6); else None."""
    if kind not in ("attn", "swa", "local", "rwkv6"):
        raise NotImplementedError(f"{cfg.name}: layer kind {kind!r} not ported")
    new_cache: dict = {}
    h = _norm(lp["attn"]["ln"], x, cfg.norm, fused)
    if kind == "rwkv6":
        a, nc = R.rwkv6_time_mix(
            lp["attn"], h, n_heads=cfg.rnn_heads, d_head=cfg.d_head,
            cache=None if cache is None else cache["rwkv"], collect=collect, fused=fused,
        )
        if nc is not None:
            new_cache["rwkv"] = nc
    else:
        ac = None if cache is None else (cache if "paged" in cache else cache["attn"])
        a, kv_out = attention_stage(
            lp["attn"], h, cfg=cfg, plan=plan, kind=kind, positions=positions,
            cache=ac, page_state=page_state, fused=fused,
        )
        if cache is not None:
            new_cache = cache
        elif collect:
            new_cache["kv_out"] = kv_out  # harvested by cache_from_prefill
    x = x + a
    h2 = _norm(lp["ffn"]["ln"], x, cfg.norm, fused)
    if cfg.is_moe:
        st = M.MoESettings(
            n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.moe_capacity_factor, dispatch=plan.moe_dispatch,
        )
        # the aux loss is for training; no serving path reads it
        f, _ = M.moe_ffn(lp["ffn"], h2, st, cfg.activation)
    elif kind == "rwkv6":
        f, nc = R.rwkv6_channel_mix(
            lp["ffn"], h2, cache=None if cache is None else cache["cmix"], collect=collect,
        )
        if nc is not None:
            new_cache["cmix"] = nc
    else:
        f = L.mlp(lp["ffn"], h2, cfg.activation)
    return x + f, (new_cache or None)


def _index(tree, i: int):
    """Group ``i`` of a stacked tree (views: in-place writes land in the
    stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, i) for v in tree)
    return None if tree is None else tree[i]


def _stack(groups: list):
    """Per-group trees -> one tree with every leaf stacked on a new axis 0."""
    first = groups[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([g[k] for g in groups]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([g[i] for g in groups]) for i in range(len(first)))
    return torch.stack(groups)


def _run_stack(
    blocks: dict,
    x: torch.Tensor,
    layer_fn: Callable,
    pattern: tuple,
    caches: Optional[dict] = None,
):
    """The stacked pattern-groups in order, then the tail layers.
    ``layer_fn(lp, x, kind, cache) -> (x, new_cache)``; ``caches`` mirrors
    ``blocks``.  Returns ``(x, new_caches)``: with ``caches``, the same tree
    (the layers write it in place); without, the layers' new caches with the
    stacked groups' entries stacked (the prefill's collect), or None leaves."""
    stack = blocks["stack"]
    new_stack = None
    if stack is not None:
        n = stack[0]["attn"]["ln"]["scale"].shape[0]
        per_group = []
        for g in range(n):
            gp = _index(stack, g)
            gc = None if caches is None else _index(caches["stack"], g)
            outs = []
            for i, kind in enumerate(pattern):
                x, nc = layer_fn(gp[i], x, kind, None if gc is None else gc[i])
                outs.append(nc)
            per_group.append(tuple(outs))
        new_stack = None if caches is not None else _stack(per_group)
    new_tail = []
    for i, lp in enumerate(blocks["tail"]):
        x, nc = layer_fn(lp, x, pattern[i % len(pattern)],
                         None if caches is None else caches["tail"][i])
        new_tail.append(nc)
    if caches is not None:
        return x, caches
    return x, {"stack": new_stack, "tail": tuple(new_tail)}


def _embed_inputs(params: dict, tokens: torch.Tensor, cfg: ArchConfig, t=None):
    """Token embedding + RoPE positions: (x, positions).  ``t`` is None (a
    pass from position 0: positions (1, S)), an int (a dense cache's filled
    length: positions (1, S) from t) or a (B,) tensor (the paged cache's
    per-slot lengths: positions (B, S))."""
    emb = params["embed"][tokens.long()]
    if cfg.activation == "geglu":  # gemma family scales embeddings
        emb = emb * torch.tensor(cfg.d_model**0.5, dtype=emb.dtype, device=emb.device)
    S = tokens.shape[1]
    ar = torch.arange(S, device=tokens.device)[None, :]
    if isinstance(t, torch.Tensor):
        return emb, t.long()[:, None] + ar
    return emb, ar + (t or 0)


def forward(
    params: dict,
    batch: dict,
    *,
    cfg: ArchConfig,
    plan: ExecutionPlan,
    cache: Optional[dict] = None,
    collect_cache: bool = False,
    page_state: Optional[dict] = None,
    fused: bool = True,
):
    """The model over ``batch["tokens"]`` (B, S); the compute dtype is the
    embedding's (norms stay f32).  Returns ``(hidden (B, S, d), cache)``.

    ``fused=False`` runs the plain versions of the kernels on any device
    (the oracle): the norms and, with no cache, the flash and WKV kernels;
    a paged step's attention follows ``page_state["fused"]``.

    * ``cache=None``: a pass from position 0; with ``collect_cache`` the
      returned cache is ``{"layers": per-layer harvest, "t": S}`` for
      ``cache_from_prefill``, else None.
    * a dense cache ``{"layers", "t": int}`` (S == 1): one decode step,
      written in place; returns the cache with ``t + 1``.
    * a paged cache ``{"layers": pools, "t": lens}`` with ``lens`` the
      per-slot (B,) count of positions already cached, and ``page_state =
      {"table": (B, MB), "block_size", "q_lens": (B,) live rows per slot,
      "fused": bool[, "max_blocks"]}``: one continuous-batching serve step;
      the pools are updated in place and ``t`` advances by S."""
    t = None if cache is None else cache["t"]
    x, positions = _embed_inputs(params, batch["tokens"], cfg, t)
    S = x.shape[1]

    def layer_fn(lp, xx, kind, c):
        return edpu_layer(
            lp, xx, cfg=cfg, plan=plan, kind=kind, positions=positions, cache=c,
            collect=collect_cache, page_state=page_state, fused=fused,
        )

    layers = None if cache is None else cache["layers"]
    x, new_layers = _run_stack(params["blocks"], x, layer_fn, cfg.layer_pattern, layers)
    x = _norm(params["final_norm"], x, cfg.norm, fused)
    if cache is not None:
        return x, {**cache, "layers": new_layers, "t": cache["t"] + S}
    if collect_cache:
        return x, {"layers": new_layers, "t": S}
    return x, None


def logits_fn(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    w: Optional[torch.Tensor] = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    return x @ w
