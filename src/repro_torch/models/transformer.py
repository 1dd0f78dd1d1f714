"""EDPU forward for the paged serve step (the port's
``repro/models/transformer.py``, continuous-batching branch only).

One ``edpu_layer`` = one Transformer layer: MHA stage (norm, fused QKV,
qk-norm, RoPE, KV write into the block pool, paged attention, ``wo``) then
the dense FFN stage.  The JAX package scans the stacked pattern-groups with
``lax.scan``; here that is a Python loop over their leading dimension, then
the tail layers.  Pools are written in place (JAX donated them).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import cache as C
from repro_torch.models import layers as L


def _project_qkv(ap: dict, h: torch.Tensor, cfg: ArchConfig, plan: ExecutionPlan):
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
        q = L.rmsnorm(q, ap["q_norm"])
        k = L.rmsnorm(k, ap["k_norm"])
    return q, k, v


def _window(cfg: ArchConfig, kind: str) -> int:
    if kind == "swa":
        return cfg.sliding_window
    return cfg.local_window if kind == "local" else 0


def attention_stage(
    ap: dict,
    h: torch.Tensor,
    *,
    cfg: ArchConfig,
    plan: ExecutionPlan,
    kind: str,
    positions: torch.Tensor,
    cache: dict,
    page_state: dict,
) -> torch.Tensor:
    """The paged branch of the JAX ``attention_stage``: write this step's
    KV at each slot's own positions, then attend off the block table —
    through the CUDA kernel (``page_state["fused"]``) or by gathering the
    pages (the fallback and oracle)."""
    B, S, _ = h.shape
    H, Dh = cfg.n_heads, cfg.d_head
    window = _window(cfg, kind)
    q, k, v = _project_qkv(ap, h, cfg, plan)
    if cfg.pos_embedding == "rope":
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    bs = page_state["block_size"]
    table = page_state["table"]
    q_lens = page_state["q_lens"]
    pos2d = positions.expand(B, S)
    valid = torch.arange(S, device=h.device)[None, :] < q_lens[:, None]
    entry = C.paged_update(cache["paged"], k, v, pos2d, table, bs, valid)
    if page_state["fused"]:
        o = paged_attention(q, entry, table, pos2d[:, 0], q_lens, block_size=bs, window=window)
    else:
        kf, vf = C.paged_gather(entry, table, bs, page_state.get("max_blocks"))
        o = L.paged_attention(q, kf, vf, pos2d, window=window)
    return o.reshape(B, S, H * Dh) @ ap["wo"]


def edpu_layer(
    lp: dict,
    x: torch.Tensor,
    *,
    cfg: ArchConfig,
    plan: ExecutionPlan,
    kind: str,
    positions: torch.Tensor,
    cache: dict,
    page_state: dict,
) -> torch.Tensor:
    """One decoder layer over the paged cache: MHA stage then FFN stage."""
    if kind not in ("attn", "swa", "local") or cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: layer kind {kind!r} / MoE not ported")
    h = L.apply_norm(lp["attn"]["ln"], x, cfg.norm)
    x = x + attention_stage(
        lp["attn"], h, cfg=cfg, plan=plan, kind=kind, positions=positions,
        cache=cache, page_state=page_state,
    )
    h2 = L.apply_norm(lp["ffn"]["ln"], x, cfg.norm)
    return x + L.mlp(lp["ffn"], h2, cfg.activation)


def _index(tree, i: int):
    """Group ``i`` of a stacked tree (views: pool writes land in place)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, i) for v in tree)
    return tree[i]


def _run_stack(
    blocks: dict,
    x: torch.Tensor,
    layer_fn: Callable,
    pattern: tuple,
    caches: dict,
) -> torch.Tensor:
    """The stacked pattern-groups in order, then the tail layers.
    ``layer_fn(lp, x, kind, cache) -> x``; ``caches`` mirrors ``blocks``."""
    stack = blocks["stack"]
    if stack is not None:
        for g in range(stack[0]["attn"]["ln"]["scale"].shape[0]):
            gp, gc = _index(stack, g), _index(caches["stack"], g)
            for i, kind in enumerate(pattern):
                x = layer_fn(gp[i], x, kind, gc[i])
    for i, lp in enumerate(blocks["tail"]):
        x = layer_fn(lp, x, pattern[i % len(pattern)], caches["tail"][i])
    return x


def _embed_inputs(params: dict, tokens: torch.Tensor, cfg: ArchConfig, lens: torch.Tensor):
    """Token embedding + per-slot RoPE positions: (x, positions (B, S))."""
    emb = params["embed"][tokens.long()]
    if cfg.activation == "geglu":  # gemma family scales embeddings
        emb = emb * torch.tensor(cfg.d_model**0.5, dtype=emb.dtype, device=emb.device)
    S = tokens.shape[1]
    positions = lens.long()[:, None] + torch.arange(S, device=tokens.device)[None, :]
    return emb, positions


def forward(
    params: dict,
    batch: dict,
    *,
    cfg: ArchConfig,
    plan: ExecutionPlan,
    cache: dict,
    page_state: dict,
):
    """One continuous-batching serve step over the paged cache.

    ``batch["tokens"]`` (B, S); ``cache = {"layers": pools, "t": lens}``
    with ``lens`` the per-slot (B,) count of positions already cached;
    ``page_state = {"table": (B, MB), "block_size", "q_lens": (B,) live
    rows per slot, "fused": bool[, "max_blocks"]}``.  The compute dtype is
    the embedding's (norms stay f32).  Returns ``(hidden (B, S, d),
    {"layers": pools, "t": lens + S})``; the pools are updated in place."""
    x, positions = _embed_inputs(params, batch["tokens"], cfg, cache["t"])

    def layer_fn(lp, xx, kind, c):
        return edpu_layer(
            lp, xx, cfg=cfg, plan=plan, kind=kind, positions=positions,
            cache=c, page_state=page_state,
        )

    x = _run_stack(params["blocks"], x, layer_fn, cfg.layer_pattern, cache["layers"])
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return x, {"layers": cache["layers"], "t": cache["t"] + x.shape[1]}


def logits_fn(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    w: Optional[torch.Tensor] = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    return x @ w
