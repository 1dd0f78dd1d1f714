"""EDPU forward (the port's ``repro/models/transformer.py``): one
``edpu_layer`` = one layer, the MHA (or RWKV-6 time-mix, or RG-LRU) stage,
the cross-attention sub-stage of an encoder-decoder's decoder, then the FFN
(dense, MoE through ``models/moe.py``, or channel-mix) stage.  Three cache
modes, as in JAX:

* no cache: the whole prompt at once (prefill); attention goes through the
  flash-attention kernel wrapper (causal, windowed, prefix-LM or, for
  encoders, bidirectional), RWKV-6 through the WKV kernel wrapper, and
  ``collect_cache=True`` harvests what the decode cache needs;
* a dense cache (``models/cache.init_cache`` / ``cache_from_prefill``): one
  decode token, the eager ``greedy_generate`` path;
* a paged cache (``init_paged_cache`` + ``page_state``): one continuous-
  batching serve step over the block pools.

Inputs are token embeddings, precomputed frontend embeddings in front of
them (``prefix_embeds``: a prefix-LM's bidirectional prefix, or a ViT's
patches) and, for an encoder-decoder, ``enc_embeds``, which the encoder
stack turns into the ``memory`` every decoder layer cross-attends to (its
K/V computed once, kept in the decode cache).  Positions are RoPE,
learned or sinusoidal.  Cross-attention runs through the flash kernel
(``causal=False``, Sq != Sk) in the prefill and in every decode step.

Every RMSNorm (each layer's two, qk-norm, the final norm) goes through the
RMSNorm kernel's wrapper, in all three modes; ``fused=False`` runs every
kernel's plain version instead (the oracle).  LayerNorm archs keep the plain
norm.

Training (``lm_loss``): the same no-cache pass, differentiable: on the card
the flash and RMSNorm wrappers go through their ``torch.autograd.Function``s
(backward kernels); each layer returns its MoE aux loss, summed as JAX sums
it; with ``plan.remat`` every stacked pattern-group runs under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint(group_body)``), so its
kernels launch again in the backward; the LM head's cross-entropy is taken
512 positions at a time, each chunk's logits recomputed in the backward
(``_XentChunk``).

Tensor parallelism without SP (``forward(mesh=)`` on a plan that
``dist.sharding.tensor_parallel`` accepts): every layer, of the decoder and
of an encoder, runs on this rank's Megatron shards (attention, RWKV-6's
time-mix and channel-mix, the RG-LRU block, cross-attention, the FFN), with
f (``dist.collectives.column_input``) where a replicated tensor enters a
column-parallel block and g (``row_sum``) after the row-parallel product;
GSPMD derives the same from JAX's shardings.  The encoder memory enters
the decoder's sharded cross-attention through one f (``memory_input``).
Under it and under Megatron-SP an embedding cut over the vocabulary is
looked up vocab-parallel and the cross-entropy takes its logsumexp and
target logit across the ranks (``_VocabXentChunk``).  FSDP (ZeRO,
``dp_over_model``: ``lm_loss(shardings=)``): each stacked group gathers
its weights at its entry and the embedding and head are gathered before
the pass (``dist.collectives.FSDPGathers``); their gradients are
reduce-scattered in the backward.  Under the GPipe pipeline
(``pipeline_lm_loss(shardings=)``) a stage gathers its whole slice once a
step, at its entry.

The JAX package scans the stacked pattern-groups with ``lax.scan``; here
that is a Python loop over their leading dimension, then the tail layers.
Caches and pools are written in place (JAX returned new ones or took them
donated).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models import cache as C
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as R


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, fused: bool) -> torch.Tensor:
    return rmsnorm_ops.rmsnorm(x, scale) if fused else L.rmsnorm(x, scale)


def _norm(p: dict, x: torch.Tensor, kind: str, fused: bool) -> torch.Tensor:
    """The model's norm: RMSNorm through the kernel's wrapper (``fused``)
    or the plain ``layers.rmsnorm``; LayerNorm always plain."""
    if kind == "rmsnorm":
        return _rmsnorm(x, p["scale"], fused)
    return L.apply_norm(p, x, kind)


def local_heads(ap: dict, cfg: ArchConfig) -> tuple:
    """(query heads, KV heads) of this rank's attention weights: all of them,
    or H/n and KV/n under tensor parallelism (read off ``wo``'s rows)."""
    H = ap["wo"].shape[-2] // cfg.d_head
    return H, cfg.n_kv_heads * H // cfg.n_heads


def _project_qkv(ap: dict, h: torch.Tensor, cfg: ArchConfig, plan: ExecutionPlan,
                 fused: bool):
    """q, k, v (B, S, heads, Dh) on this rank's heads; a head-aligned fused
    ``wqkv`` shard (``dist.sharding.QKVSharding``) splits by the local
    widths as the whole one does."""
    B, S, _ = h.shape
    H, KV = local_heads(ap, cfg)
    Dh = cfg.d_head
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
    prefix_len: int = 0,
    causal: Optional[bool] = None,
    tp=None,
):
    """Returns ``(out, kv_out)``: ``kv_out`` is this pass's (k, v) with no
    cache (the prefill harvests it), else None.

    ``tp`` (a mesh) runs tensor parallelism without SP: with this rank's
    column / row shards (``local_heads`` < H) the stage input enters through
    Megatron's f (``column_input``), q, k and v, their norms, RoPE, the
    pages and the kernels are this rank's H/n and KV/n heads (the qk-norm
    scales, replicated but applied to those heads only, enter through f as
    well), and ``wo``'s partial output is summed by g (``row_sum``); with
    whole weights (heads that do not divide) the stage runs replicated,
    with neither.

    * paged cache: write this step's KV at each slot's own positions, then
      attend off the block table, through the CUDA kernel
      (``page_state["fused"]``) or by gathering the pages (the fallback and
      oracle);
    * no cache: attention over the whole input under ``causal`` (default
      ``cfg.causal``), the window and ``prefix_len`` (a prefix-LM's
      bidirectional prefix), through the flash kernel's wrapper, or, with
      ``fused=False``, the plain ``blocked_attention`` on any device;
    * dense cache (one token): write K/V at slot ``t % Sc`` (ring, windowed
      layers) or ``min(t, Sc - 1)``, in place, then attend over the
      ``min(t + 1, Sc)`` filled slots."""
    B, S, _ = h.shape
    H, Dh = local_heads(ap, cfg)[0], cfg.d_head
    window = C.layer_window(cfg, kind)
    sharded = tp is not None and H < cfg.n_heads
    if sharded:
        from repro_torch.dist.collectives import column_input

        h = column_input(h, mesh=tp)
        # the qk-norm scales are replicated but act on this rank's heads only:
        # their gradients are partial too, and f sums them
        ap = {**ap, **{n: column_input(ap[n], mesh=tp) for n in ("q_norm", "k_norm") if n in ap}}
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
        causal = cfg.causal if causal is None else causal
        if fused:
            o = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                          prefix=prefix_len)
        else:
            c = flash_ops.plain_chunk(S)
            o = L.blocked_attention(q, k, v, causal=causal, window=window, q_chunk=c,
                                    k_chunk=c, prefix_len=prefix_len)
        kv_out = (k, v)
    else:
        Sc = cache["k"].shape[1]
        t = int(cache["t"])  # positions filled before this token
        idx = t % Sc if window else min(t, Sc - 1)
        cache["k"][:, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, idx] = v[:, 0].to(cache["v"].dtype)
        cache["t"] += 1
        o = L.decode_attention(q, cache["k"], cache["v"], min(t + 1, Sc))
    out = o.reshape(B, S, H * Dh) @ ap["wo"]
    if sharded:
        from repro_torch.dist.collectives import row_sum

        out = row_sum(out, mesh=tp)
    return out, kv_out


def cross_attention_stage(cp: dict, h: torch.Tensor, memory_kv, cfg: ArchConfig,
                          fused: bool = True, tp=None) -> torch.Tensor:
    """Decoder -> encoder-memory attention (whisper).  memory_kv: (k, v),
    each (B, Se, KV, Dh).  Through the flash kernel's wrapper with
    ``causal=False``, or the plain ``plain_cross_attention``.  ``tp`` (a
    mesh) with this rank's column / row shards (``local_heads`` < H): the
    normed decoder input enters through f, q, the memory's K / V and the
    kernel are this rank's heads, and ``wo``'s partial output is summed by
    g; with whole weights the stage runs replicated."""
    B, S, _ = h.shape
    H, Dh = local_heads(cp, cfg)[0], cfg.d_head
    sharded = tp is not None and H < cfg.n_heads
    if sharded:
        from repro_torch.dist.collectives import column_input

        h = column_input(h, mesh=tp)
    q = (h @ cp["wq"]).reshape(B, S, H, Dh)
    mk, mv = memory_kv
    if fused:
        o = flash_ops.flash_attention(q, mk, mv, causal=False)
    else:
        o = L.plain_cross_attention(q, mk, mv)
    out = o.reshape(B, S, H * Dh) @ cp["wo"]
    if sharded:
        from repro_torch.dist.collectives import row_sum

        out = row_sum(out, mesh=tp)
    return out


def cross_kv(cp: dict, memory: torch.Tensor, cfg: ArchConfig):
    """The encoder memory's K and V for one decoder layer, (B, Se, KV, Dh),
    on this rank's KV heads (all of them with whole weights)."""
    B, Se, _ = memory.shape
    KV = local_heads(cp, cfg)[1]
    mk = (memory @ cp["wk"]).reshape(B, Se, KV, cfg.d_head)
    mv = (memory @ cp["wv"]).reshape(B, Se, KV, cfg.d_head)
    return mk, mv


def memory_input(params: dict, memory: torch.Tensor, cfg: ArchConfig, tp) -> torch.Tensor:
    """The encoder memory as the decoder's cross-attention reads it: under
    tensor parallelism with cross-attention on this rank's heads, through
    one f (``column_input``).  Every decoder layer projects it on its own
    heads, autograd sums the layers' partial gradients, and f's backward
    sums that over the ranks once, not once a layer."""
    blocks = params["blocks"]
    lp = blocks["stack"][0] if blocks["stack"] is not None else blocks["tail"][0]
    if tp is None or local_heads(lp["cross"], cfg)[0] == cfg.n_heads:
        return memory
    from repro_torch.dist.collectives import column_input

    return column_input(memory, mesh=tp)


def edpu_layer(
    lp: dict,
    x: torch.Tensor,
    *,
    cfg: ArchConfig,
    plan: ExecutionPlan,
    kind: str,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    memory: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
    causal_override: Optional[bool] = None,
    collect: bool = False,
    page_state: Optional[dict] = None,
    fused: bool = True,
    tp=None,
    dp=None,
):
    """One layer: MHA (or RWKV-6 time-mix, or RG-LRU) stage, the
    cross-attention sub-stage when the layer has ``cross`` leaves (over
    ``memory``, or the cached ``cross_kv``), then the FFN (MoE on an MoE
    arch, with the plan's dispatch, or channel-mix) stage.
    ``causal_override`` replaces ``cfg.causal`` in the attention stage (an
    encoder's layers: False).  Returns ``(x, cache, aux)``: with a cache,
    the same cache updated in place; with ``collect`` (prefill), a new entry
    of what the decode cache needs (``kv_out`` for attention layers, the
    states for RWKV-6 and RG-LRU, ``cross_kv``); else None.  ``aux`` is the
    MoE layer's load-balancing loss (an f32 scalar), 0.0 on other layers.

    ``tp`` (a mesh): tensor parallelism without SP on this rank's shards
    (``attention_stage``; the RWKV-6 time-mix and channel-mix and the
    RG-LRU block on their local heads or channels, ``models/rwkv6.py``,
    ``models/rglru.py``; ``cross_attention_stage``; the dense FFN's f,
    column-parallel ``w1`` / ``w3``, row-parallel ``w2`` and g; MoE's expert
    or width split, ``moe.moe_ffn``).  A stage whose weights are whole runs
    replicated; the head counts are read off the shards.  The residual, the
    norms and their scales stay replicated, and their gradients are whole
    on every rank: f sums the partial gradients where a replicated tensor
    enters a sharded block.  ``dp`` (mesh, the axes that
    split the batch): an MoE layer's aux loss covers every rank's tokens
    (``moe.router_topk``)."""
    new_cache: dict = {}
    h = _norm(lp["attn"]["ln"], x, cfg.norm, fused)
    if kind == "rglru":
        heads = max(cfg.rnn_heads, 1)
        heads = heads * lp["attn"]["w_out"].shape[-2] // (cfg.lru_width or cfg.d_model)
        a, nc = G.rglru_block(lp["attn"], h, n_heads=heads,
                              cache=None if cache is None else cache["rglru"], collect=collect,
                              tp=tp if heads < max(cfg.rnn_heads, 1) else None)
        if cache is not None:
            new_cache = cache
        elif nc is not None:
            new_cache["rglru"] = nc
    elif kind == "rwkv6":
        heads = lp["attn"]["w_o"].shape[-2] // cfg.d_head
        a, nc = R.rwkv6_time_mix(
            lp["attn"], h, n_heads=heads, d_head=cfg.d_head,
            cache=None if cache is None else cache["rwkv"], collect=collect, fused=fused,
            tp=tp if heads < cfg.rnn_heads else None,
        )
        if nc is not None:
            new_cache["rwkv"] = nc
    elif kind in ("attn", "swa", "local"):
        ac = None if cache is None else (cache if "paged" in cache else cache["attn"])
        a, kv_out = attention_stage(
            lp["attn"], h, cfg=cfg, plan=plan, kind=kind, positions=positions,
            cache=ac, page_state=page_state, fused=fused, prefix_len=prefix_len,
            causal=causal_override, tp=tp,
        )
        if cache is not None:
            new_cache = cache
        elif collect:
            new_cache["kv_out"] = kv_out  # harvested by cache_from_prefill
    else:
        raise ValueError(kind)
    x = x + a
    if "cross" in lp:  # an encoder-decoder's decoder layer
        hc = _norm(lp["cross"]["ln"], x, cfg.norm, fused)
        if cache is not None and "cross_kv" in cache:
            mkv = cache["cross_kv"]
        else:
            mkv = cross_kv(lp["cross"], memory, cfg)
        x = x + cross_attention_stage(lp["cross"], hc, mkv, cfg, fused, tp=tp)
        if cache is None and collect:
            new_cache["cross_kv"] = mkv
    h2 = _norm(lp["ffn"]["ln"], x, cfg.norm, fused)
    aux = 0.0
    if cfg.is_moe:
        st = M.MoESettings(
            n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.moe_capacity_factor, dispatch=plan.moe_dispatch, dp=dp,
        )
        split = None
        if tp is not None:
            w1 = lp["ffn"]["w1"]
            split = ("ep" if w1.shape[-3] < cfg.n_experts
                     else "tp" if w1.shape[-1] < cfg.moe_d_ff else None)
        # the aux loss is for training (lm_loss); no serving path reads it
        f, aux = M.moe_ffn(lp["ffn"], h2, st, cfg.activation,
                           tp=None if split is None else (tp, split))
    elif kind == "rwkv6":
        f, nc = R.rwkv6_channel_mix(
            lp["ffn"], h2, cache=None if cache is None else cache["cmix"], collect=collect,
            tp=tp, d_ff=cfg.d_ff,
        )
        if nc is not None:
            new_cache["cmix"] = nc
    elif tp is not None and lp["ffn"]["w2"].shape[-2] < cfg.d_ff:
        from repro_torch.dist.collectives import column_input, row_sum

        f = row_sum(L.mlp(lp["ffn"], column_input(h2, mesh=tp), cfg.activation), mesh=tp)
    else:
        f = L.mlp(lp["ffn"], h2, cfg.activation)
    return x + f, (new_cache or None), aux


def _index(tree, i: int):
    """Group ``i`` of a stacked tree (views: in-place writes land in the
    stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, i) for v in tree)
    return None if tree is None else tree[i]


def _unbind(tree, n: int) -> list:
    """The ``n`` groups of a stacked tree, each leaf unbound once: its
    gradient is one stack of the groups' gradients, where ``_index``'s
    per-group ``select`` would add each group's into a full-size zero
    tensor."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [_unbind(v, n) for v in tree]
        return [tuple(p[i] for p in parts) for i in range(n)]
    return [None] * n if tree is None else list(torch.unbind(tree))


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
    remat: bool = False,
    gathers=None,
    specs: Optional[dict] = None,
):
    """The stacked pattern-groups in order, then the tail layers.
    ``layer_fn(lp, x, kind, cache) -> (x, new_cache, aux)``; ``caches``
    mirrors ``blocks``; ``blocks["stack"]`` may also be a list of per-group
    trees (a pipeline stage's groups, ``dist.pipeline``).  Returns ``(x,
    new_caches, aux)``: with ``caches``, the same tree (the layers write it
    in place); without, the layers' new
    caches with the stacked groups' entries stacked (the prefill's collect),
    or None leaves; ``aux`` the layers' aux losses summed.  With ``remat``
    (no caches, grad enabled) each stacked group runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward, as JAX's ``jax.checkpoint(group_body)``; the tail layers are
    not.

    ``gathers`` (``dist.collectives.FSDPGathers``) with ``specs`` (the gather
    specs of ``blocks``): FSDP.  Each group gathers its sharded leaves at its
    entry, inside the checkpoint, so under remat the backward gathers them
    again instead of keeping every whole weight alive; without remat the
    group runs under ``gathers.saved_as_shards`` to the same end.  Each tail
    layer gathers its own."""
    stack = blocks["stack"]
    new_stack = None
    total_aux = 0.0
    fsdp = gathers is not None
    stack_specs = tail_specs = None
    if fsdp:
        from repro_torch.train.optimizer import tree_map

        # a stacked leaf's group dim is never gathered: drop its entry
        stack_specs = tree_map(lambda sp: type(sp)(sp[1:]), specs["stack"])
        tail_specs = specs["tail"]

    def shards_saved():
        return gathers.saved_as_shards() if fsdp else contextlib.nullcontext()

    if stack is not None:
        # a list: the groups already apart (a pipeline stage's, one leaf each)
        groups = stack if isinstance(stack, list) else _unbind(
            stack, stack[0]["attn"]["ln"]["scale"].shape[0])
        n = len(groups)
        per_group = []
        for g in range(n):
            gp = groups[g]
            gc = None if caches is None else _index(caches["stack"], g)

            def group(xx, gp=gp, gc=gc):
                if fsdp:
                    gp = gathers.tree(gp, stack_specs)
                outs, aux = [], 0.0
                for i, kind in enumerate(pattern):
                    xx, nc, a = layer_fn(gp[i], xx, kind, None if gc is None else gc[i])
                    outs.append(nc)
                    aux = aux + a
                return xx, tuple(outs), aux

            if remat and caches is None and torch.is_grad_enabled():
                x, outs, aux = checkpoint(group, x, use_reentrant=False)
            else:
                with shards_saved():
                    x, outs, aux = group(x)
            total_aux = total_aux + aux
            per_group.append(outs)
        new_stack = None if caches is not None else _stack(per_group)
    new_tail = []
    for i, lp in enumerate(blocks["tail"]):
        with shards_saved():
            if fsdp:
                lp = gathers.tree(lp, tail_specs[i])
            x, nc, a = layer_fn(lp, x, pattern[i % len(pattern)],
                                None if caches is None else caches["tail"][i])
        new_tail.append(nc)
        total_aux = total_aux + a
    if caches is not None:
        return x, caches, total_aux
    return x, {"stack": new_stack, "tail": tuple(new_tail)}, total_aux


# ---------------------------------------------------------------------------
# Megatron-SP layer stack (manual collectives, ``dist.collectives``).  The
# residual is sequence-sharded over `model`; each stage is one ring
# gather-matmul up and one reduce-scatter down, and the norms run on the
# sequence chunk, so the stack makes no all-gather.
# ---------------------------------------------------------------------------
def sp_edpu_layer(
    lp: dict,
    x: torch.Tensor,
    *,
    cfg: ArchConfig,
    plan: ExecutionPlan,
    kind: str,
    positions: torch.Tensor,
    mesh,
    axis: str = "model",
    n_shards: int = 1,
    fused: bool = True,
) -> torch.Tensor:
    """One EDPU layer on the sequence-parallel residual.

    ``x`` is this rank's (B, S/n, d) sequence chunk; the weights are its
    Megatron column / row shards (SP plans keep q, k and v unfused, so each
    projection splits on head boundaries).  The norms (through the RMSNorm
    kernel's wrapper) are token-local and run on the chunk; attention runs
    through the flash kernel's wrapper on this rank's H/n query and KV/n KV
    heads over the whole sequence, q / k / v being views of one gathered
    product."""
    ap = lp["attn"]
    Dh = cfg.d_head
    window = C.layer_window(cfg, kind)

    # ---- MHA Stage: gather(seq) -> local heads -> scatter(seq) ------------
    h = _norm(ap["ln"], x, cfg.norm, fused)
    wq, wk, wv = ap["wq"], ap["wk"], ap["wv"]
    qkv = L.sp_gather_matmul(h, torch.cat([wq, wk, wv], dim=-1), axis, n_shards, mesh=mesh)
    q, k, v = torch.split(qkv, [wq.shape[-1], wk.shape[-1], wv.shape[-1]], dim=-1)
    B, S = q.shape[0], q.shape[1]
    q = q.reshape(B, S, wq.shape[-1] // Dh, Dh)  # local heads H/n
    k = k.reshape(B, S, wk.shape[-1] // Dh, Dh)  # local KV heads KV/n
    v = v.reshape(B, S, wv.shape[-1] // Dh, Dh)
    if cfg.qk_norm:
        q = _rmsnorm(q, ap["q_norm"], fused)
        k = _rmsnorm(k, ap["k_norm"], fused)
    if cfg.pos_embedding == "rope":
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    causal = False if cfg.encoder_only else cfg.causal
    if fused:
        o = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        c = flash_ops.plain_chunk(S)
        o = L.blocked_attention(q, k, v, causal=causal, window=window, q_chunk=c, k_chunk=c)
    o = o.reshape(B, S, o.shape[-2] * Dh)
    x = x + L.sp_scatter_matmul(o, ap["wo"], axis, mesh=mesh)

    # ---- FFN Stage --------------------------------------------------------
    h2 = _norm(lp["ffn"]["ln"], x, cfg.norm, fused)
    return x + L.sp_mlp(lp["ffn"], h2, cfg.activation, axis, n_shards, mesh=mesh)


def sp_stack_forward(
    stack,
    x: torch.Tensor,
    *,
    cfg: ArchConfig,
    plan: ExecutionPlan,
    mesh,
    positions: torch.Tensor,
    axis: str = "model",
    fused: bool = True,
) -> torch.Tensor:
    """The stacked pattern-groups with the residual sequence-sharded over
    ``axis`` (Megatron-SP).  ``stack`` holds this rank's shards (the
    ``Shardings`` rules: every projection of an SP plan splits evenly, so a
    leaf is a model shard exactly when it is column- or row-parallel);
    ``x`` is the replicated (B, S, d) input, of which this rank takes its
    sequence chunk, and the chunk after the stack is returned (JAX's
    ``out_specs``).  The replicated leaves (the norms' scales) have their
    gradients summed over ``axis``, as the transpose of ``shard_map``'s
    replicated inputs.  With ``plan.remat`` each group runs under
    ``torch.utils.checkpoint``: its collectives are issued again, in the
    same order on every rank, in the backward."""
    from repro_torch.dist.collectives import replicated, seq_chunk
    from repro_torch.dist.sharding import COLUMN_PARALLEL, ROW_PARALLEL
    from repro_torch.train.optimizer import tree_map_with_path

    n_shards = mesh.extent(axis)
    sharded = COLUMN_PARALLEL | ROW_PARALLEL
    stack = tree_map_with_path(
        lambda p, w: w if str(p[-1]) in sharded else replicated(w, axis, mesh=mesh), stack)
    x = seq_chunk(x, axis, 1, mesh=mesh)
    pattern = cfg.layer_pattern
    n = stack[0]["attn"]["ln"]["scale"].shape[0]
    for gp in _unbind(stack, n):
        def group(xx, gp=gp):
            for i, kind in enumerate(pattern):
                xx = sp_edpu_layer(gp[i], xx, cfg=cfg, plan=plan, kind=kind, positions=positions,
                                   mesh=mesh, axis=axis, n_shards=n_shards, fused=fused)
            return xx

        if plan.remat and torch.is_grad_enabled():
            x = checkpoint(group, x, use_reentrant=False)
        else:
            x = group(x)
    return x


def _compute_dtype(params: dict) -> torch.dtype:
    """The dtype activations run in: the token embedding's, or, with no
    token embedding (ViT: patches come precomputed), the first layer's FFN
    output weight's.  (JAX takes its first 2-D leaf, which in a stacked
    tree is an f32 norm scale: ROADMAP, deliberate divergences.)"""
    if "embed" in params:
        return params["embed"].dtype
    blocks = params["blocks"]
    first = blocks["stack"][0] if blocks["stack"] is not None else blocks["tail"][0]
    return first["ffn"]["w2"].dtype


def _vocab_split(params: dict, cfg: ArchConfig, plan: ExecutionPlan, mesh):
    """(mesh, this rank's first vocab row) where the embedding and the LM
    head hold this rank's slice of the vocabulary (``embed_shard ==
    "vocab"`` under tensor parallelism or Megatron-SP: every model rank sees
    the same rows, so the lookup and the cross-entropy run vocab-parallel),
    else None.  Read off the leaves' shapes."""
    w = params.get("embed")
    rows = (w.shape[0] if w is not None
            else params["lm_head"].shape[-1] if "lm_head" in params else cfg.vocab_size)
    if mesh is None or rows == cfg.vocab_size:
        return None
    from repro_torch.dist.sharding import tensor_parallel

    if not (tensor_parallel(plan) or plan.seq_parallel_acts):
        raise ValueError(f"a {rows}-row slice of the {cfg.vocab_size}-row vocabulary outside "
                         "tensor or sequence parallelism: gather the FSDP shards first "
                         "(lm_loss(shardings=))")
    return mesh, mesh.index("model") * rows


def _embed_inputs(params: dict, batch: dict, cfg: ArchConfig, t, dtype, vocab=None):
    """Prefix + token embeddings and positions: (x, positions, prefix_len).

    ``batch["prefix_embeds"]`` (B, P, d), when given, goes in front of the
    token embeddings (``prefix_len`` = P; P may be 0); ``batch["tokens"]``
    is embedded when the model has a token embedding.  ``t`` is None (a
    pass from position 0: positions (1, S)), an int (a dense cache's filled
    length: positions (1, S) from t) or a (B,) tensor (the paged cache's
    per-slot lengths: positions (B, S)).  Learned and sinusoidal positions
    are added to x from position t (the sinusoids computed at their offset,
    not sliced from a ``max_seq_len`` table).  ``vocab`` (``_vocab_split``):
    each rank looks its tokens up in its own rows, zeroes the rest, and g
    (``row_sum``) sums the ranks' parts."""
    parts = []
    prefix_len = 0
    if "prefix_embeds" in batch:
        parts.append(batch["prefix_embeds"].to(dtype))
        prefix_len = batch["prefix_embeds"].shape[1]
    if "tokens" in batch and "embed" in params:
        table, tokens = params["embed"].to(dtype), batch["tokens"].long()
        if vocab is None:
            emb = table[tokens]
        else:
            from repro_torch.dist.collectives import row_sum

            mesh, v0 = vocab
            local = tokens - v0
            inside = (local >= 0) & (local < table.shape[0])
            emb = table[local.clamp(0, table.shape[0] - 1)].masked_fill(~inside[..., None], 0)
            emb = row_sum(emb, mesh=mesh)
        if cfg.activation == "geglu":  # gemma family scales embeddings
            emb = emb * torch.tensor(cfg.d_model**0.5, dtype=emb.dtype, device=emb.device)
        parts.append(emb)
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    S, dev = x.shape[1], x.device
    ar = torch.arange(S, device=dev)[None, :]
    if isinstance(t, torch.Tensor):
        positions = t.long()[:, None] + ar
    else:
        positions = ar + (t or 0)
    if cfg.pos_embedding == "learned":
        off = int(t or 0)
        x = x + params["pos"].to(dtype)[off:off + S][None]
    elif cfg.pos_embedding == "sinusoidal":
        x = x + L.sinusoidal_positions(S, cfg.d_model, int(t or 0), dev).to(dtype)[None]
    return x, positions, prefix_len


def _encode(params: dict, enc_embeds: torch.Tensor, cfg: ArchConfig, plan: ExecutionPlan,
            dtype, fused: bool, gathers=None, tp=None) -> torch.Tensor:
    """The encoder of an encoder-decoder: sinusoidal positions, the
    ``params["encoder"]`` stack with bidirectional attention, its final
    norm.  Returns the memory (B, Se, d) and the stack's aux loss.  ``tp``:
    the encoder's layers run on this rank's shards, as the decoder's."""
    enc = enc_embeds.to(dtype)
    Se, dev = enc.shape[1], enc.device
    enc = enc + L.sinusoidal_positions(Se, cfg.d_model, device=dev).to(dtype)[None]
    positions = torch.arange(Se, device=dev)[None, :]

    def enc_layer_fn(lp, xx, kind, c):
        return edpu_layer(lp, xx, cfg=cfg, plan=plan, kind=kind, positions=positions,
                          causal_override=False, fused=fused, tp=tp)

    specs = None if gathers is None else gathers.specs["encoder"]
    enc, _, aux = _run_stack(params["encoder"], enc, enc_layer_fn, ("attn",), remat=plan.remat,
                             gathers=gathers, specs=specs)
    return _norm(params["encoder"]["final_norm"], enc, cfg.norm, fused), aux


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
    with_aux: bool = False,
    mesh=None,
    gathers=None,
    batch_axes: tuple = (),
):
    """The model over ``batch``: ``"tokens"`` (B, S), optional
    ``"prefix_embeds"`` (B, P, d) in front of them, and an encoder-decoder's
    ``"enc_embeds"`` (B, Se, d) (unless the cache holds the encoder's
    ``"memory"``).  The compute dtype is the embedding's (norms stay f32);
    an encoder-only arch attends bidirectionally.  Returns ``(hidden (B,
    P + S, d), cache)``, or, ``with_aux``, ``(hidden, cache, aux)`` with
    ``aux`` the decoder stack's summed MoE aux loss (0.0 without MoE; the
    encoder's is dropped, as JAX's ``forward`` drops it).

    ``fused=False`` runs the plain versions of the kernels on any device
    (the oracle): the norms and, with no cache, the flash and WKV kernels;
    a paged step's attention follows ``page_state["fused"]``.

    * ``cache=None``: a pass from position 0; with ``collect_cache`` the
      returned cache is ``{"layers": per-layer harvest, "t": S}`` (plus
      ``"memory"`` for an encoder-decoder) for ``cache_from_prefill``, else
      None.
    * a dense cache ``{"layers", "t": int}`` (S == 1): one decode step,
      written in place; returns the cache with ``t + 1``.
    * a paged cache ``{"layers": pools, "t": lens}`` with ``lens`` the
      per-slot (B,) count of positions already cached, and ``page_state =
      {"table": (B, MB), "block_size", "q_lens": (B,) live rows per slot,
      "fused": bool[, "max_blocks"]}``: one continuous-batching serve step;
      the pools are updated in place and ``t`` advances by S.

    With ``plan.seq_parallel_acts`` and a ``mesh`` (a pass from position 0
    without a prefix or a harvest), the stacked groups run through the
    Megatron-SP path (:func:`sp_stack_forward`) on this rank's shards, and
    their output is gathered back to the whole sequence; the tail layers,
    the final norm and what follows run replicated on every rank of the
    model axis.  Under tensor parallelism without SP
    (``dist.sharding.tensor_parallel``) every layer runs on this rank's
    shards (``edpu_layer``'s ``tp``), with no cache, over the paged pools
    of this rank's KV heads, or over a dense cache of this rank's heads
    (``cache.init_cache(shardings=)``; ``collect_cache`` harvests this
    rank's heads); the final norm runs replicated.  Under both,
    an embedding cut over ``vocab`` is looked up vocab-parallel
    (``_vocab_split``).  ``batch`` is this rank's rows (``lm_loss`` cuts
    them).  ``gathers`` (``dist.collectives.FSDPGathers``): the layer
    stacks' leaves are FSDP shards, gathered where they are read
    (``_run_stack``); the caller gathers the embedding and the head
    (``FSDPGathers.top``: ``lm_loss`` does).  ``batch_axes``: the mesh axes
    that split the batch (``lm_loss``'s), over which MoE layers take their
    aux loss's statistics."""
    dtype = _compute_dtype(params)
    t = None if cache is None else cache["t"]
    vocab = _vocab_split(params, cfg, plan, mesh)
    x, positions, prefix_len = _embed_inputs(params, batch, cfg, t, dtype, vocab)
    S = x.shape[1]
    tp = None
    if mesh is not None:
        from repro_torch.dist.sharding import tensor_parallel

        if tensor_parallel(plan):
            tp = mesh
    memory = None
    if cfg.enc_dec:
        if cache is not None and "memory" in cache:
            memory = cache["memory"]
        else:
            memory, _ = _encode(params, batch["enc_embeds"], cfg, plan, dtype, fused, gathers,
                                tp=tp)
            memory = memory_input(params, memory, cfg, tp)
    causal_override = False if cfg.encoder_only else None

    dp = (mesh, batch_axes) if mesh is not None and batch_axes else None

    def layer_fn(lp, xx, kind, c):
        return edpu_layer(
            lp, xx, cfg=cfg, plan=plan, kind=kind, positions=positions, cache=c,
            memory=memory, prefix_len=prefix_len, causal_override=causal_override,
            collect=collect_cache, page_state=page_state, fused=fused, tp=tp, dp=dp,
        )

    layers = None if cache is None else cache["layers"]
    specs = None if gathers is None else gathers.specs["blocks"]
    use_sp = (
        plan.seq_parallel_acts
        and mesh is not None
        and cache is None
        and not collect_cache
        and prefix_len == 0
        and params["blocks"]["stack"] is not None
    )
    if use_sp:
        from repro_torch.dist.collectives import seq_gather

        x = sp_stack_forward(params["blocks"]["stack"], x, cfg=cfg, plan=plan, mesh=mesh,
                             positions=positions, fused=fused)
        x = seq_gather(x, "model", 1, mesh=mesh)
        # tail layers (if any) run replicated
        x, _, aux = _run_stack({"stack": None, "tail": params["blocks"]["tail"]}, x, layer_fn,
                               cfg.layer_pattern, None, remat=plan.remat, gathers=gathers,
                               specs=specs)
        new_layers = None
    else:
        x, new_layers, aux = _run_stack(params["blocks"], x, layer_fn, cfg.layer_pattern, layers,
                                        remat=plan.remat, gathers=gathers, specs=specs)
    x = _norm(params["final_norm"], x, cfg.norm, fused)
    if cache is not None:
        out = x, {**cache, "layers": new_layers, "t": cache["t"] + S}
    elif collect_cache:
        pc = {"layers": new_layers, "t": S}
        if memory is not None:
            pc["memory"] = memory
        out = x, pc
    else:
        out = x, None
    return (*out, aux) if with_aux else out


def logits_fn(params: dict, x: torch.Tensor, cfg: ArchConfig, mesh=None) -> torch.Tensor:
    """Token logits (B, S, V), or, for a classifier (``n_classes``), class
    logits (B, n_classes) of the mean over positions.  A head cut over
    ``vocab`` (tensor parallelism, ``mesh`` given) computes this rank's
    columns, and the ranks' columns are gathered (serving reads the whole
    row; not differentiable)."""
    if cfg.n_classes:
        return x.mean(dim=1) @ params["cls_head"]
    w: Optional[torch.Tensor] = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    logits = x @ w
    if mesh is not None and logits.shape[-1] < cfg.vocab_size:
        from repro_torch.dist.collectives import all_gather

        logits = all_gather(logits, "model", mesh, dim=logits.ndim - 1, kind="vocab_gather")
    return logits


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def _xent_chunk(xc: torch.Tensor, w: torch.Tensor, tc: torch.Tensor,
                mc: torch.Tensor) -> tuple:
    """(summed masked cross-entropy of one chunk, its f32 logsumexp): f32
    logits (B, c, V)."""
    logits = (xc @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, -1, tc.long()[..., None])[..., 0]
    return ((lse - tl) * mc).sum(), lse


class _XentChunk(torch.autograd.Function):
    """``_xent_chunk`` with its f32 logits recomputed in the backward (as a
    checkpoint of it would), where the gradient of the logits is formed in
    their own buffer: one f32 (B, c, V) tensor live, not autograd's several
    (B 4 x 512 x 200,064 f32 is 1.6 GB each).  The same operations in the
    same order as autograd's, so the same values."""

    @staticmethod
    def forward(ctx, xc, w, tc, mc):
        loss, lse = _xent_chunk(xc, w, tc, mc)
        ctx.save_for_backward(xc, w, tc, mc, lse)
        return loss

    @staticmethod
    def backward(ctx, dl):
        xc, w, tc, mc, lse = ctx.saved_tensors
        d = dl * mc
        p = (xc @ w).float()
        p.sub_(lse[..., None]).exp_().mul_(d[..., None])
        p.scatter_add_(-1, tc.long()[..., None], -d[..., None])
        g = p.to(xc.dtype)
        del p
        dx = g @ w.T
        x2, g2 = xc.reshape(-1, xc.shape[-1]), g.reshape(-1, g.shape[-1])
        # autograd's product for a column-major w (a tied head, embed.T) is
        # taken transposed, as here
        dw = (g2.T @ x2).T if w.stride() == (1, w.shape[0]) else x2.T @ g2
        return dx, dw, None, None


class _VocabXentChunk(torch.autograd.Function):
    """``_xent_chunk`` with ``w`` this rank's (d, V/n) vocab columns: the
    logsumexp from the ranks' maxima (one all-reduce max) and sums of
    exponentials, and the target logit from the rank that holds it (one
    all-reduce sum of both).  The f32 logits are recomputed in the backward,
    as ``_XentChunk`` recomputes them; ``dx`` is this rank's
    partial (f's backward on x sums it over the ranks), ``dw`` this rank's
    columns' whole gradient."""

    @staticmethod
    def forward(ctx, xc, w, tc, mc, mesh, v0):
        from repro_torch.dist.collectives import all_reduce

        logits = (xc @ w).float()
        m = all_reduce(logits.amax(dim=-1), "model", mesh, op="max", kind="vocab_max")
        t = tc.long() - v0
        inside = (t >= 0) & (t < logits.shape[-1])
        tl = torch.gather(logits, -1, t.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        parts = torch.stack([torch.exp(logits - m[..., None]).sum(dim=-1),
                             torch.where(inside, tl, torch.zeros_like(tl))])
        s, tl = all_reduce(parts, "model", mesh, kind="vocab_sum").unbind(0)
        lse = m + torch.log(s)
        ctx.save_for_backward(xc, w, tc, mc, lse)
        ctx.v0 = v0
        return ((lse - tl) * mc).sum()

    @staticmethod
    def backward(ctx, dl):
        xc, w, tc, mc, lse = ctx.saved_tensors
        logits = (xc @ w).float()
        p = torch.exp(logits - lse[..., None])
        t = tc.long() - ctx.v0
        inside = (t >= 0) & (t < logits.shape[-1])
        p.scatter_add_(-1, t.clamp(0, logits.shape[-1] - 1)[..., None],
                       -inside.to(p.dtype)[..., None])
        g = (p * (mc * dl)[..., None]).to(xc.dtype)
        dx = g @ w.T
        dw = xc.reshape(-1, xc.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return dx, dw.to(w.dtype), None, None, None, None


def chunked_softmax_xent(
    x: torch.Tensor,
    w: torch.Tensor,
    targets: torch.Tensor,
    loss_mask: Optional[torch.Tensor] = None,
    chunk: int = 512,
    vocab=None,
):
    """Cross-entropy without materializing the whole (B, S, V) logits.

    x: (B, S, d); w: (d, V); targets: (B, S) int.  Returns (summed loss,
    number of tokens, at least 1), both f32 scalars.  The sequence is cut
    into chunks of ``chunk`` positions (halved until it divides S, as in
    JAX); with autograd recording, each chunk's f32 logits are recomputed in
    the backward instead of saved (B 8 x 512 x 151,936 f32 is 2.5 GB a
    chunk; ``_XentChunk``).
    ``vocab`` (``_vocab_split``): ``w`` holds this rank's vocab columns and
    each chunk runs vocab-parallel (``_VocabXentChunk``)."""
    B, S, _ = x.shape
    c = min(chunk, S)
    while S % c:
        c //= 2
    mask = (torch.ones((B, S), dtype=torch.float32, device=x.device) if loss_mask is None
            else loss_mask.float())
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, c):
        args = (x[:, i:i + c], w, targets[:, i:i + c], mask[:, i:i + c])
        total = total + (_XentChunk.apply(*args) if vocab is None
                         else _VocabXentChunk.apply(*args, *vocab))
    return total, torch.clamp(mask.sum(), min=1.0)


def _head_loss(params: dict, x: torch.Tensor, batch: dict, cfg: ArchConfig, aux, vocab=None):
    """The loss from the final hidden states: a classifier's (``n_classes``,
    over ``batch["label"]``) or the LM's over ``batch["targets"]`` (the
    prefix embeddings' positions dropped, ``batch["loss_mask"]`` applied),
    plus 0.01 x the aux loss.  ``vocab``: the head holds this rank's vocab
    columns; the replicated hidden states enter it through f
    (``column_input``), whose backward sums the ranks' partial gradients."""
    if cfg.n_classes:
        logits = logits_fn(params, x, cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        tl = torch.gather(logits, -1, batch["label"].long()[:, None])[:, 0]
        return (lse - tl).mean() + 0.01 * aux
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T.to(x.dtype)
    prefix = batch.get("prefix_embeds")
    if prefix is not None:
        x = x[:, prefix.shape[1]:]  # the prefix carries no targets
    if vocab is not None:
        from repro_torch.dist.collectives import column_input

        x = column_input(x, mesh=vocab[0])
    total, n = chunked_softmax_xent(x, w, batch["targets"], batch.get("loss_mask"), vocab=vocab)
    return total / n + 0.01 * aux


def _fsdp_gathers(params: dict, sh, shardings, batch_axes) -> tuple:
    """(``params`` with the embedding and head gathered, the pass's
    ``FSDPGathers``) where ``shardings`` (the manual shardings) name FSDP
    shards over the data axes, else (``params``, None); raises for a plan
    that shards the weights over the data axes without them."""
    from repro_torch.dist.collectives import FSDPGathers
    from repro_torch.train.optimizer import tree_leaves

    if shardings is None:
        if ((sh.plan.zero_weights or sh.plan.dp_over_model)
                and sh.mesh.extent(sh.fsdp_axes()) > 1):
            raise ValueError("this plan shards the weights over the data axes (FSDP): pass "
                             "shardings= (Shardings.manual_param_shardings)")
        return params, None
    specs = sh.gather_specs(shardings)
    if all(s is None for s in tree_leaves(specs)):
        return params, None
    gathers = FSDPGathers(sh.mesh, specs, batch_axes)
    return gathers.top(params), gathers


def lm_loss(params: dict, batch: dict, *, cfg: ArchConfig, plan: ExecutionPlan,
            fused: bool = True, mesh=None, shardings=None) -> torch.Tensor:
    """The training loss (the port's ``repro.models.transformer.lm_loss``):
    the no-cache forward, then ``_head_loss``.  ``fused=False`` runs every
    kernel's plain version (the oracle).

    With a ``mesh``, ``batch`` is the global batch: this rank takes its rows
    (``Shardings.local_batch``: dim 0 over the axes that split the batch),
    runs the forward on them (Megatron-SP under ``plan.seq_parallel_acts``)
    and returns the loss averaged over those axes, whose backward gives each
    rank 1/n of its rows' gradient: the train step sums the gradients over
    the same axes.  ``shardings`` (the parameters' manual shardings,
    ``Shardings.manual_param_shardings``) names the FSDP shards: the
    embedding and head are gathered before the pass, each layer's leaves in
    it, and their gradients reduce-scattered in the backward; a plan that
    shards weights over the data axes needs it."""
    if mesh is None:
        x, _, aux = forward(params, batch, cfg=cfg, plan=plan, fused=fused, with_aux=True)
        return _head_loss(params, x, batch, cfg, aux)
    from repro_torch.dist.collectives import mean_over
    from repro_torch.dist.sharding import Shardings

    sh = Shardings(mesh, plan, cfg)
    axes = sh.batch_axes_for(next(iter(batch.values())).shape[0])
    local = sh.local_batch(batch)
    params, gathers = _fsdp_gathers(params, sh, shardings, axes)
    x, _, aux = forward(params, local, cfg=cfg, plan=plan, fused=fused, with_aux=True, mesh=mesh,
                        gathers=gathers, batch_axes=axes or ())
    loss = _head_loss(params, x, local, cfg, aux, _vocab_split(params, cfg, plan, mesh))
    return mean_over(loss, axes, mesh=mesh)


def check_pipeline_supported(cfg: ArchConfig, plan: ExecutionPlan, batch: int):
    """Raise with every reason a ``pod_role="pipeline"`` plan cannot route
    through ``pipeline_lm_loss``; return (n_stage, n_micro) when it can."""
    n_stage = plan.pod_axis
    n_micro = plan.microbatches
    reasons = []
    if n_stage <= 1:
        reasons.append("pod axis has a single stage")
    if plan.model_axis > 1:
        # the stage weights are sliced over `pod` only: a >1 model axis
        # would duplicate the stage compute across it
        reasons.append(
            f"model axis {plan.model_axis} > 1 (pipeline composes with DP, "
            "not TP; put the spare devices on 'data')"
        )
    if cfg.is_moe:
        reasons.append("MoE aux losses do not cross stage boundaries yet")
    if cfg.enc_dec or cfg.frontend != "none":
        reasons.append("enc-dec/frontends keep non-stack state")
    if batch % max(n_micro, 1):
        reasons.append(f"batch {batch} not divisible by microbatches {n_micro}")
    elif (batch // max(n_micro, 1)) % max(plan.data_axis, 1):
        # replication across DP replicas must fail loudly, never run silently
        reasons.append(
            f"microbatch {batch // max(n_micro, 1)} does not fold over "
            f"data axis {plan.data_axis}"
        )
    if n_micro < n_stage:
        reasons.append(f"microbatches {n_micro} < stages {n_stage}")
    if reasons:
        raise ValueError("pod_role='pipeline' plan cannot execute: " + "; ".join(reasons))
    return n_stage, n_micro


def pipeline_lm_loss(params: dict, batch: dict, *, cfg: ArchConfig, plan: ExecutionPlan,
                     mesh, fused: bool = True, shardings=None) -> torch.Tensor:
    """LM loss with the stacked layer-groups run as pipeline stages over the
    ``pod`` axis (``dist.pipeline.pipeline_forward``).

    ``batch`` is the global batch; this rank takes its rows of each
    microbatch (JAX's layout: (n_micro, B / n_micro) with dim 1 over the
    data axes).  ``params["blocks"]["stack"]`` is this stage's slice of the
    groups (``n_groups / n_stage`` of them: the launcher checks that they
    split).  The embedding, tail layers, final norm and loss head run on
    every stage, on the same tokens, so the result is the data-parallel
    loss: only the schedule changes.  Returns the loss averaged over the
    data axes, as ``lm_loss``.

    ``shardings`` (the manual shardings, as ``lm_loss`` takes them) names
    the FSDP shards over the data axes (ZeRO, ``dp_over_model``).  The
    stage's slice is gathered whole over them once a step, here at the
    stage's entry, where GSPMD reshards JAX's slice to the ``shard_map``'s
    ``P("pod", ...)`` in-spec: every tick and remat's recompute read that
    one copy, and its gradient, summed over the ticks by the schedule's
    backward, is reduce-scattered over the data axes by the gather's
    backward.  The tail layers gather where they are read, the embedding
    and head before the pass.  The pod axis carries the ticks' permutes and
    the data axes the gathers and scatters: every rank issues the same
    calls in the same order."""
    from repro_torch.dist.collectives import mean_over
    from repro_torch.dist.pipeline import pipeline_forward
    from repro_torch.dist.sharding import Shardings, local_shard

    B = next(iter(batch.values())).shape[0]
    n_stage, n_micro = check_pipeline_supported(cfg, plan, B)
    sh = Shardings(mesh, plan, cfg)
    batch_axes = sh.batch_axes_for(B // n_micro) or ()
    entry = sh._entry(batch_axes)
    params, gathers = _fsdp_gathers(params, sh, shardings, batch_axes)
    stack = params["blocks"]["stack"]
    if gathers is not None:
        stack = gathers.tree(stack, gathers.specs["blocks"]["stack"])

    def rows(v):
        m = v.reshape(n_micro, B // n_micro, *v.shape[1:])
        m = local_shard(m, (None, entry), mesh)
        return m.reshape(-1, *v.shape[1:])

    local = {k: rows(v) for k, v in batch.items()}
    x, positions, prefix_len = _embed_inputs(params, local, cfg, None, _compute_dtype(params))
    Bl, S, D = x.shape
    micro = x.reshape(n_micro, Bl // n_micro, S, D)
    pattern = cfg.layer_pattern
    causal_override = False if cfg.encoder_only else None

    def layer_fn(lp, xx, kind, c):
        return edpu_layer(lp, xx, cfg=cfg, plan=plan, kind=kind, positions=positions,
                          prefix_len=prefix_len, causal_override=causal_override, fused=fused)

    def stage_fn(wl, xm):
        xm, _, _ = _run_stack({"stack": wl, "tail": ()}, xm, layer_fn, pattern, remat=plan.remat)
        return xm

    pp = pipeline_forward(stage_fn, mesh, axis="pod", batch_axes=tuple(batch_axes))
    x = pp(stack, micro).reshape(Bl, S, D)
    x, _, aux = _run_stack({"stack": None, "tail": params["blocks"]["tail"]}, x, layer_fn,
                           pattern, remat=plan.remat, gathers=gathers,
                           specs=None if gathers is None else gathers.specs["blocks"])
    x = _norm(params["final_norm"], x, cfg.norm, fused)
    return mean_over(_head_loss(params, x, local, cfg, aux), batch_axes, mesh=mesh)
