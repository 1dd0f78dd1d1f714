"""Parameter initialization (the port's ``repro/models/params.py``).

The tree has the JAX package's shape: ``blocks.stack`` holds the n_full
pattern-groups, each leaf stacked on a leading axis, ``blocks.tail`` the
remainder layers, then ``embed`` (absent when ``vocab_size == 1``: ViT's
patches come precomputed), learned ``pos``, ``final_norm``, ``lm_head``,
the classifier's ``cls_head`` and, for an encoder-decoder, the ``encoder``
tree (``{"stack", "tail": (), "final_norm"}``) and each decoder layer's
``cross`` leaves (split ``wq/wk/wv``, no qk-norm).  Leaves and scales are
the JAX ones for attention layers with a dense or MoE FFN (``router``,
``w1``/``w3`` (E, d, F), ``w2`` (E, F, d)), for RWKV-6 layers (time-mix +
channel-mix) and for RG-LRU layers (``lam`` the f32 ``linspace(-2, 1, W)``,
not a draw; params.py:43-184); the numbers differ, because a
``torch.Generator`` is not a ``jax.random`` key.
Parameters are a plain nested dict of tensors, not ``nn.Module``s, so the
bridge and the tests compare like with like.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import ExecutionPlan


# A leaf of more elements than this is drawn one leading-axis slice at a
# time into the target dtype: qwen3-moe-30b-a3b's stacked expert w1 (48 x
# 128 x 2048 x 768) would take 38.7 GB in f32 whole, against 60.4 GB of bf16
# weights on an 80 GB card; a slice takes 0.8 GB.  Only the full-size
# mixtral-8x7b, qwen3-moe-30b-a3b and mistral-large-123b have leaves above
# it: every other arch draws each leaf whole.
SLICE_ABOVE = 2**30


class _Init:
    """Draws every leaf from one explicit generator, in f32, then casts."""

    def __init__(self, generator: torch.Generator, dtype, device):
        self.gen, self.dtype, self.device = generator, dtype, device

    def _draw(self, shape, scale):
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return x.mul_(scale).to(self.dtype)

    def normal(self, shape, scale=0.02):
        shape = tuple(shape)
        if len(shape) < 2 or math.prod(shape) <= SLICE_ABOVE:
            return self._draw(shape, scale)
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        for i in range(shape[0]):
            out[i] = self._draw(shape[1:], scale)
        return out

    def zeros(self, shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def norm(self, cfg: ArchConfig, shape) -> dict:
        z = dict(dtype=torch.float32, device=self.device)
        if cfg.norm == "rmsnorm":
            return {"scale": torch.zeros(shape, **z)}
        return {"scale": torch.ones(shape, **z), "bias": torch.zeros(shape, **z)}


def _attn_params(init: _Init, cfg: ArchConfig, plan: ExecutionPlan, lead: tuple,
                 cross: bool = False) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p: dict = {"ln": init.norm(cfg, lead + (d,))}
    if plan.fuse_qkv and not cross:
        p["wqkv"] = init.normal(lead + (d, (H + 2 * KV) * Dh))
    else:
        p["wq"] = init.normal(lead + (d, H * Dh))
        p["wk"] = init.normal(lead + (d, KV * Dh))
        p["wv"] = init.normal(lead + (d, KV * Dh))
    p["wo"] = init.normal(lead + (H * Dh, d), scale=0.02 / max(1, cfg.n_layers) ** 0.5)
    if cfg.qk_norm and not cross:
        z = dict(dtype=torch.float32, device=init.device)
        p["q_norm"] = torch.zeros(lead + (Dh,), **z)
        p["k_norm"] = torch.zeros(lead + (Dh,), **z)
    return p


def _ffn_params(init: _Init, cfg: ArchConfig, lead: tuple) -> dict:
    d, F = cfg.d_model, cfg.d_ff
    p: dict = {"ln": init.norm(cfg, lead + (d,))}
    if cfg.is_moe:
        E, F = cfg.n_experts, cfg.moe_d_ff
        p["router"] = init.normal(lead + (d, E))
        p["w1"] = init.normal(lead + (E, d, F))
        if cfg.activation in ("swiglu", "geglu"):
            p["w3"] = init.normal(lead + (E, d, F))
        p["w2"] = init.normal(lead + (E, F, d))
        return p
    if cfg.activation == "rwkv":  # channel-mix
        p["mix_k"] = init.zeros(lead + (d,))
        p["mix_r"] = init.zeros(lead + (d,))
        p["w1"] = init.normal(lead + (d, F))
        p["w_r"] = init.normal(lead + (d, d))
        p["w2"] = init.normal(lead + (F, d))
        return p
    p["w1"] = init.normal(lead + (d, F))
    if cfg.activation in ("swiglu", "geglu"):
        p["w3"] = init.normal(lead + (d, F))
    p["w2"] = init.normal(lead + (F, d))
    return p


def _rwkv6_params(init: _Init, cfg: ArchConfig, lead: tuple) -> dict:
    d, H, Dh = cfg.d_model, cfg.rnn_heads, cfg.d_head
    hd = H * Dh
    lora = max(32, d // 32)
    z = dict(dtype=torch.float32, device=init.device)
    p = {
        "ln": init.norm(cfg, lead + (d,)),
        "w_r": init.normal(lead + (d, hd)),
        "w_k": init.normal(lead + (d, hd)),
        "w_v": init.normal(lead + (d, hd)),
        "w_g": init.normal(lead + (d, hd)),
        "w_o": init.normal(lead + (hd, d), scale=0.02 / max(1, cfg.n_layers) ** 0.5),
        "lora_a": init.normal(lead + (d, lora)).float(),
        "lora_b": init.normal(lead + (lora, hd)).float(),
        "w0": torch.full(lead + (hd,), -0.6, **z),  # decay ~ exp(-exp(-0.6)) ~ .58
        "u": init.normal(lead + (H, Dh)).float(),
        "gn_scale": torch.ones(lead + (hd,), **z),
        "gn_bias": torch.zeros(lead + (hd,), **z),
    }
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w"):
        p[name] = init.zeros(lead + (d,))
    return p


def _rglru_params(init: _Init, cfg: ArchConfig, lead: tuple) -> dict:
    d, W, Hn = cfg.d_model, cfg.lru_width or cfg.d_model, max(cfg.rnn_heads, 1)
    bh = W // Hn
    lam = torch.linspace(-2.0, 1.0, W, dtype=torch.float32, device=init.device)
    return {
        "ln": init.norm(cfg, lead + (d,)),
        "w_x": init.normal(lead + (d, W)),
        "w_g": init.normal(lead + (d, W)),
        "conv_w": init.normal(lead + (cfg.conv_width, W), scale=0.1),
        "w_gate_a": init.normal(lead + (Hn, bh, bh)),
        "b_gate_a": init.zeros(lead + (W,)),
        "w_gate_x": init.normal(lead + (Hn, bh, bh)),
        "b_gate_x": init.zeros(lead + (W,)),
        # softplus(lam) spans so that a = exp(-8 softplus(lam)) is in (0.7, 0.999)
        "lam": lam.expand(lead + (W,)).clone(),
        "w_out": init.normal(lead + (W, d)),
    }


def _layer_params(init: _Init, cfg: ArchConfig, plan: ExecutionPlan, kind: str,
                  lead: tuple = (), with_cross: bool = False) -> dict:
    if kind in ("attn", "swa", "local"):
        core = {"attn": _attn_params(init, cfg, plan, lead)}
    elif kind == "rglru":
        core = {"attn": _rglru_params(init, cfg, lead)}
    elif kind == "rwkv6":
        core = {"attn": _rwkv6_params(init, cfg, lead)}
    else:
        raise ValueError(kind)
    if with_cross:
        core["cross"] = _attn_params(init, cfg, plan, lead, cross=True)
    core["ffn"] = _ffn_params(init, cfg, lead)
    return core


def init_params(
    cfg: ArchConfig,
    plan: ExecutionPlan,
    dtype=torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> dict:
    """Random weights with the JAX tree and scales, drawn from ``generator``
    (a fresh one seeded 0 on ``device`` when omitted).  On ``"meta"`` the
    leaves are shapes without storage and nothing is drawn."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    init = _Init(generator, dtype, dev)
    pattern = cfg.layer_pattern
    n_full, rem = divmod(cfg.n_layers, len(pattern))
    # leaves of the stacked groups are drawn stacked (no per-group copies)
    cross = cfg.enc_dec
    stack = (
        tuple(_layer_params(init, cfg, plan, kind, (n_full,), cross) for kind in pattern)
        if n_full
        else None
    )
    tail = tuple(_layer_params(init, cfg, plan, pattern[i], (), cross) for i in range(rem))
    params: dict = {"blocks": {"stack": stack, "tail": tail}}
    if cfg.vocab_size > 1:
        params["embed"] = init.normal((cfg.vocab_size, cfg.d_model))
    if cfg.pos_embedding == "learned":
        params["pos"] = init.normal((cfg.max_seq_len, cfg.d_model))
    params["final_norm"] = init.norm(cfg, (cfg.d_model,))
    if not cfg.tie_embeddings and cfg.vocab_size > 1:
        params["lm_head"] = init.normal((cfg.d_model, cfg.vocab_size))
    if cfg.n_classes:
        params["cls_head"] = init.normal((cfg.d_model, cfg.n_classes))
    if cfg.enc_dec:
        params["encoder"] = {
            "stack": (_layer_params(init, cfg, plan, "attn", (cfg.n_enc_layers,)),),
            "tail": (),
            "final_norm": init.norm(cfg, (cfg.d_model,)),
        }
    return params
