"""Architecture configuration — the "Transformer model configuration
information" of paper Table III (Head, Embed_dim, Dff, L) generalized to the
assigned architecture pool (dense / MoE / SSM / hybrid / VLM / audio).

A copy of ``repro/configs/base.py``: the port keeps its own so that it never
imports the JAX package.  Keep the two in step."""
from __future__ import annotations

import dataclasses
from typing import Tuple

LayerKind = str  # "attn" | "swa" | "local" | "rglru" | "rwkv6"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # --- attention details ---------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"  # rope | sinusoidal | learned | none
    sliding_window: int = 0  # 0 = full attention (for "swa" layers)
    local_window: int = 0  # window of "local" attention layers (hybrid)
    layer_pattern: Tuple[LayerKind, ...] = ("attn",)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | geglu | gelu | rwkv
    # --- MoE -------------------------------------------------------------------
    n_experts: int = 1
    top_k: int = 1
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # --- recurrent blocks -------------------------------------------------------
    rnn_heads: int = 0  # RWKV6 wkv heads
    lru_width: int = 0  # RG-LRU recurrence width
    conv_width: int = 4  # temporal conv of the RG-LRU block
    # --- encoder / decoder ------------------------------------------------------
    enc_dec: bool = False
    encoder_only: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0  # fixed encoder length (whisper: 1500 frames)
    # --- modality frontend stub ("input_specs provides precomputed embeddings") -
    frontend: str = "none"  # none | vision | audio
    n_prefix_embeds: int = 0
    n_classes: int = 0  # encoder-only classifier head (ViT)
    tie_embeddings: bool = True
    causal: bool = True
    max_seq_len: int = 1 << 20
    source: str = ""

    # ------------------------------------------------------------------ helpers
    def layer_kind(self, i: int) -> LayerKind:
        return self.layer_pattern[i % len(self.layer_pattern)]

    @property
    def attention_free(self) -> bool:
        return all(k in ("rglru", "rwkv6") for k in self.layer_pattern)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 1

    def fused_qkv_ok(self) -> bool:
        """C5 Independent-Linear applies whenever the arch has attention."""
        return not self.attention_free

    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists: SSM/linear-recurrence state or a bounded
        attention window. Pure full attention -> False (skip long_500k)."""
        kinds = set(self.layer_pattern)
        if kinds & {"rglru", "rwkv6"}:
            return True
        if "attn" in kinds and self.sliding_window == 0:
            return False
        return all(
            (k == "swa" and self.sliding_window > 0)
            or (k == "local" and self.local_window > 0)
            or k in ("rglru", "rwkv6")
            for k in kinds
        )

    def effective_ff_width(self) -> int:
        """Hidden width that activations actually traverse per token."""
        if self.is_moe:
            return self.moe_d_ff * self.top_k
        return self.d_ff

    # ------------------------------------------------------------- param counts
    def _ffn_params(self) -> int:
        if self.is_moe:
            per = self.d_model * self.moe_d_ff
            mult = 3 if self.activation in ("swiglu", "geglu") else 2
            return self.n_experts * mult * per + self.d_model * self.n_experts
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        if self.activation == "rwkv":
            mult = 2  # channel-mix: Wk (d->dff), Wv (dff->d); Wr folded below
        return mult * self.d_model * self.d_ff

    def _attn_params(self) -> int:
        qkv = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        out = self.n_heads * self.d_head * self.d_model
        return qkv + out

    def _layer_params(self, kind: LayerKind) -> int:
        if kind in ("attn", "swa", "local"):
            core = self._attn_params()
        elif kind == "rglru":
            w = self.lru_width or self.d_model
            # in/out proj (x2 branches), temporal conv, recurrence + input gates
            core = (
                2 * self.d_model * w
                + w * self.d_model
                + self.conv_width * w
                + 2 * w * w // max(self.rnn_heads, 1)
                + 2 * w
            )
        elif kind == "rwkv6":
            d = self.d_model
            # r,k,v,o + gates (lora decays ~small)
            core = 4 * d * d + d * self.rnn_heads * self.d_head
        else:
            raise ValueError(kind)
        return core + self._ffn_params() + 2 * self.d_model  # norms

    def param_count(self, active_only: bool = False) -> int:
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            p = self._layer_params(kind)
            if active_only and self.is_moe:
                per = self.d_model * self.moe_d_ff
                mult = 3 if self.activation in ("swiglu", "geglu") else 2
                p = p - self.n_experts * mult * per + self.top_k * mult * per
            total += p
        if self.enc_dec:
            for _ in range(self.n_enc_layers):
                total += self._layer_params("attn")  # encoder self-attn layers
                total += self._attn_params()  # decoder cross-attn (paired)
        if self.n_classes:
            total += self.d_model * self.n_classes
        return int(total)

    # ----------------------------------------------------------------- reduced
    def reduced(self) -> "ArchConfig":
        """Smoke-test-sized member of the same family (task spec f)."""
        n_layers = max(2, len(self.layer_pattern))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=64,
            n_heads=2,
            n_kv_heads=1 if self.n_kv_heads < self.n_heads else 2,
            d_head=32,
            d_ff=128,
            vocab_size=512,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            local_window=min(self.local_window, 16) if self.local_window else 0,
            n_experts=4 if self.is_moe else 1,
            top_k=min(self.top_k, 2) if self.is_moe else 1,
            moe_d_ff=64 if self.is_moe else 0,
            # drop-free at smoke scale so prefill/decode match the full pass
            moe_capacity_factor=float(self.n_experts) if self.is_moe else 1.25,
            rnn_heads=2 if self.rnn_heads else 0,
            lru_width=64 if self.lru_width else 0,
            n_enc_layers=2 if self.enc_dec else 0,
            enc_seq=8 if self.enc_dec else 0,
            n_prefix_embeds=4 if self.n_prefix_embeds else 0,
            n_classes=16 if self.n_classes else 0,
            max_seq_len=4096,
        )
