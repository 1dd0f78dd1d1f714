"""Qwen3-30B-A3B (128 experts top-8, fine-grained MoE).
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    norm="rmsnorm",
    activation="swiglu",
    source="hf:Qwen/Qwen3-30B-A3B",
)
