"""Qwen3-1.7B dense (qk_norm, GQA). [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    activation="swiglu",
    source="hf:Qwen/Qwen3-1.7B",
)
