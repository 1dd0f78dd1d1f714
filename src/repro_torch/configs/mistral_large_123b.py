"""Mistral-Large-Instruct-2407 (123B dense).
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    activation="swiglu",
    tie_embeddings=False,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
