"""Mixtral-8x7B (8 experts top-2, sliding-window attention).
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    layer_pattern=("swa",),
    n_experts=8,
    top_k=2,
    moe_d_ff=14336,
    norm="rmsnorm",
    activation="swiglu",
    source="arXiv:2401.04088",
)
