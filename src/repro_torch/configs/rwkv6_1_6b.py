"""RWKV-6 "Finch" 1.6B (attention-free, data-dependent decay).
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads (head_size 64)
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab_size=65536,
    layer_pattern=("rwkv6",),
    rnn_heads=32,
    norm="layernorm",
    activation="rwkv",
    pos_embedding="none",
    tie_embeddings=False,
    source="arXiv:2404.05892",
)
