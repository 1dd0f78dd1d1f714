"""BERT-Base — the paper's own primary benchmark model (§V, L=256, Int8).
Encoder-only bidirectional transformer."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="bert-base",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=30522,
    encoder_only=True,
    causal=False,
    norm="layernorm",
    activation="gelu",
    pos_embedding="learned",
    max_seq_len=512,
    source="paper Table IV (BERT-Base, L=256)",
)
