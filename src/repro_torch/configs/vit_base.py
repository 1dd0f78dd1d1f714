"""ViT-Base — the paper's second benchmark model (§V, L=197, Int8).
Encoder-only; patch embedding provided precomputed (frontend stub)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="vit-base",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=1,  # no token embedding; patches come precomputed
    encoder_only=True,
    causal=False,
    norm="layernorm",
    activation="gelu",
    pos_embedding="learned",
    frontend="vision",
    n_prefix_embeds=197,  # 14x14 patches + cls
    n_classes=1000,
    max_seq_len=256,
    source="paper Table IV (ViT-Base, L=197)",
)
