"""PaliGemma-3B (SigLIP frontend stub + gemma-2B decoder backbone).
[arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab_size=257216,
    norm="rmsnorm",
    activation="geglu",
    frontend="vision",
    n_prefix_embeds=256,  # 224/14 = 16x16 SigLIP patches, precomputed (stub)
    source="arXiv:2407.07726",
)
