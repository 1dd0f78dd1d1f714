"""RecurrentGemma-9B (Griffin hybrid: RG-LRU + local attn, 1:2).
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab_size=256000,
    local_window=2048,
    layer_pattern=("rglru", "rglru", "local"),
    rnn_heads=16,  # RG-LRU block-diagonal recurrence gate heads
    lru_width=4096,
    conv_width=4,
    norm="rmsnorm",
    activation="geglu",
    source="arXiv:2402.19427",
)
