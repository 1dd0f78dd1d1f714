"""SmolLM-135M (llama-arch small). [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_head=64,
    d_ff=1536,
    vocab_size=49152,
    norm="rmsnorm",
    activation="swiglu",
    source="hf:HuggingFaceTB/SmolLM-135M",
)
