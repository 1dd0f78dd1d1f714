"""Whisper-small (enc-dec transformer backbone; conv frontend is a stub —
input_specs() provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,  # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=51865,
    enc_dec=True,
    n_enc_layers=12,
    enc_seq=1500,
    norm="layernorm",
    activation="gelu",
    pos_embedding="sinusoidal",
    frontend="audio",
    tie_embeddings=False,
    source="arXiv:2212.04356",
)
