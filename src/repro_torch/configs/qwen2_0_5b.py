"""Qwen2-0.5B  [arXiv:2407.10671; hf]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 — GQA, QKV bias,
tied embeddings. The model the port's serving path runs at full width.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    tie_embeddings=True,
)
