"""InternVL2-1B  [arXiv:2404.16821; hf]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 —
InternViT frontend + Qwen2-0.5B-lineage LM backbone.

Per the brief the modality frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings (B, n_patches, d_model) which
the backbone prepends to the text token embeddings.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    tie_embeddings=True,
    frontend="vit_stub",
    n_patches=256,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    tie_embeddings=True,
    frontend="vit_stub",
    n_patches=8,
)
