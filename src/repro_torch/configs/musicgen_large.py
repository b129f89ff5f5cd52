"""MusicGen-large  [arXiv:2306.05284; hf]

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048 — decoder-only
transformer over EnCodec tokens: 4 parallel codebook streams
(delay-pattern interleaving), per-codebook vocab 2048, GELU MLP
(not gated) per the original architecture.

The EnCodec frontend is a STUB per the brief: ``input_specs()``
provides the 4-stream codebook token ids; the backbone sums the four
codebook embeddings per frame and emits 4 logit heads.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_gated=False,
    frontend="encodec_stub",
    n_codebooks=4,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    mlp_gated=False,
    frontend="encodec_stub",
    n_codebooks=4,
)
