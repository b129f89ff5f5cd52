"""MiniCPM-2B  [arXiv:2404.06395; hf]

40L d_model=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753 —
llama-like arch; trained with the WSD (warmup-stable-decay) schedule,
implemented in repro.optim.schedule and used by the training example.
Tied embeddings per MiniCPM.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    tie_embeddings=True,
)
