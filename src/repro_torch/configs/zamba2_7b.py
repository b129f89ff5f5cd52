"""Zamba2-7B  [arXiv:2411.15242; unverified]

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64 —
Mamba2 backbone + a SHARED attention+MLP block (one parameter set)
applied every `hybrid_attn_every` Mamba2 layers.

Hybrid -> `long_500k` decode RUNS: Mamba2 state is O(1) per token;
the shared-attention KV cache is sequence-sharded over the `data`
mesh axis.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=112,       # (expand*d_model)/head_dim = 7168/64
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    hybrid_attn_every=6,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_heads=8,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=32,
    hybrid_attn_every=2,
)
