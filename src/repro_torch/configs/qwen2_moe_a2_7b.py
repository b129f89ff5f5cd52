"""Qwen1.5-MoE-A2.7B  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936,
MoE: 4 shared + 60 routed experts, top-4. Fine-grained experts
(d_expert = 1408). QKV bias per Qwen1.5 lineage. The MoE config that
one H100 holds whole (14.3 B parameters, 57.3 GB in fp32).
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    n_experts=60,
    n_experts_per_tok=4,
    n_shared_experts=4,
    d_expert=1408,
    moe_shard="ffn",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    qkv_bias=True,
    n_experts=6,
    n_experts_per_tok=2,
    n_shared_experts=2,
    d_expert=96,
    moe_shard="ffn",
)
