"""DBRX-132B  [hf:databricks/dbrx-base; unverified]

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE: 16 routed experts, top-4, fine-grained.

Sharding note: 16 experts over the 16-way `model` axis -> pure
expert parallelism (1 expert per model shard), "expert" mode.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    n_experts_per_tok=4,
    n_shared_experts=0,
    d_expert=10752,
    moe_shard="expert",
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    n_experts=4,
    n_experts_per_tok=2,
    n_shared_experts=0,
    d_expert=128,
    moe_shard="expert",
)
