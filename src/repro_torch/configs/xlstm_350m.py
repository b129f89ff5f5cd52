"""xLSTM-350M  [arXiv:2405.04517; unverified]

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304 — sLSTM + mLSTM blocks.
d_ff = 0: xLSTM blocks carry their own up/down projections
(proj_factor 2 for mLSTM). Pattern follows the paper's mLSTM-dominant
ratio (7 mLSTM : 1 sLSTM).

Attention-free -> `long_500k` decode RUNS (recurrent state, O(1) per
token).
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple("m" if i % 8 != 7 else "s" for i in range(24))

ARCH = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm_pattern=_PATTERN,
    xlstm_proj_factor=2.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    xlstm_pattern=("m", "s"),
    xlstm_proj_factor=2.0,
    tie_embeddings=True,
)
