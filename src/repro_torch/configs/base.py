"""The port's own copy of ``ModelConfig``: the architecture schema
that configs, models and serving share.

Copied from the reference package's ``configs/base.py`` so that the
port imports nothing of ``repro``; ``tests/test_torch_layers.py``
holds the two copies field for field against each other, and
``tests/test_torch_sharding.py`` the dry run's shape cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. Field groups are family-specific; unused
    groups stay at their zero defaults."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # ---- attention flags ----
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False
    mlp_gated: bool = True  # SwiGLU (3 mats) vs GELU MLP (2 mats)

    # ---- MoE ----
    n_experts: int = 0           # routed experts
    n_experts_per_tok: int = 0   # top-k
    n_shared_experts: int = 0
    d_expert: int = 0            # per routed expert ffn dim (fine-grained)

    # ---- SSM (Mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # ---- xLSTM ----
    # layer kinds used when family == "ssm" and xlstm_pattern non-empty:
    # "m" -> mLSTM block, "s" -> sLSTM block
    xlstm_pattern: Tuple[str, ...] = ()
    xlstm_proj_factor: float = 2.0

    # ---- hybrid (zamba2-style): shared attention block applied every
    #      `hybrid_attn_every` mamba layers with one shared param set ----
    hybrid_attn_every: int = 0

    # ---- modality frontends (STUBS: precomputed embeddings) ----
    frontend: str = ""           # "" | "vit_stub" | "encodec_stub"
    n_patches: int = 0           # vlm: patches prepended to the text seq
    n_codebooks: int = 0         # audio: parallel codebook streams

    norm_eps: float = 1e-6
    max_seq: int = 1 << 20

    # pad embedding/lm_head vocab up to a multiple of 256 so the vocab
    # dim TP-shards (minicpm 122753 / internvl 151655 are otherwise
    # replicated — the collective-bound dry-run cells). Padded logit
    # slots are masked to -inf in unembed. Perf-iteration knob.
    pad_vocab: bool = False

    # ---- sharding hints (consumed by repro.distributed.sharding) ----
    # how to shard MoE experts over the "model" axis:
    #   "expert"  -> shard expert dim (requires n_experts % model == 0)
    #   "ffn"     -> replicate experts, shard their ffn dim
    moe_shard: str = "ffn"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        if not self.pad_vocab:
            return self.vocab_size
        return -(-self.vocab_size // 256) * 256

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM / hybrid archs only (per brief)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and the
        NPU cost model; cross-checked against real init in tests)."""
        d, L = self.d_model, self.n_layers
        n_embed = self.vocab_padded * d
        if self.family == "audio":
            n_embed = self.n_codebooks * self.vocab_padded * d
        # per-layer counts by family
        per_layer = 0
        attn = d * self.d_q + 2 * d * self.d_kv + self.d_q * d
        if self.qkv_bias:
            attn += self.d_q + 2 * self.d_kv
        if self.qk_norm:
            attn += 2 * self.d_head
        n_mlp_mats = 3 if self.mlp_gated else 2
        dense_mlp = n_mlp_mats * d * self.d_ff  # SwiGLU gate/up/down | GELU up/down
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn + dense_mlp + 2 * d
        elif self.family == "moe":
            d_e = self.d_expert or self.d_ff
            routed = self.n_experts * 3 * d * d_e
            shared = self.n_shared_experts * 3 * d * d_e
            router = d * self.n_experts
            per_layer = attn + routed + shared + router + 2 * d
        elif self.family == "ssm" and self.xlstm_pattern:
            total_layers = sum(
                _xlstm_layer_params(self, k) for k in self.xlstm_pattern)
            per_layer = total_layers // L if L else 0
            # avoid integer-division drift: compute exactly below
            n_embed_ = n_embed
            total = n_embed_ + total_layers + d
            if not self.tie_embeddings:
                total += self.vocab_padded * d
            return total
        elif self.family == "ssm":
            per_layer = _mamba2_layer_params(self) + d
        elif self.family == "hybrid":
            per_layer = _mamba2_layer_params(self) + d
        total = n_embed + L * per_layer + d  # final norm
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += attn + dense_mlp + 2 * d  # one shared block
        if not self.tie_embeddings:
            lm_head = self.vocab_padded * d
            if self.family == "audio":
                lm_head = self.n_codebooks * self.vocab_padded * d
            total += lm_head
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top-k routed)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        d_e = self.d_expert or self.d_ff
        inactive = L * (self.n_experts - self.n_experts_per_tok) * 3 * d * d_e
        return self.param_count() - inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _mamba2_layer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    nh = cfg.ssm_heads or max(d_inner // max(cfg.ssm_head_dim, 1), 1)
    # separate projections: w_z, w_x, w_B, w_C, w_dt
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_state + nh
    return (
        d * d_in_proj
        + (cfg.ssm_conv + 1) * (d_inner + 2 * cfg.ssm_state)  # conv w + b
        + nh  # A_log
        + nh  # D
        + nh  # dt_bias
        + d_inner  # gated norm
        + d_inner * d  # out_proj
    )


def _xlstm_layer_params(cfg: ModelConfig, kind: str) -> int:
    d = cfg.d_model
    up = int(cfg.xlstm_proj_factor * d)
    H = cfg.n_heads
    hd = up // H
    if kind == "m":
        # norm, w_u, w_z, wq, wk, wv, w_if, out_norm, w_down
        return (d + 2 * d * up + 3 * up * up + up * 2 * H + up
                + up * d)
    # sLSTM: norm, w_up, w_gates, r_gates, out_norm, w_down
    return d + d * up + up * 4 * up + H * hd * 4 * hd + up + up * d


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell from the assignment."""

    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeCell("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeCell("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeCell("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeCell("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Whether a shape cell runs for an arch, per the brief."""
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
