"""The work a served batch needs, counted from its shapes, and the
least time one H100 could take for it: the yardstick of the roofline
shares and of ``mfu``.

Counted is what the inputs need, not what the port happens to compute:

- linear layers: 2 operations per multiply-add per token; the routed
  experts of a moe layer at top-k per token, not over capacity slots;
- attention: the causal (query, key) pairs, 4 * hd operations each
  (q k^T and p v);
- the unembed only where logits are used: one position per row of a
  prefill (the next token) and of each decode step;
- weights read once per forward; of the routed experts only those that
  hold a token (``active_experts``); of the embedding only the rows
  gathered; the unembedding whole;
- the KV cache at 2 bytes per element, whatever dtype the program keeps
  it in, over its valid positions: read once in a decode step, written
  once in a prefill;
- a batch of n_new new tokens needs its prefill and n_new - 1 decode
  steps (the last token comes from the last step's logits).

Copied from the port's ``chip_smoke.py`` (``attention_bound``,
``gmm_rows_bound``, ``engine_bounds``) and corrected as above:
``engine_bounds`` counts every capacity slot, the whole ``max_seq``
cache at 4 bytes and the unembed of every prompt position, and
``gmm_rows_bound`` writes every slot's output row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Tuple

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense): bf16 on the tensor cores, fp32 on the CUDA cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}
KV_BYTES = 2   # the cache's bytes per element, as counted


@dataclass(frozen=True)
class Sizes:
    """A decoder's sizes, from a configuration file's published keys."""
    n_layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int            # dense MLP width (0 in a moe model)
    vocab: int
    experts: int        # routed experts (0 in a dense model)
    top_k: int
    expert_ffn: int
    shared_ffn: int
    qkv_bias: bool
    qk_norm: bool
    dtype: str

    @property
    def moe(self) -> bool:
        return self.experts > 0

    @property
    def elt(self) -> int:
        return ELEMENT_BYTES[self.dtype]

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.dtype]


def sizes(cfg: dict) -> Sizes:
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    moe = "num_experts" in cfg
    return Sizes(
        n_layers=cfg["num_hidden_layers"], d=d, heads=heads,
        kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or d // heads,
        ffn=0 if moe else cfg["intermediate_size"],
        vocab=cfg["vocab_size"],
        experts=cfg.get("num_experts", 0),
        top_k=cfg.get("num_experts_per_tok", 0),
        expert_ffn=cfg.get("moe_intermediate_size", 0),
        shared_ffn=cfg.get("shared_expert_intermediate_size", 0),
        qkv_bias=cfg["attention_bias"], qk_norm=cfg["qk_norm"],
        dtype=cfg["torch_dtype"])


def least_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least seconds one H100 takes for ``flops`` and ``nbytes``."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S)


def causal_pairs(t: int, past: int) -> int:
    """(query, key) pairs of t new queries after ``past`` cached keys,
    each query seeing the keys up to and including its own."""
    return t * past + t * (t + 1) // 2


def attention_work(b: int, sq: int, sk: int, h: int, hkv: int, hd: int,
                   elt: int) -> Tuple[float, float]:
    """K1, causal with bottom-right alignment: (operations, bytes); q, k
    and v read once and o written once."""
    pairs = causal_pairs(sq, sk - sq)
    return (4.0 * b * h * hd * pairs,
            float(elt * (2 * b * sq * h * hd + 2 * b * sk * hkv * hd)))


def gmm_rows_work(rows: Iterable[int], d: int, f: int,
                  elt: int) -> Tuple[float, float]:
    """K2 with ``rows`` occupied rows per expert: (operations, bytes);
    the weights of the experts that hold a row, the occupied rows of x
    read once and of the output written once."""
    rows = [int(r) for r in rows]
    total, active = sum(rows), sum(1 for r in rows if r > 0)
    return (2.0 * total * d * f,
            float(elt * (active * d * f + total * d + total * f)))


def active_experts(s: Sizes, tokens: int) -> float:
    """Experts that hold a token when ``tokens`` tokens each pick top-k
    of E, expected under uniform routing: E (1 - (1 - k/E)^tokens)."""
    return s.experts * (1.0 - (1.0 - s.top_k / s.experts) ** tokens)


def forward_work(s: Sizes, b: int, t: int, past: int) -> Tuple[float, float]:
    """One forward of b rows, t new tokens each after ``past`` cached
    positions, logits at one position a row: (operations, bytes)."""
    d, hd = s.d, s.head_dim
    dq, dkv = s.heads * hd, s.kv_heads * hd
    n = b * t
    attn_w = 2 * d * dq + 2 * d * dkv
    small = 2 * d + (dq + 2 * dkv if s.qkv_bias else 0) \
        + (2 * hd if s.qk_norm else 0)
    if s.moe:
        expert = 3 * d * s.expert_ffn
        ffn_ops = d * s.experts + 3 * d * s.shared_ffn + s.top_k * expert
        ffn_w = d * s.experts + 3 * d * s.shared_ffn \
            + active_experts(s, n) * expert
    else:
        ffn_ops = ffn_w = 3 * d * s.ffn
    flops = s.n_layers * (2.0 * n * (attn_w + ffn_ops)
                          + 4.0 * b * s.heads * hd * causal_pairs(t, past)) \
        + 2.0 * b * d * s.vocab
    weights = s.n_layers * (attn_w + small + ffn_w) + d + d * s.vocab
    nbytes = (s.elt * (weights + n * d)
              + KV_BYTES * 2 * s.n_layers * b * (past + t) * dkv)
    return flops, float(nbytes)


def batch_forwards(s: Sizes, b: int, prompt: int,
                   n_new: int) -> List[Tuple[float, float]]:
    """(operations, bytes) of each forward that a batch of b prompts of
    ``prompt`` tokens and n_new greedy tokens needs: the prefill and
    n_new - 1 decode steps."""
    return [forward_work(s, b, prompt, 0)] + [
        forward_work(s, b, 1, prompt + i) for i in range(n_new - 1)]


def batch_least_s(s: Sizes, b: int, prompt: int, n_new: int) -> float:
    """The least seconds a batch needs: each forward at the larger of
    its operations at the peak and its bytes at HBM rate."""
    return sum(least_s(f, m, s.peak_flops)
               for f, m in batch_forwards(s, b, prompt, n_new))
