"""Decoder-only transformer stack (families: dense, moe, vlm, audio).

Port of the reference package's ``models/transformer.py``. The
reference stacks layer params on a leading n_layers axis and scans over
them; the port keeps one ``Block`` module per layer and loops.

VLM: precomputed patch embeddings (the frontend is a stub) are
prepended to the text embeddings. Audio: K codebook streams are
embedded and summed per frame; the head emits K logit sets.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, moe_apply

Cache = Tuple[torch.Tensor, torch.Tensor]   # each (n_layers, B, S_max, n_kv, hd)

FAMILIES = ("dense", "moe", "vlm", "audio")


# ----------------------------------------------------------------------
class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device) -> None:
        super().__init__()
        self.attn_norm = L.RMSNorm(cfg.d_model, dtype, device)
        self.attn = L.Attention(cfg, dtype, device)
        self.mlp_norm = L.RMSNorm(cfg.d_model, dtype, device)
        if cfg.family == "moe":
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = L.MLP(cfg, dtype, device)


class Transformer(nn.Module):
    """Parameters of a dense, moe, vlm or audio decoder; names follow
    the reference's param dict (``embed``, ``layers``, ``final_norm``,
    ``lm_head``). Audio keeps one embedding table per codebook, (K, V, d),
    and a head of all K logit sets, (d, K*V)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"not a transformer family: {cfg.family!r}")
        V, d = cfg.vocab_padded, cfg.d_model
        audio = cfg.family == "audio"
        self.embed = L._param((cfg.n_codebooks, V, d) if audio else (V, d),
                              dtype, device)
        self.layers = nn.ModuleList(
            Block(cfg, dtype, device) for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(d, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = L._param(
                (d, cfg.n_codebooks * V if audio else V), dtype, device)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Transformer:
    """Random weights drawn on ``generator``'s device: dense and expert
    weights N(0, 1/d_in), embeddings N(0, 0.02^2) (audio's head too),
    norms 1, biases 0. A CPU generator gives the same weights on every
    device."""
    p = Transformer(cfg, dtype, device)
    for blk in p.layers:
        blk.attn.reset_parameters(generator)
        (blk.moe if cfg.family == "moe" else blk.mlp).reset_parameters(
            generator)
    p.embed.copy_(torch.randn(p.embed.shape, generator=generator,
                              device=generator.device) * 0.02)
    if not cfg.tie_embeddings:
        if cfg.family == "audio":
            p.lm_head.copy_(torch.randn(p.lm_head.shape, generator=generator,
                                        device=generator.device) * 0.02)
        else:
            L.dense_init_(p.lm_head, generator)
    return p


# ----------------------------------------------------------------------
def _embed_tokens(p: Transformer, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    if cfg.family == "audio":
        # tokens: (B, K, S) -> sum of per-codebook embeddings
        return sum(p.embed[k][tokens[:, k]] for k in range(cfg.n_codebooks))
    return p.embed[tokens]


def _unembed(p: Transformer, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = p.embed.t() if cfg.tie_embeddings else p.lm_head
    logits = x @ w.to(x.dtype)
    if cfg.family == "audio":
        B, S = x.shape[0], x.shape[1]
        logits = logits.reshape(B, S, cfg.n_codebooks, cfg.vocab_padded)
    if cfg.vocab_padded != cfg.vocab_size:
        # padded slots never win softmax/sampling
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _layer_apply(cfg: ModelConfig, p_l: Block, x: torch.Tensor,
                 positions: torch.Tensor, cache_l: Optional[Cache],
                 cache_index: Optional[int]) -> torch.Tensor:
    h = L.rmsnorm(p_l.attn_norm, x, cfg.norm_eps)
    attn_out, _ = L.attention_apply(
        p_l.attn, cfg, h, positions, cache=cache_l,
        cache_index=cache_index, causal=True)
    x = x + attn_out
    h = L.rmsnorm(p_l.mlp_norm, x, cfg.norm_eps)
    if cfg.family == "moe":
        # serving drops the load-balancing loss; training will add it
        # to forward's return
        out, _ = moe_apply(p_l.moe, cfg, h)
    else:
        out = L.mlp_apply(p_l.mlp, cfg, h)
    return x + out


# ----------------------------------------------------------------------
def forward(
    cfg: ModelConfig,
    p: Transformer,
    tokens: torch.Tensor,
    cache: Optional[Cache] = None,
    cache_index: Optional[int] = None,
    patch_embeds: Optional[torch.Tensor] = None,
    last_only: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Shared trunk. Returns (logits, cache); the cache is written in
    place and returned. A vlm's ``patch_embeds`` (B, n_patches, d) take
    the first positions."""
    x = _embed_tokens(p, cfg, tokens)
    if cfg.family == "vlm" and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    B, S = x.shape[0], x.shape[1]
    if cache_index is not None:
        positions = torch.full((B, 1), cache_index, dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None, :].expand(B, S)
    for i, p_l in enumerate(p.layers):
        cache_l = None if cache is None else (cache[0][i], cache[1][i])
        x = _layer_apply(cfg, p_l, x, positions, cache_l, cache_index)
    if last_only:
        # serving prefill wants next-token logits only: slicing BEFORE
        # the unembed avoids materializing (B, S, V) logits.
        x = x[:, -1:]
    x = L.rmsnorm(p.final_norm, x, cfg.norm_eps)
    return _unembed(p, cfg, x), cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device=None) -> Cache:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
