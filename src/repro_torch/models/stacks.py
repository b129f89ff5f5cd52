"""Non-transformer stacks: xLSTM (ssm family) and Zamba2 (hybrid).

Port of the reference package's ``models/stacks.py``. The reference
stacks the block params on leading axes and scans over them; the port
keeps one module per block and loops, and writes each block's new state
into the stacked state buffers in place (as the transformer writes its
KV cache), so a decode step copies no state.

xLSTM: the layer pattern ``([m]*k_m + [s]*k_s) * reps``; the port's
``blocks`` follow the pattern's order, block i being segment i // (k_m +
k_s). The state keeps the reference's (reps, inner, ...) stacks.

Zamba2: Mamba2 layers, with the SHARED attention+MLP block (one param
set) applied after every ``hybrid_attn_every``-th layer; each
application has its own KV cache, (n_attn, B, S_max, n_kv, hd) stacked.
Its prefill attention runs the flash-attention kernel (through
``layers.attention_apply``), its decode the masked attention over the
cache.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm

State = Dict[str, Dict[str, torch.Tensor]]


# ======================================================================
# xLSTM
# ======================================================================
def parse_xlstm_pattern(cfg: ModelConfig) -> Tuple[int, int, int]:
    pat = list(cfg.xlstm_pattern)
    if not pat or pat[0] != "m":
        raise ValueError("pattern must start with mLSTM blocks")
    k_m = pat.index("s") if "s" in pat else len(pat)
    k_s = 0
    for c in pat[k_m:]:
        if c != "s":
            break
        k_s += 1
    seg = ["m"] * k_m + ["s"] * k_s
    reps, rem = divmod(len(pat), len(seg))
    if rem or pat != seg * reps:
        raise ValueError(f"irregular xLSTM pattern {pat}")
    return k_m, k_s, reps


def xlstm_slots(cfg: ModelConfig) -> List[Tuple[str, int, int]]:
    """(kind, rep, inner) of each block in pattern order: where its
    params and state sit in the reference's ``mlstm``/``slstm`` stacks."""
    k_m, k_s, reps = parse_xlstm_pattern(cfg)
    return [("mlstm", r, j) if j < k_m else ("slstm", r, j - k_m)
            for r in range(reps) for j in range(k_m + k_s)]


class XLSTM(nn.Module):
    """``embed``, ``blocks`` (an ``MLSTM`` or ``SLSTM`` per pattern
    entry), ``final_norm`` and, untied, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        self.slots = xlstm_slots(cfg)
        self.embed = L._param((cfg.vocab_size, cfg.d_model), dtype, device)
        self.blocks = nn.ModuleList(
            (ssm.MLSTM if kind == "mlstm" else ssm.SLSTM)(cfg, dtype, device)
            for kind, _, _ in self.slots)
        self.final_norm = L.RMSNorm(cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = L._param((cfg.d_model, cfg.vocab_size), dtype,
                                    device)


def xlstm_init(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32, device=None) -> XLSTM:
    """Random weights drawn on ``generator``'s device: embeddings
    N(0, 0.02^2), the blocks as ``ssm``'s inits draw them."""
    p = XLSTM(cfg, dtype, device)
    for blk in p.blocks:
        blk.reset_parameters(generator)
    p.embed.copy_(torch.randn(p.embed.shape, generator=generator,
                              device=generator.device) * 0.02)
    if not cfg.tie_embeddings:
        L.dense_init_(p.lm_head, generator)
    return p


def xlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                device=None) -> State:
    k_m, k_s, reps = parse_xlstm_pattern(cfg)

    def rep_stack(state_fn, inner):
        one = state_fn(cfg, batch, dtype, device)
        return {k: v.expand((reps, inner) + v.shape).clone()
                for k, v in one.items()}

    st: State = {"mlstm": rep_stack(ssm.mlstm_state, k_m)}
    if k_s:
        st["slstm"] = rep_stack(ssm.slstm_state, k_s)
    return st


def _step_in_place(apply, p_l, cfg, x, state, kind, idx, decode):
    """Run one block on its slice of the stacked state and write the new
    state back into it."""
    st = {k: v[idx] for k, v in state[kind].items()}
    x, new = apply(p_l, cfg, x, st, decode)
    for k, v in new.items():
        state[kind][k][idx].copy_(v)
    return x


def xlstm_forward(
    cfg: ModelConfig, p: XLSTM, tokens: torch.Tensor,
    state: Optional[State] = None, decode: bool = False,
) -> Tuple[torch.Tensor, Optional[State]]:
    """Returns (logits, state); the state is updated in place."""
    x = p.embed[tokens]
    for (kind, r, j), blk in zip(p.slots, p.blocks):
        apply = ssm.mlstm_apply if kind == "mlstm" else ssm.slstm_apply
        if state is None:
            x, _ = apply(blk, cfg, x, None, False)
        else:
            x = _step_in_place(apply, blk, cfg, x, state, kind, (r, j),
                               decode)
    x = L.rmsnorm(p.final_norm, x, cfg.norm_eps)
    w = p.embed.t() if cfg.tie_embeddings else p.lm_head
    return x @ w.to(x.dtype), state


# ======================================================================
# Zamba2 (hybrid)
# ======================================================================
class Zamba2(nn.Module):
    """``embed``, ``mamba`` (one ``Mamba2`` per layer), the shared block
    (``shared_attn_norm``, ``shared_attn``, ``shared_mlp_norm``,
    ``shared_mlp``), ``final_norm`` and ``lm_head``."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        d = cfg.d_model
        self.embed = L._param((cfg.vocab_size, d), dtype, device)
        self.mamba = nn.ModuleList(
            ssm.Mamba2(cfg, dtype, device) for _ in range(cfg.n_layers))
        self.shared_attn_norm = L.RMSNorm(d, dtype, device)
        self.shared_attn = L.Attention(cfg, dtype, device)
        self.shared_mlp_norm = L.RMSNorm(d, dtype, device)
        self.shared_mlp = L.MLP(cfg, dtype, device)
        self.final_norm = L.RMSNorm(d, dtype, device)
        self.lm_head = L._param((d, cfg.vocab_size), dtype, device)


def zamba2_init(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Zamba2:
    """Random weights drawn on ``generator``'s device: embeddings
    N(0, 0.02^2), dense weights N(0, 1/d_in), as the reference's init."""
    p = Zamba2(cfg, dtype, device)
    for blk in p.mamba:
        blk.reset_parameters(generator)
    p.embed.copy_(torch.randn(p.embed.shape, generator=generator,
                              device=generator.device) * 0.02)
    p.shared_attn.reset_parameters(generator)
    p.shared_mlp.reset_parameters(generator)
    L.dense_init_(p.lm_head, generator)
    return p


def n_attn_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // max(cfg.hybrid_attn_every, 1)


def zamba2_state(cfg: ModelConfig, batch: int, max_seq: int,
                 dtype=torch.float32, device=None) -> State:
    one = ssm.mamba2_state(cfg, batch, dtype, device)
    kv = (n_attn_applications(cfg), batch, max_seq, cfg.n_kv_heads,
          cfg.d_head)
    return {
        "mamba": {k: v.expand((cfg.n_layers,) + v.shape).clone()
                  for k, v in one.items()},
        "kv_k": torch.zeros(kv, dtype=dtype, device=device),
        "kv_v": torch.zeros(kv, dtype=dtype, device=device),
    }


def _shared_block(cfg: ModelConfig, p: Zamba2, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[L.Cache],
                  cache_index: Optional[int]) -> torch.Tensor:
    h = L.rmsnorm(p.shared_attn_norm, x, cfg.norm_eps)
    attn_out, _ = L.attention_apply(p.shared_attn, cfg, h, positions,
                                    cache=cache, cache_index=cache_index,
                                    causal=True)
    x = x + attn_out
    h = L.rmsnorm(p.shared_mlp_norm, x, cfg.norm_eps)
    return x + L.mlp_apply(p.shared_mlp, cfg, h)


def zamba2_forward(
    cfg: ModelConfig, p: Zamba2, tokens: torch.Tensor,
    state: Optional[State] = None, cache_index: Optional[int] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[State]]:
    """Returns (logits, state); the state (Mamba2 states and the shared
    block's KV caches) is updated in place."""
    every = cfg.hybrid_attn_every
    x = p.embed[tokens]
    B, S = x.shape[0], x.shape[1]
    if cache_index is not None and decode:
        positions = torch.full((B, 1), cache_index, dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None, :].expand(B, S)
    for i, blk in enumerate(p.mamba):
        if state is None:
            x, _ = ssm.mamba2_apply(blk, cfg, x)
        else:
            x = _step_in_place(ssm.mamba2_apply, blk, cfg, x, state,
                               "mamba", i, decode)
        if every and (i + 1) % every == 0:
            a = (i + 1) // every - 1
            cache = None if state is None else (state["kv_k"][a],
                                                state["kv_v"][a])
            x = _shared_block(cfg, p, x, positions, cache, cache_index)
    x = L.rmsnorm(p.final_norm, x, cfg.norm_eps)
    return x @ p.lm_head.to(x.dtype), state
