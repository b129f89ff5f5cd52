"""Shared substrate layers: RMSNorm, RoPE, GQA attention (with
optional qk-norm / QKV bias / KV cache), gated & plain MLPs.

Port of the reference package's ``models/layers.py``.

Conventions
-----------
* Parameters live in ``nn.Module``s whose attribute names are the
  reference's param-dict keys; the layer functions take the module.
  Weights keep the ``x @ W`` (d_in, d_out) orientation.
* Activations: (batch, seq, d_model). Attention uses (B, S, H, hd).
* Softmax and norm statistics are computed in fp32.
* KV caches: (B, S_max, n_kv, hd) per layer. Unlike the reference's
  immutable arrays, the port writes new keys and values into the cache
  in place, so a decode step copies no cache.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (cp_on_shards, gqa_on_shards,
                                              kv_heads, pin_batch, project,
                                              reshape, seq_on_shards,
                                              seq_sharded)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Cache = Tuple[torch.Tensor, torch.Tensor]


def _param(shape, dtype, device, fill: Optional[float] = None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


def dense_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 1/d_in) drawn in fp32 on the generator's own device, then
    copied into ``w``: a CPU generator gives the same weights on every
    device; a CUDA generator draws on the card. ``w`` is (d_in, d_out)
    or a stack (..., d_in, d_out)."""
    d_in = w.shape[-2]
    w.copy_(torch.randn(w.shape, generator=generator,
                        device=generator.device) / math.sqrt(d_in))


# ----------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None) -> None:
        super().__init__()
        self.scale = _param((d,), dtype, device, fill=1.0)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return kref.rms_norm(x, p.scale, eps)


# ----------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        d, dq, dkv = cfg.d_model, cfg.d_q, cfg.d_kv
        self.wq = _param((d, dq), dtype, device)
        self.wk = _param((d, dkv), dtype, device)
        self.wv = _param((d, dkv), dtype, device)
        self.wo = _param((dq, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((dq,), dtype, device, fill=0.0)
            self.bk = _param((dkv,), dtype, device, fill=0.0)
            self.bv = _param((dkv,), dtype, device, fill=0.0)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.d_head, dtype, device)
            self.k_norm = RMSNorm(cfg.d_head, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, kernel: bool,
                 cache: Optional[Cache] = None,
                 cache_index: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, heads, hd): the projections, then their epilogue
    (bias, qk-norm, RoPE) and the write of k and v into ``cache``, in K3
    or its plain chain as ``kops.qkv_rope`` routes them (K3 only with
    ``kernel``). Where the rules shard q's heads and not the kv heads, k
    and v come back with one kv head per device (``sharding.kv_heads``;
    ``sharding.kv_whole`` gives the cache its heads back)."""
    bq, bk, bv = (p.bq, p.bk, p.bv) if cfg.qkv_bias else (None, None, None)
    _, wk, wv, bk, bv = kv_heads(cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                 p.wk, p.wv, bk, bv)
    norms = (p.q_norm.scale, p.k_norm.scale) if cfg.qk_norm else (None, None)
    return kops.qkv_rope(project(x, p.wq), project(x, wk), project(x, wv),
                         positions, cfg.d_head, cfg.rope_theta, bq, bk, bv,
                         *norms, cfg.norm_eps, cache, cache_index, kernel)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  chunk: int = 512, context_parallel: bool = False,
                  q_start: int = 0) -> torch.Tensor:
    """Causal attention as a loop over KV blocks of ``chunk`` keys with
    an online fp32 softmax: the reference's ``_sdpa_chunked``, training's
    route with ``use_flash=True`` (or "cp") at S >= 256. q (B,S,H,hd),
    k/v (B,T,Hkv,hd); q's first row sits at key position ``q_start``.

    ``context_parallel``: shard the Q sequence over the `model` mesh
    axis (K/V whole), the reference's constraint: for archs whose head
    count doesn't divide the TP axis, attention is otherwise replicated
    per device. Identity unless q is a DTensor; on DTensors each device
    runs its q rows against the whole K/V."""
    if context_parallel:
        return cp_on_shards(_sdpa_chunked, q, k, v, chunk)
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    nc = -(-T // chunk)
    pad = nc * chunk - T
    if pad:   # zeros after the last key (a cat: DTensor pads unreliably)
        k = torch.cat([k, k.new_zeros((B, pad) + k.shape[2:])], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad) + v.shape[2:])], dim=1)
    qg = reshape(q, B, S, Hkv, g, hd)
    q_pos = q_start + torch.arange(S, device=q.device)
    m_run = torch.full((B, S, Hkv, g), -1e30, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, S, Hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, Hkv, g, hd), dtype=torch.float32,
                      device=q.device)
    for ci in range(nc):
        k_b = k[:, ci * chunk:(ci + 1) * chunk]
        v_b = v[:, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bskgh,btkh->bskgt", qg, k_b).float() * scale
        k_pos = ci * chunk + torch.arange(chunk, device=q.device)
        causal = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~causal[None, :, None, None, :], -1e30)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bskgt,btkh->bskgh", p.to(v_b.dtype), v_b).float()
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30)[..., None]
    return reshape(out.to(q.dtype), B, S, H, hd)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Reference attention: q (B,S,H,hd), k/v (B,T,Hkv,hd), GQA via
    head-group reshape. fp32 softmax; masked scores are -1e30."""
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    q = reshape(q, B, S, Hkv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return reshape(out, B, S, H, hd)


def _sdpa_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_sdpa`` over one slice of the keys, before its softmax is
    normalised: (the scores' max m (B, Hkv, g, S), the sum of exp(s - m)
    l (B, Hkv, g, S), the unnormalised p·v o (B, S, Hkv, g, hd)), all
    fp32; ``valid`` (T,) masks the slice's keys. ``seq_on_shards``
    combines the slices' parts."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k).float() / math.sqrt(hd)
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return m, p.sum(dim=-1), o


def attention_apply(
    p: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Cache] = None,
    cache_index: Optional[int] = None,
    causal: bool = True,
    use_flash: Any = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Full-sequence (train/prefill) or single-step (decode) attention.

    cache: (k_cache, v_cache) each (B, S_max, n_kv, hd), written in
    place. In decode, ``x`` is (B, 1, d) and ``cache_index`` the write
    position. ``use_flash`` picks the full-sequence causal route: None
    (serving) runs the flash-attention kernel on CUDA tensors (its plain
    version on CPU tensors) at every S; False and True are the
    reference's training routes, the masked ``_sdpa``, or with True
    ``_sdpa_chunked`` at S >= 256 ("cp": context parallel). With None,
    K3 also takes the q/k/v epilogue and the cache write where
    ``kops.qkv_rope`` routes them to it. The kernels have no backward, so
    training never takes them. While a profiler is active it records the
    detail spans ``attn.qkv`` (the cache write included) and
    ``attn.core`` (``repro_torch.obs``).
    """
    B, S, _ = x.shape
    decode = cache is not None and cache_index is not None and S == 1
    with obs.detail("attn.qkv"):
        q, k, v = _project_qkv(p, cfg, x, positions, use_flash is None,
                               cache, cache_index if decode else None)
    new_cache = None if cache is None else tuple(cache)
    if decode:
        k_cache, v_cache = cache
        T = k_cache.shape[1]
        with obs.detail("attn.core"):
            # low-precision KV caches are upcast at read; scores/softmax
            # math stays in the compute dtype
            kc, vc = k_cache.to(q.dtype), v_cache.to(q.dtype)
            if seq_sharded(k_cache):  # a batch-1 cache sharded on its sequence
                out = seq_on_shards(_sdpa_parts, q, kc, vc, cache_index)
            else:
                valid = torch.arange(T, device=x.device) <= cache_index
                out = gqa_on_shards(_sdpa, q, kc, vc, valid)
    else:
        with obs.detail("attn.core"):
            if causal and use_flash is None:
                out = kops.flash_attention(q, k, v, causal=True)
            elif causal and use_flash == "cp" and S >= 256:
                out = _sdpa_chunked(q, k, v, context_parallel=True)
            elif causal and use_flash and S >= 256:
                out = gqa_on_shards(_sdpa_chunked, q, k, v)
            elif causal:
                mask = torch.ones((S, S), dtype=torch.bool,
                                  device=x.device).tril()[None, None, None]
                out = gqa_on_shards(_sdpa, q, k, v, mask)
            else:
                out = gqa_on_shards(_sdpa, q, k, v, None)
    out = project(reshape(out, B, S, cfg.d_q), p.wo, out_like=x)
    return out, new_cache


# ----------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None,
                 d_ff: Optional[int] = None) -> None:
        super().__init__()
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        if cfg.mlp_gated:
            self.w_gate = _param((d, ff), dtype, device)
        self.w_up = _param((d, ff), dtype, device)
        self.w_down = _param((ff, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in self.parameters():
            dense_init_(w, generator)


def mlp_apply(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # a residual stream sharded on d (``pin_residual``) is gathered for
    # the column-parallel weights, as GSPMD gathers it
    x = pin_batch(x)
    if cfg.mlp_gated:
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = F.gelu(x @ p.w_up, approximate="tanh")
    return h @ p.w_down
