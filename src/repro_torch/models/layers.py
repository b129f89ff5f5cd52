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
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

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
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p.scale.to(x.dtype)


# ----------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,). Split-half (not
    interleaved) rotation with fp32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  chunk: int = 512) -> torch.Tensor:
    """Causal attention as a loop over KV blocks of ``chunk`` keys with
    an online fp32 softmax: the reference's ``_sdpa_chunked``, training's
    route with ``use_flash=True`` at S >= 256. q (B,S,H,hd), k/v
    (B,S,Hkv,hd)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, S, Hkv, g, hd)
    q_pos = torch.arange(S, device=q.device)
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
    return out.to(q.dtype).reshape(B, S, H, hd)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Reference attention: q (B,S,H,hd), k/v (B,T,Hkv,hd), GQA via
    head-group reshape. fp32 softmax; masked scores are -1e30."""
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    q = q.reshape(B, S, Hkv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H, hd)


def attention_apply(
    p: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Cache] = None,
    cache_index: Optional[int] = None,
    causal: bool = True,
    use_flash: Optional[bool] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Full-sequence (train/prefill) or single-step (decode) attention.

    cache: (k_cache, v_cache) each (B, S_max, n_kv, hd), written in
    place. In decode, ``x`` is (B, 1, d) and ``cache_index`` the write
    position. ``use_flash`` picks the full-sequence causal route: None
    (serving) runs the flash-attention kernel on CUDA tensors (its plain
    version on CPU tensors) at every S; False and True are the
    reference's training routes, the masked ``_sdpa``, or with True
    ``_sdpa_chunked`` at S >= 256. The kernel has no backward, so
    training never takes it.
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    new_cache = None
    if cache is not None and cache_index is not None and S == 1:
        k_cache, v_cache = cache
        k_cache[:, cache_index:cache_index + 1] = k.to(k_cache.dtype)
        v_cache[:, cache_index:cache_index + 1] = v.to(v_cache.dtype)
        new_cache = (k_cache, v_cache)
        T = k_cache.shape[1]
        valid = torch.arange(T, device=x.device) <= cache_index
        # low-precision KV caches are upcast at read; scores/softmax
        # math stays in the compute dtype
        out = _sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), valid)
    else:
        if causal and use_flash is None:
            out = kops.flash_attention(q, k, v, causal=True)
        elif causal and use_flash and S >= 256:
            out = _sdpa_chunked(q, k, v)
        elif causal:
            mask = torch.ones((S, S), dtype=torch.bool,
                              device=x.device).tril()[None, None, None]
            out = _sdpa(q, k, v, mask)
        else:
            out = _sdpa(q, k, v, None)
        if cache is not None:
            k_cache, v_cache = cache
            k_cache[:, :S] = k.to(k_cache.dtype)
            v_cache[:, :S] = v.to(v_cache.dtype)
            new_cache = (k_cache, v_cache)
    out = out.reshape(B, S, cfg.d_q) @ p.wo
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
    if cfg.mlp_gated:
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = F.gelu(x @ p.w_up, approximate="tanh")
    return h @ p.w_down
