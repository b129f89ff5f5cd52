"""Plain PyTorch versions of the port's kernels: what each kernel is
held against, and what its wrapper runs for a tensor on the CPU.

Mirrors the reference package's ``kernels/ref.py``. The q/k/v epilogue
(``qkv_rope_ref``, with the model's RMSNorm and RoPE) is also the
model's own chain wherever K3 does not run: training and sharded serving,
on DTensors. One chain for both keeps what K3 is held to the chain the
model runs, so it takes DTensors through the sharding helpers
(``reshape``, ``reduced_like``, ``kv_whole``, ``write_at``), which are
the plain ops on plain tensors.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.distributed.sharding import (kv_whole, reduced_like,
                                              reshape, write_at)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, hd); k/v: (BH, Sk, hd) — kv already head-matched.
    fp32 softmax, output in q.dtype. The causal diagonal is aligned
    bottom-right: key c is visible to query r iff c <= r + Sk - Sq."""
    sq, hd = q.shape[1], q.shape[2]
    sk = k.shape[1]
    scores = torch.einsum("bqh,bkh->bqk", q, k).float()
    scores = scores / math.sqrt(hd)
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkh->bqh", w.to(v.dtype), v)


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd). Returns (B, Sq, H, hd);
    query head h reads KV head h // (H // Hkv)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s, hd)
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, -1, hd)
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, -1, hd)
    o = attention_ref(qf, kf, vf, causal)
    return o.reshape(b, h, s, hd).transpose(1, 2)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (E, C, d); w: (E, d, f) -> (E, C, f). fp32 accumulation,
    output in x.dtype. With ``rows`` (E,), output rows r >= rows[e] of
    expert e are 0 (rows[e] clamped to [0, C])."""
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    if rows is not None:
        live = torch.arange(x.shape[1], device=x.device) < rows[:, None]
        out = torch.where(live[..., None], out, 0.0)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim: fp32 statistics, the factor and each
    product rounded to x's dtype."""
    var = reduced_like(x.float().square().mean(dim=-1, keepdim=True), x)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * scale.to(x.dtype)


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


def qkv_rope_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor, hd: int, theta: float,
                 bq: Optional[torch.Tensor] = None,
                 bk: Optional[torch.Tensor] = None,
                 bv: Optional[torch.Tensor] = None,
                 q_norm: Optional[torch.Tensor] = None,
                 k_norm: Optional[torch.Tensor] = None, eps: float = 1e-6,
                 cache: Optional[Sequence[torch.Tensor]] = None,
                 cache_index: Optional[int] = None):
    """Attention's q/k/v epilogue, K3's plain version. q (B, S, H*hd), k
    and v (B, S, Hkv*hd), the projections: the biases added, q and k
    normed per head by the qk-norm scales ``q_norm`` and ``k_norm``
    (hd,), then rotated (split-half RoPE at ``positions``, (B, S) or
    (S,)). Returns q (B, S, H, hd), k and v (B, S, Hkv, hd) in q's dtype;
    with a ``cache``, k and v are also written into it, in its dtype: at
    ``cache_index`` where S is 1, else rows 0 .. S - 1."""
    B, S = q.shape[0], q.shape[1]
    if bq is not None:
        q = q + bq.to(q.dtype)
        k = k + bk.to(q.dtype)
        v = v + bv.to(q.dtype)
    q = reshape(q, B, S, q.shape[-1] // hd, hd)
    k = reshape(k, B, S, k.shape[-1] // hd, hd)
    v = reshape(v, B, S, v.shape[-1] // hd, hd)
    if q_norm is not None:
        q = rms_norm(q, q_norm, eps)
        k = rms_norm(k, k_norm, eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    # the cache write: kv heads repeated over devices come back whole
    # first (``kv_whole``), a sequence-sharded cache is written where its
    # row lies (``write_at``)
    for c, t in zip(cache or (), (k, v)):
        t = kv_whole(t, c.shape[2]).to(c.dtype)
        if cache_index is None or S != 1:
            c[:, :S] = t
        else:
            write_at(c, cache_index, t)
    return q, k, v
