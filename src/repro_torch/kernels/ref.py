"""Plain PyTorch versions of the port's kernels: what each kernel is
held against, and what its wrapper runs for a tensor on the CPU.

Mirrors the reference package's ``kernels/ref.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


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
