"""Gradient compression for slow cross-pod links: int8 quantization
with error feedback (1-bit-Adam-style residual correction).

Port of the reference package's ``distributed/compress.py``. Per-tensor
symmetric int8 cuts the traffic of an all-reduce 4x (vs fp32); the
quantization error is carried in a residual and re-added next step,
which keeps convergence. Rounding is half to even, as ``jnp.round``.
Trees are (nested) dicts of tensors.

Usage inside a step:
    q, scale, new_resid = quantize_ef(g, resid)
    # all-reduce q (int8 on the wire) and the scales, then
    g = dequantize(q_sum, scale_sum)
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Tuple

import torch


def quantize_ef(g: torch.Tensor, resid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 with error feedback.
    Returns (q_int8, scale, new_resid)."""
    g32 = g.float() + resid
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_resid = g32 - q.float() * scale
    return q, scale, new_resid


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def compress_tree(grads, resids):
    """Tree-wise quantize; returns (q_tree, scale_tree, resid_tree)."""
    out = _map(quantize_ef, grads, resids)
    return tuple(_map(lambda t: t[i], out) for i in range(3))


def decompress_tree(q_tree, scale_tree):
    return _map(dequantize, q_tree, scale_tree)


def init_residuals(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
