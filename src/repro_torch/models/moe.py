"""Mixture-of-Experts layer: top-k routing with GShard-style capacity
dispatch, the expert FFN as three grouped GEMMs.

Port of the reference package's ``models/moe.py``. Dispatch scatters
tokens into per-(expert, group) capacity slots (dropped tokens fall
through on the residual); the experts run densely over every slot as
``kernels.ops.grouped_matmul`` calls, which launch the Hopper kernel
(``kernels/csrc/grouped_matmul.cu``) on CUDA tensors and the plain
version on CPU tensors. Combine = gather + gate-weighted sum over the k
slots of each token, plus the shared experts.

Layout: the reference's dispatch buffer is group-major, (G, E, C, d).
The port's is expert-major, (E, G*C, d), with token slot
``e*G*C + g*C + rank``, so each expert GEMM is one kernel call on a
contiguous (E, G*C, .) tensor with no permute copy. Over the same slots
it computes the reference's ``gecd,edf->gecf``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


class MoE(nn.Module):
    """Router (d, E), routed experts ``w_gate``/``w_up`` (E, d, d_e) and
    ``w_down`` (E, d_e, d), and the shared experts as one gated MLP of
    width ``n_shared_experts * d_e``: the reference's param names."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        d, d_e, E = cfg.d_model, cfg.d_expert or cfg.d_ff, cfg.n_experts
        self.router = L._param((d, E), dtype, device)
        self.w_gate = L._param((E, d, d_e), dtype, device)
        self.w_up = L._param((E, d, d_e), dtype, device)
        self.w_down = L._param((E, d_e, d), dtype, device)
        self.shared: Optional[L.MLP] = None
        if cfg.n_shared_experts:
            self.shared = L.MLP(cfg.replace(mlp_gated=True), dtype, device,
                                d_ff=cfg.n_shared_experts * d_e)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1/d_in) for the router and every expert, as ``moe_init``."""
        for w in (self.router, self.w_gate, self.w_up, self.w_down):
            L.dense_init_(w, generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)


def capacity(cfg: ModelConfig, n_tokens: int, factor: float = 1.25) -> int:
    if n_tokens <= 128:
        # dropless for tiny groups (decode steps, smoke tests): the
        # worst-case buffer is E x (n_tokens*k) x d — negligible — and
        # decode/prefill logits stay bit-consistent (no token drops).
        c = n_tokens * cfg.n_experts_per_tok
        return max(8, -(-c // 8) * 8)
    c = math.ceil(n_tokens * cfg.n_experts_per_tok / cfg.n_experts * factor)
    return max(8, -(-c // 8) * 8)  # pad to 8 for tiling friendliness


def _n_groups(B: int, cap: int = 64) -> int:
    """Largest power of two <= cap that divides the batch — groups
    align with (and subdivide) the data-parallel batch shards."""
    g = 1
    while g * 2 <= min(cap, B) and B % (g * 2) == 0:
        g *= 2
    return g


def _grouped(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) as ``moe_apply``'s routing groups: (G, B*S/G, d)."""
    B, S, d = x.shape
    G = _n_groups(B)
    return x.reshape(G, B * S // G, d)


def router_probs(p: MoE, xg: torch.Tensor) -> torch.Tensor:
    """fp32 softmax over the experts of the router logits of ``xg``
    (G, Tg, d): (G, Tg, E)."""
    return torch.softmax((xg @ p.router).float(), dim=-1)


def topk_gap(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> float:
    """Smallest gap, over the tokens of x (B, S, d), between the k-th and
    (k+1)-th router probability as ``moe_apply`` routes them. A gap near
    0 is a top-k choice that rounding can flip."""
    k = cfg.n_experts_per_tok
    top = router_probs(p, _grouped(x)).topk(k + 1, dim=-1).values
    return float((top[..., k - 1] - top[..., k]).min())


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). x: (B, S, d).

    GShard-style grouped dispatch: each assignment is ranked within its
    (group, expert) against a per-group capacity C; a rank >= C drops
    the assignment. The reference pins the dispatch buffers' group axis
    to the data-parallel mesh axes (``maybe_constrain``); one card has
    no mesh, so the port has no counterpart of that call.
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    xg = _grouped(x)
    G, Tg = xg.shape[:2]
    C = capacity(cfg, Tg, capacity_factor)

    probs = router_probs(p, xg)                              # (G, Tg, E)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)     # (G, Tg, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Switch-style load-balancing loss; density from the first choice.
    first_choice = expert_idx[..., 0].reshape(-1)
    density = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, first_choice, torch.ones_like(first_choice, dtype=torch.float32)
    ) / (G * Tg)
    aux_loss = E * torch.sum(density * probs.mean(dim=(0, 1)))

    # --- dispatch: rank of each assignment within (group, expert) ---
    # A stable sort keeps token order within an expert, so the rank (and
    # with it which assignments drop) is the reference's.
    A = Tg * k
    flat_e = expert_idx.reshape(G, A)                        # (G, A)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks_sorted = torch.arange(A, device=x.device) - first
    ranks = torch.empty_like(ranks_sorted).scatter_(1, order, ranks_sorted)
    keep = ranks < C
    GC = G * C
    group = torch.arange(G, device=x.device)[:, None]
    slot = torch.where(keep, flat_e * GC + group * C + ranks, E * GC)

    # Expert-major slot buffer; its last row takes every dropped
    # assignment and is never read.
    buf = x.new_zeros(E * GC + 1, d)
    buf.index_copy_(0, slot.reshape(-1),
                    xg.repeat_interleave(k, dim=1).reshape(G * A, d))
    h = buf[:E * GC].view(E, GC, d)

    # --- grouped expert GEMMs (kernel K2 on CUDA) ---
    g_ = F.silu(kops.grouped_matmul(h, p.w_gate))
    u = kops.grouped_matmul(h, p.w_up)
    y_e = kops.grouped_matmul(g_ * u, p.w_down)              # (E, GC, d)

    # --- combine: gather + gate-weighted sum over the k slots ---
    y_tok = y_e.reshape(E * GC, d).index_select(
        0, slot.clamp(max=E * GC - 1).reshape(-1))
    y_tok = torch.where(keep.reshape(-1, 1), y_tok, 0).reshape(G, Tg, k, d)
    gates = gate_vals.to(x.dtype)[..., None]                 # (G, Tg, k, 1)
    y = (y_tok * gates).sum(dim=2).reshape(B, S, d)

    if p.shared is not None:
        y = y + L.mlp_apply(p.shared, cfg.replace(mlp_gated=True), x)
    return y, aux_loss
