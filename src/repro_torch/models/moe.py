"""Mixture-of-Experts layer: top-k routing with GShard-style capacity
dispatch, the expert FFN as three grouped GEMMs.

Port of the reference package's ``models/moe.py``. Dispatch scatters
tokens into capacity slots, C per (group, expert) (dropped tokens fall
through on the residual); the experts run over the occupied slots as
``kernels.ops.grouped_matmul`` calls, which launch the Hopper kernel
(``kernels/csrc/grouped_matmul.cu``) on CUDA tensors and the plain
version on CPU tensors. Combine = gather + gate-weighted sum over the k
slots of each token, plus the shared experts.

Layout: the reference's dispatch buffer is group-major, (G, E, C, d).
The port's is expert-major, (E, G*C, d), so each expert GEMM is one
kernel call on a contiguous (E, G*C, .) tensor with no permute copy.
Each expert's kept assignments are packed as a prefix of its G*C rows:
with n[g, e] the kept assignments of group g to expert e and off[g, e]
their exclusive cumulative sum over g, an assignment of rank r takes
slot ``e*G*C + off[g, e] + r``, and rows[e] = sum_g n[g, e] rows of
expert e are occupied. The GEMMs take ``rows``, so the kernel reads
only the occupied rows and only the weights of experts that hold one.
Over the same kept assignments each output row is the dot product of
the reference's ``gecd,edf->gecf``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import maybe_constrain, mesh_axes
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


def router_probs(router: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """fp32 softmax over the experts of the router logits of ``xg``
    (G, Tg, d): (G, Tg, E), as ``moe_apply`` routes them."""
    return torch.softmax((xg @ router).float(), dim=-1)


def topk_gap(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> float:
    """Smallest gap, over the tokens of x (B, S, d), between the k-th and
    (k+1)-th router probability as ``moe_apply`` routes them. A gap near
    0 is a top-k choice that rounding can flip."""
    k = cfg.n_experts_per_tok
    top = router_probs(p.router, _grouped(x)).topk(k + 1, dim=-1).values
    return float((top[..., k - 1] - top[..., k]).min())


def _dispatch(router: torch.Tensor, cfg: ModelConfig, xg: torch.Tensor,
              C: int):
    """Route the groups ``xg`` (G, Tg, d) and scatter them into the
    expert-major slot buffer. Returns (h (E, G*C, d), slot, keep,
    gate_vals, probs, expert_idx, rows)."""
    G, Tg, d = xg.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    probs = router_probs(router, xg)                         # (G, Tg, E)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)     # (G, Tg, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # --- dispatch: rank of each assignment within (group, expert) ---
    # A stable sort keeps token order within an expert, so the rank (and
    # with it which assignments drop) is the reference's.
    A = Tg * k
    flat_e = expert_idx.reshape(G, A)                        # (G, A)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks_sorted = torch.arange(A, device=xg.device) - first
    ranks = torch.empty_like(ranks_sorted).scatter_(1, order, ranks_sorted)
    keep = ranks < C
    GC = G * C
    # Pack each expert's kept rows as a prefix: counts by scatter-add,
    # so nothing here waits on the device.
    n_ge = torch.zeros(G, E, dtype=torch.int64, device=xg.device).scatter_add_(
        1, flat_e, keep.long())                              # (G, E)
    off = torch.cumsum(n_ge, dim=0) - n_ge
    rows = n_ge.sum(dim=0).to(torch.int32)                   # (E,)
    slot = torch.where(keep, flat_e * GC + off.gather(1, flat_e) + ranks,
                       E * GC)

    # Expert-major slot buffer; its last row takes every dropped
    # assignment and is never read.
    buf = xg.new_zeros(E * GC + 1, d)
    buf.index_copy_(0, slot.reshape(-1),
                    xg.repeat_interleave(k, dim=1).reshape(G * A, d))
    h = buf[:E * GC].view(E, GC, d)
    return h, slot, keep, gate_vals, probs, expert_idx, rows


def _balance(probs: torch.Tensor, expert_idx: torch.Tensor, E: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-style load balancing's two means over the tokens: the
    first choice's density and the router probability, each (E,)."""
    first_choice = expert_idx[..., 0].reshape(-1)
    density = torch.zeros(E, dtype=torch.float32,
                          device=probs.device).index_add_(
        0, first_choice, torch.ones_like(first_choice, dtype=torch.float32)
    ) / first_choice.numel()
    return density, probs.mean(dim=(0, 1))


def _combine(y_e: torch.Tensor, slot, keep, gate_vals, x_dtype
             ) -> torch.Tensor:
    """Gather + gate-weighted sum over the k slots: (G, Tg, d)."""
    E, GC, d = y_e.shape
    G, Tg, k = gate_vals.shape
    y_tok = y_e.reshape(E * GC, d).index_select(
        0, slot.clamp(max=E * GC - 1).reshape(-1))
    y_tok = torch.where(keep.reshape(-1, 1), y_tok, 0).reshape(G, Tg, k, d)
    gates = gate_vals.to(x_dtype)[..., None]                 # (G, Tg, k, 1)
    return (y_tok * gates).sum(dim=2)


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float = 1.25, einsum: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). x: (B, S, d).

    The expert GEMMs run through K2's entry point (serving), or with
    ``einsum`` as the reference's batched einsums over every slot
    (training's route: the kernel has no backward).

    GShard-style grouped dispatch: each assignment is ranked within its
    (group, expert) against a per-group capacity C; a rank >= C drops
    the assignment. The reference pins the dispatch buffer's group axis
    to the data-parallel mesh axes (``maybe_constrain``, identity on a
    plain tensor); here the slot axis (G*C) carries the groups.

    A DTensor ``x`` (sharded params) takes ``_moe_apply_sharded``: the
    routing runs on each device's own groups, the experts as einsums on
    DTensors.

    Inside a ``generate`` call the plain route counts its routed
    assignments, kept rows and slots into the call's record
    (``repro_torch.obs``); the detail spans ``moe.route``,
    ``moe.experts``, ``moe.combine`` and ``moe.shared`` are recorded
    while a profiler is active.
    """
    B, S, d = x.shape
    E = cfg.n_experts
    G = _n_groups(B)
    if isinstance(x, DTensor):
        return _moe_apply_sharded(p, cfg, x, G, capacity_factor)
    xg = x.reshape(G, B * S // G, d)
    C = capacity(cfg, xg.shape[1], capacity_factor)
    with obs.detail("moe.route"):
        h, slot, keep, gate_vals, probs, expert_idx, rows = _dispatch(
            p.router, cfg, xg, C)
        call = obs.RECORDER.open_call
        if call is not None:
            call.count_moe(rows, B * S * cfg.n_experts_per_tok, E * G * C)
        density, mean_prob = _balance(probs, expert_idx, E)
        aux_loss = E * torch.sum(density * mean_prob)
        h = maybe_constrain(h, None, ("pod", "data"), None)

    # --- grouped expert GEMMs (kernel K2 on CUDA, or einsums) ---
    with obs.detail("moe.experts"):
        if einsum:
            y_e = _experts_einsum(p, h)
        else:
            g_ = F.silu(kops.grouped_matmul(h, p.w_gate, rows))
            u = kops.grouped_matmul(h, p.w_up, rows)
            y_e = kops.grouped_matmul(g_ * u, p.w_down, rows)  # (E, GC, d)
        y_e = maybe_constrain(y_e, None, ("pod", "data"), None)

    with obs.detail("moe.combine"):
        y = _combine(y_e, slot, keep, gate_vals, x.dtype).reshape(B, S, d)
    if p.shared is not None:
        with obs.detail("moe.shared"):
            y = y + L.mlp_apply(p.shared, cfg.replace(mlp_gated=True), x)
    return y, aux_loss


def _experts_einsum(p: MoE, h: torch.Tensor) -> torch.Tensor:
    g_ = F.silu(torch.einsum("ecd,edf->ecf", h, p.w_gate))
    u = torch.einsum("ecd,edf->ecf", h, p.w_up)
    return torch.einsum("ecf,efd->ecd", g_ * u, p.w_down)


def _moe_apply_sharded(p: MoE, cfg: ModelConfig, x: DTensor, G: int,
                       capacity_factor: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` on a DTensor x: the routing groups align with the
    batch shards over the data-parallel mesh dims (G is a power of two
    that divides B, as is every such shard count that divides B), so
    each device routes its own G / D groups, with the global C, as plain
    tensors, exactly as the unsharded layer routes them. The slot
    buffers become DTensors sharded on their slot axis over the same
    dims (the reference's first ``maybe_constrain``), the experts run as
    einsums on the sharded weights, and their outputs are gathered back
    to those shards (the second). Gradients of what each device used
    locally are partial sums over the data-parallel dims. The load
    balancing loss averages its two means over the shards before their
    product, as over the whole batch. Where the batch or the groups do
    not divide, x is replicated and every device routes all G groups."""
    B, S, d = x.shape
    E = cfg.n_experts
    mesh = x.device_mesh
    names = mesh_axes(mesh)
    dp = [i for i, axes in enumerate(names) if {"pod", "data"} & set(axes)]
    D = math.prod(mesh.size(i) for i in dp)
    if D == 1 or B % D or G % D:
        dp, D = [], 1

    def on_dp(local: Placement):
        return [local if i in dp else Replicate() for i in range(len(names))]

    partial_dp = on_dp(Partial())
    x_l = x.redistribute(mesh, on_dp(Shard(0))).to_local(
        grad_placements=on_dp(Shard(0)))
    router = p.router.redistribute(mesh, on_dp(Replicate())).to_local(
        grad_placements=partial_dp)
    Gl = G // D
    xg = x_l.reshape(Gl, B * S // G, d)
    C = capacity(cfg, xg.shape[1], capacity_factor)
    h, slot, keep, gate_vals, probs, expert_idx, _ = _dispatch(
        router, cfg, xg, C)
    # each shard's mean over D shards: a sum of local means / D (a
    # Partial("avg") would hand every shard the whole gradient)
    density, mean_prob = (
        DTensor.from_local(t / D, mesh, on_dp(Partial())).redistribute(
            mesh, on_dp(Replicate()))
        for t in _balance(probs, expert_idx, E))
    aux_loss = E * torch.sum(density * mean_prob)

    h = DTensor.from_local(h, mesh, on_dp(Shard(1)))
    h = maybe_constrain(h, None, ("pod", "data"), None)
    y_e = maybe_constrain(_experts_einsum(p, h), None, ("pod", "data"), None)
    y = _combine(y_e.to_local(), slot, keep, gate_vals, x.dtype)
    y = DTensor.from_local(y.reshape(B // D, S, d), mesh, on_dp(Shard(0)))
    if p.shared is not None:
        y = y + L.mlp_apply(p.shared, cfg.replace(mlp_gated=True), x)
    return y, aux_loss
