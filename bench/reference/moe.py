"""Reference of the moe family (Qwen1.5-MoE / Qwen2-MoE decoders as the
port defines them): the dense family's attention, then a routed
mixture of SwiGLU experts plus an ungated shared SwiGLU expert.

Routing follows the configuration file: a float32 softmax over the
router's logits, the top ``num_experts_per_tok`` experts of each token,
and the capacity dispatch of ``moe_dispatch``. The top-k gates are
renormalised to sum 1 whatever ``norm_topk_prob`` says: that is the
port's fixed gating, which the configuration lists under ``assumed``
(the published Qwen1.5-MoE has ``norm_topk_prob`` false).

Over the prompt's positions the rows of one routing group are ranked
together, token by token and choice by choice: an assignment whose
rank within its expert reaches the capacity C is dropped. The positions after the prompt were decode
steps of a few tokens a group, which drop nothing.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from bench.reference import common
from bench.reference.common import Block, Spec


def param_specs(cfg: dict) -> List[Spec]:
    d, E = cfg["hidden_size"], cfg["num_experts"]
    de, ds = cfg["moe_intermediate_size"], cfg["shared_expert_intermediate_size"]

    def ffn(p: str) -> List[Spec]:
        return [(f"{p}.moe.router", (d, E), ("normal", d ** -0.5)),
                (f"{p}.moe.w_gate", (E, d, de), ("normal", d ** -0.5)),
                (f"{p}.moe.w_up", (E, d, de), ("normal", d ** -0.5)),
                (f"{p}.moe.w_down", (E, de, d), ("normal", de ** -0.5)),
                ] + common.swiglu_specs(f"{p}.moe.shared", d, ds)

    return common.model_specs(cfg, ffn)


def group_rows(cfg: dict, batch_rows: int) -> int:
    """Rows a routing group of the program's batch holds: the batch over
    the largest power of two <= max_groups that divides it."""
    g = 1
    while (g * 2 <= min(cfg["moe_dispatch"]["max_groups"], batch_rows)
           and batch_rows % (g * 2) == 0):
        g *= 2
    return batch_rows // g


def capacity(cfg: dict, tokens: int) -> int:
    """Slots per (group, expert) for a group of ``tokens`` tokens."""
    disp, k = cfg["moe_dispatch"], cfg["num_experts_per_tok"]
    if tokens <= disp["dropless_group_tokens"]:
        c = tokens * k
    else:
        c = math.ceil(tokens * k / cfg["num_experts"]
                      * disp["capacity_factor"])
    m = disp["slot_multiple"]
    return max(m, -(-c // m) * m)


def route(cfg: dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
          block: Block, precision: str):
    """(gates (R, T, k), experts (R, T, k), kept (R, T, k) bool)."""
    R, T, _ = h.shape
    k, E = cfg["num_experts_per_tok"], cfg["num_experts"]
    probs = torch.softmax(common.linear(h, lw["moe.router"], precision), -1)
    gates, experts = probs.topk(k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)      # the port's gating
    kept = torch.ones_like(experts, dtype=torch.bool)
    S, gr = block.prompt, block.group_rows
    if R % gr:
        raise ValueError(f"{R} rows do not fill groups of {gr}")
    n = gr * S
    C = capacity(cfg, n)
    if C < n * k:
        flat = experts[:, :S].reshape(R // gr, n * k)      # (G, A)
        onehot = F.one_hot(flat, E)                         # (G, A, E)
        rank = (onehot.cumsum(1) - 1).gather(2, flat[..., None])[..., 0]
        kept[:, :S] = (rank < C).reshape(R, S, k)
    return gates, experts, kept


def _moe(cfg: dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
         block: Block, precision: str) -> torch.Tensor:
    R, T, d = h.shape
    gates, experts, kept = route(cfg, lw, h, block, precision)
    x = h.reshape(R * T, d)
    y = common.swiglu(x, lw["moe.shared.w_gate"], lw["moe.shared.w_up"],
                      lw["moe.shared.w_down"], precision)
    tok = torch.arange(R * T, device=h.device)[:, None].expand(
        R * T, experts.shape[-1])
    experts, gates, kept = (t.reshape(R * T, -1) for t in (experts, gates,
                                                          kept))
    for e in range(cfg["num_experts"]):
        sel = (experts == e) & kept
        if not bool(sel.any()):
            continue
        rows = tok[sel]
        out = common.swiglu(x[rows], lw["moe.w_gate"][e], lw["moe.w_up"][e],
                            lw["moe.w_down"][e], precision)
        y.index_add_(0, rows, out * gates[sel][:, None])
    return y.reshape(R, T, d)


def logits(cfg: dict, W: Dict[str, torch.Tensor], blocks: List[Block],
           precision: str = "fp32") -> List[torch.Tensor]:
    return common.forward_logits(cfg, W, blocks, _moe, precision)
