"""Reference of the dense family (Qwen2 / Qwen3 decoders): attention
with optional q, k, v biases and qk-norm, then a SwiGLU MLP, each
after an RMSNorm and added to the residual stream."""
from __future__ import annotations

from typing import Dict, List

import torch

from bench.reference import common
from bench.reference.common import Block, Spec


def param_specs(cfg: dict) -> List[Spec]:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return common.model_specs(
        cfg, lambda p: common.swiglu_specs(f"{p}.mlp", d, f))


def group_rows(cfg: dict, batch_rows: int) -> int:
    """Rows whose outputs depend on each other in the program's batch:
    none in a dense model."""
    return 1


def _mlp(cfg: dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
         block: Block, precision: str) -> torch.Tensor:
    return common.swiglu(h, lw["mlp.w_gate"], lw["mlp.w_up"],
                         lw["mlp.w_down"], precision)


def logits(cfg: dict, W: Dict[str, torch.Tensor], blocks: List[Block],
           precision: str = "fp32") -> List[torch.Tensor]:
    return common.forward_logits(cfg, W, blocks, _mlp, precision)
