"""AdamW, hand-rolled as in the reference.

Port of the reference package's ``optim/adamw.py``. Moments are fp32
regardless of param dtype; the update math runs in fp32 and casts back.
Params, grads and moments are dicts of tensors keyed alike (a params
module's ``named_parameters()``); the update writes the params and the
moments in place and returns them.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

Tensors = Mapping[str, torch.Tensor]


def adamw_init(params: Tensors) -> Dict[str, object]:
    """{"m": fp32 zeros, "v": fp32 zeros, "step": 0-d int32 0}."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = next(iter(params.values())).device
    return {"m": {k: zeros32(p) for k, p in params.items()},
            "v": {k: zeros32(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(
    params: Tensors,
    grads: Tensors,
    opt_state: Dict[str, object],
    lr: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Tuple[Tensors, Dict[str, object]]:
    """One step: global-norm clip at ``grad_clip``, then AdamW with
    weight decay on every leaf. Bias corrections ``1 - b**step`` in fp32."""
    step = opt_state["step"] + 1
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
    m_all, v_all = opt_state["m"], opt_state["v"]
    for k, p in params.items():
        g32 = grads[k].float() * scale
        m = m_all[k].mul_(b1).add_((1 - b1) * g32)
        v = v_all[k].mul_(b2).add_((1 - b2) * g32.square())
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    return params, {"m": m_all, "v": v_all, "step": step}
