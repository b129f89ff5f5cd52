"""Architecture registry over the configs ported so far."""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs import qwen2_0_5b, qwen2_moe_a2_7b
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen2-0.5b": qwen2_0_5b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
}

ARCHS: Dict[str, ModelConfig] = {k: m.ARCH for k, m in _MODULES.items()}
SMOKES: Dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}
ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_arch(arch_id: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(table)}")
    return table[arch_id]


__all__ = ["ARCHS", "SMOKES", "ARCH_IDS", "ModelConfig", "get_arch"]
