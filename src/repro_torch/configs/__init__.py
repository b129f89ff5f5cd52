"""Architecture registry: the same ten ids as the reference package's."""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs import (
    dbrx_132b,
    internvl2_1b,
    minicpm_2b,
    musicgen_large,
    qwen2_0_5b,
    qwen2_72b,
    qwen2_moe_a2_7b,
    qwen3_14b,
    xlstm_350m,
    zamba2_7b,
)
from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ModelConfig,
    ShapeCell,
    shape_applicable,
)

_MODULES = {
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "dbrx-132b": dbrx_132b,
    "xlstm-350m": xlstm_350m,
    "qwen3-14b": qwen3_14b,
    "minicpm-2b": minicpm_2b,
    "qwen2-0.5b": qwen2_0_5b,
    "qwen2-72b": qwen2_72b,
    "internvl2-1b": internvl2_1b,
    "zamba2-7b": zamba2_7b,
    "musicgen-large": musicgen_large,
}

ARCHS: Dict[str, ModelConfig] = {k: m.ARCH for k, m in _MODULES.items()}
SMOKES: Dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}
ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_arch(arch_id: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(table)}")
    return table[arch_id]


def dryrun_cells():
    """Yield every live (arch, shape) dry-run cell plus skip records."""
    for arch_id, cfg in ARCHS.items():
        for cell in ALL_SHAPES:
            ok, why = shape_applicable(cfg, cell)
            yield arch_id, cfg, cell, ok, why


__all__ = [
    "ARCHS",
    "SMOKES",
    "ARCH_IDS",
    "ModelConfig",
    "ShapeCell",
    "ALL_SHAPES",
    "SHAPES_BY_NAME",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "get_arch",
    "dryrun_cells",
    "shape_applicable",
]
