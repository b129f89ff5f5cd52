"""Model API that the serving layer programs against.

Port of the reference package's ``models/registry.py``, serving half:

  model = build_model(cfg)
  params = model.init(torch.Generator().manual_seed(0), device="cuda")
  cache = model.init_cache(B, S_max, device="cuda")
  logits, cache = model.prefill(params, {"tokens": tokens}, cache)
  logits, cache = model.decode_step(params, cache,
                                    {"tokens": nxt, "cache_index": i})

Training (``loss``, ``cross_entropy``) comes with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

Batch = Dict[str, Any]


@dataclass
class Model:
    cfg: ModelConfig
    prefill_last_only: bool = False

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device: DeviceLike = None) -> transformer.Transformer:
        """Random weights on ``device`` (cuda by default), drawn on the
        generator's device: a CPU generator gives the same weights
        everywhere; a CUDA generator draws on the card."""
        return transformer.init_params(self.cfg, generator, dtype,
                                       resolve_device(device))

    def init_cache(self, batch: int, max_seq: int, dtype=torch.float32,
                   device: DeviceLike = None) -> transformer.Cache:
        return transformer.init_cache(self.cfg, batch, max_seq, dtype,
                                      resolve_device(device))

    def prefill(self, params: transformer.Transformer, batch: Batch,
                cache: transformer.Cache
                ) -> Tuple[torch.Tensor, transformer.Cache]:
        """Full-sequence forward that fills the cache; (B, S, V) logits
        unless ``prefill_last_only``."""
        return transformer.forward(self.cfg, params, batch["tokens"],
                                   cache=cache,
                                   last_only=self.prefill_last_only)

    def decode_step(self, params: transformer.Transformer,
                    cache: transformer.Cache, batch: Batch
                    ) -> Tuple[torch.Tensor, transformer.Cache]:
        """One new token (B, 1) against the cache at ``cache_index``."""
        return transformer.forward(self.cfg, params, batch["tokens"],
                                   cache=cache,
                                   cache_index=int(batch["cache_index"]))


def build_model(cfg: ModelConfig, prefill_last_only: bool = False) -> Model:
    transformer.require_ported(cfg)
    return Model(cfg=cfg, prefill_last_only=prefill_last_only)
