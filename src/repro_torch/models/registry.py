"""Model API that the serving layer programs against, over all families.

Port of the reference package's ``models/registry.py``, serving half:

  model = build_model(cfg)
  params = model.init(torch.Generator().manual_seed(0), device="cuda")
  cache = model.init_cache(B, S_max, device="cuda")
  logits, cache = model.prefill(params, {"tokens": tokens}, cache)
  logits, cache = model.decode_step(params, cache,
                                    {"tokens": nxt, "cache_index": i})

Tokens are (B, S), or (B, K, S) for audio; a vlm's prefill batch also
holds ``patch_embeds`` (B, n_patches, d). The cache is the KV cache of
a transformer, or the recurrent state (and the shared block's KV cache)
of an xLSTM or Zamba2 stack; it is written in place and returned.
Training (``loss``, ``cross_entropy``) comes with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import stacks, transformer

Batch = Dict[str, Any]


def stack_kind(cfg: ModelConfig) -> str:
    """"transformer", "xlstm" or "zamba2": the stack that runs ``cfg``,
    chosen as the reference chooses it. Raises ``ValueError`` for an
    unknown family."""
    if cfg.family in transformer.FAMILIES:
        return "transformer"
    if cfg.family == "ssm" and cfg.xlstm_pattern:
        return "xlstm"
    if cfg.family in ("ssm", "hybrid"):
        return "zamba2"
    raise ValueError(cfg.family)


@dataclass
class Model:
    cfg: ModelConfig
    prefill_last_only: bool = False

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device: DeviceLike = None) -> nn.Module:
        """Random weights on ``device`` (cuda by default), drawn on the
        generator's device: a CPU generator gives the same weights
        everywhere; a CUDA generator draws on the card."""
        init = {"transformer": transformer.init_params,
                "xlstm": stacks.xlstm_init,
                "zamba2": stacks.zamba2_init}[stack_kind(self.cfg)]
        return init(self.cfg, generator, dtype, resolve_device(device))

    def init_cache(self, batch: int, max_seq: int, dtype=torch.float32,
                   device: DeviceLike = None) -> Any:
        c, dev = self.cfg, resolve_device(device)
        kind = stack_kind(c)
        if kind == "transformer":
            return transformer.init_cache(c, batch, max_seq, dtype, dev)
        if kind == "xlstm":
            return stacks.xlstm_state(c, batch, dtype, dev)
        return stacks.zamba2_state(c, batch, max_seq, dtype, dev)

    def prefill(self, params: nn.Module, batch: Batch, cache: Any
                ) -> Tuple[torch.Tensor, Any]:
        """Full-sequence forward that fills the cache/state; (B, S, V)
        logits ((B, S, K, V) for audio) unless ``prefill_last_only``,
        which only the transformer stack reads, as in the reference."""
        c, tokens = self.cfg, batch["tokens"]
        kind = stack_kind(c)
        if kind == "transformer":
            return transformer.forward(
                c, params, tokens, cache=cache,
                patch_embeds=batch.get("patch_embeds"),
                last_only=self.prefill_last_only)
        if kind == "xlstm":
            return stacks.xlstm_forward(c, params, tokens, state=cache)
        return stacks.zamba2_forward(c, params, tokens, state=cache)

    def decode_step(self, params: nn.Module, cache: Any, batch: Batch
                    ) -> Tuple[torch.Tensor, Any]:
        """One new token, (B, 1) or (B, K, 1), against the cache at
        ``cache_index``."""
        c, tokens = self.cfg, batch["tokens"]
        idx = int(batch["cache_index"])
        kind = stack_kind(c)
        if kind == "transformer":
            return transformer.forward(c, params, tokens, cache=cache,
                                       cache_index=idx)
        if kind == "xlstm":
            return stacks.xlstm_forward(c, params, tokens, state=cache,
                                        decode=True)
        return stacks.zamba2_forward(c, params, tokens, state=cache,
                                     cache_index=idx, decode=True)


def build_model(cfg: ModelConfig, prefill_last_only: bool = False) -> Model:
    return Model(cfg=cfg, prefill_last_only=prefill_last_only)
