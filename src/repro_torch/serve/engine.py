"""Serving engine: batched prefill + greedy/temperature decode over
the KV cache or recurrent state, for every family of the zoo.

Port of the reference package's ``serve/engine.py``. Runs on ``cuda``
unless ``device="cpu"`` is passed.

One difference from ``repro.serve.engine``, on purpose: a vlm's prefill
fills ``n_patches + S`` positions (the patch embeddings come first), so
decode step i writes position ``n_patches + S + i`` and ``max_seq`` must
hold ``n_patches + S + n_new``. The reference engine decodes at
``S + i``, which overwrites prefilled keys and gives the new token the
wrong RoPE position; its own model test decodes at ``S + n_patches``,
as this engine does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import Model, build_model


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, n_new) | (B, K, n_new)
    prefill_s: float
    decode_s: float
    tokens_per_s: float


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Optional[nn.Module] = None,
                 max_seq: int = 512, seed: int = 0, dtype=torch.float32,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: Model = build_model(cfg)
        self.max_seq = max_seq
        if params is None:
            params = self.model.init(torch.Generator().manual_seed(seed),
                                     dtype, self.device)
        self.params = params

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _sample(logits: torch.Tensor, generator: torch.Generator,
                temperature: float) -> torch.Tensor:
        # logits: (B, 1, V) | (B, 1, K, V). Temperature sampling is the
        # Gumbel-max draw that jax.random.categorical makes, from a torch
        # generator.
        if temperature <= 0:
            return logits.argmax(dim=-1)
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        return (logits / temperature - torch.log(-torch.log(u))).argmax(dim=-1)

    @torch.inference_mode()
    def generate(self, prompt_tokens: np.ndarray, n_new: int,
                 temperature: float = 0.0, seed: int = 0
                 ) -> GenerationResult:
        cfg = self.cfg
        toks = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.long,
                               device=self.device)
        audio = cfg.family == "audio"
        B, S = toks.shape[0], toks.shape[-1]
        n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
        if n_prefix + S + n_new > self.max_seq:
            raise ValueError(f"prefix {n_prefix} + prompt {S} + n_new {n_new} "
                             f"exceeds max_seq {self.max_seq}; increase "
                             f"max_seq")
        cache = self.model.init_cache(B, self.max_seq, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)

        self._sync()
        t0 = time.perf_counter()
        batch: Dict[str, Any] = {"tokens": toks}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (B, cfg.n_patches, cfg.d_model), device=self.device)
        logits, cache = self.model.prefill(self.params, batch, cache)
        self._sync()
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        outs = []
        last = logits[:, -1:]
        for i in range(n_new):
            nxt = self._sample(last, generator, temperature)  # (B,1)|(B,1,K)
            if audio:
                nxt = nxt.movedim(-1, 1)                        # (B,K,1)
            outs.append(nxt)
            last, cache = self.model.decode_step(
                self.params, cache,
                {"tokens": nxt, "cache_index": n_prefix + S + i})
        new = torch.cat(outs, dim=-1).to(torch.int32).cpu().numpy()
        self._sync()
        t_decode = time.perf_counter() - t0
        # tokens/s counts generated timesteps per sequence: an audio
        # model's K codebook tokens of one step are one timestep
        n_tok = new.shape[0] * new.shape[-1]
        return GenerationResult(
            tokens=new,
            prefill_s=t_prefill,
            decode_s=t_decode,
            tokens_per_s=n_tok / max(t_decode, 1e-9),
        )
