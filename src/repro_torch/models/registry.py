"""Model API that the launch, train and serve layers program against,
over all families.

Port of the reference package's ``models/registry.py``:

  model = build_model(cfg)
  params = model.init(torch.Generator().manual_seed(0), device="cuda")
  loss, metrics = model.loss(params, batch)              # training
  cache = model.init_cache(B, S_max, device="cuda")
  logits, cache = model.prefill(params, {"tokens": tokens}, cache)
  logits, cache = model.decode_step(params, cache,
                                    {"tokens": nxt, "cache_index": i})

Tokens are (B, S), or (B, K, S) for audio; a training batch also holds
``targets`` of the same shape, and a vlm's batch ``patch_embeds``
(B, n_patches, d). The cache is the KV cache of a transformer, or the
recurrent state (and the shared block's KV cache) of an xLSTM or Zamba2
stack; it is written in place and returned.

Routes: serving runs causal attention through kernel K1 and the MoE
experts through K2 whatever ``use_flash`` is. Training (``logits``,
``loss``) takes the reference's routes, which the kernels do not carry
(they have no backward): ``use_flash=False`` the masked attention,
``True`` the chunked one at S >= 256, ``"cp"`` the chunked one with q
constrained to sequence shards over the `model` mesh axis (context
parallel; identity off a mesh), and the experts as einsums. A model
built with ``serve_kernels=False`` serves on the same routes (the dry
run's, whose meta tensors no kernel may be handed).

Sharded params (DTensors, placed by ``distributed.sharding``) run the
same code: the forward then runs under ``implicit_replication()``, so
the plain tensors it makes (positions, masks, RoPE tables, scan states)
join DTensor ops as replicated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (pick_vocab, pin_batch,
                                              pin_vocab, replicate_plain)
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


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits promoted to fp32. On a DTensor
    the log-sum-exp is spelled out, so a vocab-sharded row reduces its
    max and its sum across devices (``torch.logsumexp`` would gather
    the vocab first)."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        m = pin_batch(logits.detach().amax(dim=-1, keepdim=True))
        lse = pin_batch((logits - m).exp().sum(dim=-1)).log() + m[..., 0]
        tgt = pin_batch(pick_vocab(logits, targets))
    else:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


@dataclass
class Model:
    """One model of the zoo: ``init`` draws its params; ``logits`` and
    ``loss`` are the training forward; ``init_cache``, ``prefill`` and
    ``decode_step`` serve; ``batch_shapes`` gives each step's inputs.

    ``use_flash`` (False, True or "cp") and ``remat`` apply to
    training's ``logits``/``loss``; "pallas" (a kernel with no backward)
    is refused there. ``serve_kernels=False`` makes ``prefill`` and
    ``decode_step`` take the training routes (with ``use_flash``)
    instead of the kernels."""
    cfg: ModelConfig
    use_flash: Any = False
    remat: bool = True
    prefill_last_only: bool = False
    serve_kernels: bool = True

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device: DeviceLike = None) -> nn.Module:
        """Random weights on ``device`` (cuda by default), drawn on the
        generator's device: a CPU generator gives the same weights
        everywhere; a CUDA generator draws on the card."""
        init = {"transformer": transformer.init_params,
                "xlstm": stacks.xlstm_init,
                "zamba2": stacks.zamba2_init}[stack_kind(self.cfg)]
        return init(self.cfg, generator, dtype, resolve_device(device))

    # ---------------- training ----------------
    def logits(self, params: nn.Module, batch: Batch
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward on the training routes: (logits,
        aux_loss)."""
        c, tokens = self.cfg, batch["tokens"]
        flash = self._train_route()
        kind = stack_kind(c)
        with replicate_plain(params):
            if kind == "transformer":
                lg, _, aux = transformer.forward(
                    c, params, tokens, patch_embeds=batch.get("patch_embeds"),
                    remat=self.remat, use_flash=flash)
            elif kind == "xlstm":
                lg, _, aux = stacks.xlstm_forward(c, params, tokens,
                                                  remat=self.remat)
            else:
                lg, _, aux = stacks.zamba2_forward(c, params, tokens,
                                                   remat=self.remat,
                                                   use_flash=flash)
        return lg, aux

    def _train_route(self) -> Any:
        if self.use_flash not in (False, True, "cp"):
            raise ValueError(
                f"use_flash={self.use_flash!r} has no training route in the "
                "port: 'pallas' needs a backward kernel")
        return self.use_flash

    def loss(self, params: nn.Module, batch: Batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """ce + 0.01 * aux, and {"ce", "aux"}. A vlm is scored on its
        text positions; audio targets (B, K, S) are moved to (B, S, K)."""
        c = self.cfg
        lg, aux = self.logits(params, batch)
        targets = batch["targets"]
        if c.family == "vlm":
            lg = lg[:, c.n_patches:]
        if c.family == "audio":
            targets = targets.movedim(1, 2)
        lg = pin_vocab(lg)
        with replicate_plain(params):
            ce = cross_entropy(lg, targets)
            return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ---------------- serving ----------------
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
        which only the transformer stack reads, as in the reference.
        Sharded logits come back in ``pin_vocab``'s layout, reduced where
        the unembedding is sharded on d (a jitted step cannot return a
        pending sum, so the reference all-reduces them there)."""
        c, tokens = self.cfg, batch["tokens"]
        kind = stack_kind(c)
        route = self._serve_route()
        with replicate_plain(params):
            if kind == "transformer":
                lg, cache, _ = transformer.forward(
                    c, params, tokens, cache=cache,
                    patch_embeds=batch.get("patch_embeds"),
                    last_only=self.prefill_last_only, use_flash=route)
            elif kind == "xlstm":
                lg, cache, _ = stacks.xlstm_forward(c, params, tokens,
                                                    state=cache)
            else:
                lg, cache, _ = stacks.zamba2_forward(c, params, tokens,
                                                     state=cache,
                                                     use_flash=route)
        return pin_vocab(lg), cache

    def _serve_route(self) -> Any:
        """None (the kernels), or the training route."""
        return None if self.serve_kernels else self._train_route()

    def decode_step(self, params: nn.Module, cache: Any, batch: Batch
                    ) -> Tuple[torch.Tensor, Any]:
        """One new token, (B, 1) or (B, K, 1), against the cache at
        ``cache_index``; logits in ``prefill``'s layout."""
        c, tokens = self.cfg, batch["tokens"]
        idx = int(batch["cache_index"])
        kind = stack_kind(c)
        route = self._serve_route()
        with replicate_plain(params):
            if kind == "transformer":
                lg, cache, _ = transformer.forward(
                    c, params, tokens, cache=cache, cache_index=idx,
                    use_flash=route)
            elif kind == "xlstm":
                lg, cache, _ = stacks.xlstm_forward(c, params, tokens,
                                                    state=cache, decode=True)
            else:
                lg, cache, _ = stacks.zamba2_forward(
                    c, params, tokens, state=cache, cache_index=idx,
                    decode=True, use_flash=route)
        return pin_vocab(lg), cache

    # ---------------- shape builders (data pipeline) ----------------
    def batch_shapes(self, kind: str, batch: int, seq: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{name: (shape, dtype)} for every model input of a step."""
        c = self.cfg
        tok = torch.int32
        tok_shape = ((batch, c.n_codebooks, seq) if c.family == "audio"
                     else (batch, seq))
        patches = ((batch, c.n_patches, c.d_model), torch.bfloat16)
        text = ((batch, seq - c.n_patches), tok)
        if kind == "train":
            d: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {
                "tokens": (tok_shape, tok), "targets": (tok_shape, tok)}
            if c.family == "vlm":
                # patches occupy the first n_patches positions of seq
                d.update(tokens=text, targets=text, patch_embeds=patches)
            return d
        if kind == "prefill":
            if c.family == "vlm":
                return {"tokens": text, "patch_embeds": patches}
            return {"tokens": (tok_shape, tok)}
        if kind == "decode":
            one = ((batch, c.n_codebooks, 1) if c.family == "audio"
                   else (batch, 1))
            return {"tokens": (one, tok), "cache_index": ((), tok)}
        raise ValueError(kind)


def build_model(cfg: ModelConfig, use_flash: Any = False, remat: bool = True,
                prefill_last_only: bool = False,
                serve_kernels: bool = True) -> Model:
    return Model(cfg=cfg, use_flash=use_flash, remat=remat,
                 prefill_last_only=prefill_last_only,
                 serve_kernels=serve_kernels)
