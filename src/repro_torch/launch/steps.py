"""Step functions: train_step (fwd + bwd + AdamW + WSD schedule),
prefill_step, decode_step.

Port of the reference package's ``launch/steps.py``. The training state
is {"params": the params module, "m": ..., "v": ..., "step": ...}: the
module's parameters require grad, and the moments are dicts keyed by
its parameter names. A train step updates the state in place and
returns it.

A sharded state (``checkpoint.elastic.reshard_state`` under
``distributed.sharding.state_specs``) takes the same step: each
gradient is brought to its parameter's placements (partial sums
reduced), and the whole step, backward included (remat recomputes the
forward there), runs under ``implicit_replication()``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import DeviceLike
from repro_torch.distributed.sharding import replicate_plain
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import wsd_schedule

TrainState = Dict[str, Any]


def init_train_state(model: Model, generator: torch.Generator,
                     dtype=torch.float32, device: DeviceLike = None
                     ) -> TrainState:
    """Weights as ``Model.init`` draws them (a CPU generator gives the
    same weights on every device), trainable, with fresh AdamW state."""
    params = model.init(generator, dtype, device)
    params.requires_grad_(True)
    return {"params": params, **adamw_init(dict(params.named_parameters()))}


def make_train_step(model: Model, peak_lr: float = 3e-4,
                    warmup: int = 2000, stable: int = 80_000,
                    decay: int = 20_000):
    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        named = dict(state["params"].named_parameters())
        # the backward recomputes remat'ed layers, so it runs under
        # implicit replication too
        with replicate_plain(state["params"]):
            loss, metrics = model.loss(state["params"], batch)
            grads = torch.autograd.grad(loss, list(named.values()),
                                        materialize_grads=True)
            if isinstance(grads[0], DTensor):     # partial sums reduced
                grads = [g.redistribute(p.device_mesh, p.placements)
                         for p, g in zip(named.values(), grads)]
            lr = wsd_schedule(state["step"], peak_lr, warmup, stable, decay)
            _, new_opt = adamw_update(
                named, dict(zip(named, grads)),
                {"m": state["m"], "v": state["v"], "step": state["step"]},
                lr)
        state.update(new_opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, dict(metrics, loss=loss.detach(), lr=lr)

    return train_step


# Serving steps run under no_grad, not inference_mode: a sharded cache
# (DTensor) cannot take inference tensors in place.
def make_prefill_step(model: Model):
    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill_step


def make_decode_step(model: Model):
    @torch.no_grad()
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return decode_step
