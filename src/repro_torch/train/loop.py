"""Training driver: train_step + data prefetch + async checkpointing +
crash-resume + straggler monitoring.

Port of the reference package's ``train/loop.py``, on one device: the
loop runs on ``cuda`` unless ``TrainConfig.device`` asks for the CPU.
Weights are drawn from a CPU generator seeded with ``seed``, so the
same config starts from the same weights on every device. Batches stay
numpy until the loop moves them to the device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.registry import build_model


@dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 256
    peak_lr: float = 3e-4
    warmup: int = 20
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    dtype: Any = torch.float32
    remat: bool = True
    device: DeviceLike = None


def _to_device(batch: Dict[str, np.ndarray], dtype, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = (t.to(device, torch.long) if k in ("tokens", "targets")
                  else t.to(device, dtype))
    return out


def train(cfg: ModelConfig, tc: TrainConfig,
          log_fn=print) -> Dict[str, Any]:
    """Returns {"final_loss", "losses", "wall_s", "state"} as the
    reference does, and "step_s", each step's seconds."""
    device = resolve_device(tc.device)
    model = build_model(cfg, remat=tc.remat)
    state = init_train_state(model, torch.Generator().manual_seed(tc.seed),
                             tc.dtype, device)

    start_step = 0
    ckpt = None
    if tc.ckpt_dir:
        ckpt = Checkpointer(tc.ckpt_dir)
        restored, step = ckpt.restore(state)
        if restored is not None:
            state = restored
            start_step = step
            log_fn(f"[train] resumed from step {step}")

    step_fn = make_train_step(
        model, peak_lr=tc.peak_lr, warmup=tc.warmup,
        stable=max(tc.steps - tc.warmup - tc.steps // 5, 1),
        decay=max(tc.steps // 5, 1))

    data = SyntheticLMData(cfg, tc.batch, tc.seq, seed=tc.seed)
    it = make_batch_iterator(data, start_step=start_step)
    monitor = StragglerMonitor(n_hosts=1)

    losses: List[float] = []
    step_s: List[float] = []
    t_start = time.time()
    tokens_per_step = tc.batch * tc.seq
    try:
        for step in range(start_step, tc.steps):
            batch = _to_device(next(it), tc.dtype, device)
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            monitor.observe(step, 0, dt)
            losses.append(loss)
            step_s.append(dt)
            if step % tc.log_every == 0 or step == tc.steps - 1:
                log_fn(f"[train] step {step:5d} loss {loss:.4f} "
                       f"lr {float(metrics['lr']):.2e} "
                       f"{tokens_per_step / dt:,.0f} tok/s")
            if ckpt and (step + 1) % tc.ckpt_every == 0:
                ckpt.save(step + 1, state)
        if ckpt:
            ckpt.save(tc.steps, state, blocking=True)
    finally:
        it.close()
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "losses": losses,
        "wall_s": time.time() - t_start,
        "state": state,
        "step_s": step_s,
    }
