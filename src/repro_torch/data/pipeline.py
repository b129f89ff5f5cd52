"""Data pipeline: deterministic synthetic LM token streams with
background prefetch.

Synthetic data is generated with a counter-based PRNG keyed on
(epoch, step, shard), so restarts and elastic resharding reproduce
the exact same global batch order — the property checkpoint/restore
tests rely on. Structure (Zipf-ish unigram + short-range repetition)
gives the LM a learnable signal so loss curves actually descend in
the end-to-end example.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class SyntheticLMData:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    # data-parallel shard of this host
    shard: int = 0
    n_shards: int = 1

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)

    def sample(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        local_b = self.batch // self.n_shards
        V = cfg.vocab_size
        shape = ((local_b, cfg.n_codebooks, self.seq + 1)
                 if cfg.family == "audio" else (local_b, self.seq + 1))
        # Zipf-ish unigram distribution capped to vocab
        toks = rng.zipf(1.3, size=shape).astype(np.int64) % V
        # short-range structure: repeat the previous token with p=0.3
        rep = rng.random(shape) < 0.3
        rolled = np.roll(toks, 1, axis=-1)
        toks = np.where(rep, rolled, toks).astype(np.int32)
        batch = {
            "tokens": toks[..., :-1],
            "targets": toks[..., 1:],
        }
        if cfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (local_b, cfg.n_patches, cfg.d_model)).astype(np.float32)
        return batch


def make_batch_iterator(data: SyntheticLMData, start_step: int = 0,
                        prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator (overlaps host datagen
    with device compute)."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put(data.sample(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
