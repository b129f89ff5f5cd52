"""Traffic of kind ``closed_batches``: one static batch in flight at a
time, as a client that submits batch after batch of equal-length
prompts to ``ServeEngine.generate`` and waits for each (a closed loop).

A mix file gives ``rows`` (prompts a batch), ``n_new`` (greedy tokens a
request), ``max_seq`` (the engine's cache length) and ``cycle``, a list
of [prompt length, batches]. Batches come in cycles: each cycle holds
every length as often as the mix says, in an order shuffled from the
seed, so every whole cycle carries the mix's proportions and every seed
the same work. Token ids are uniform over the vocabulary.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np


@dataclass(frozen=True)
class Batch:
    index: int          # in the order served
    cycle: int
    last_in_cycle: bool
    tokens: np.ndarray  # (rows, prompt) int32
    n_new: int

    @property
    def rows(self) -> int:
        return self.tokens.shape[0]

    @property
    def prompt(self) -> int:
        return self.tokens.shape[1]


def cycle_lengths(mix: dict) -> List[int]:
    """One cycle's prompt lengths, unshuffled."""
    return [int(s) for s, n in mix["cycle"] for _ in range(int(n))]


def warmup_lengths(mix: dict) -> List[int]:
    """Every prompt length the mix serves, once each."""
    return sorted({int(s) for s, _ in mix["cycle"]})


def batches(mix: dict, vocab: int,
            rng: np.random.Generator) -> Iterator[Batch]:
    """The mix's batches, cycle after cycle, without end."""
    lengths = cycle_lengths(mix)
    rows, n_new = int(mix["rows"]), int(mix["n_new"])
    if max(lengths) + n_new > int(mix["max_seq"]):
        raise ValueError(f"a prompt of {max(lengths)} and {n_new} new "
                         f"tokens exceed max_seq {mix['max_seq']}")
    index, cycle = 0, 0
    while True:
        order = rng.permutation(len(lengths))
        for j, i in enumerate(order):
            tokens = rng.integers(0, vocab, (rows, lengths[i]),
                                  dtype=np.int32)
            yield Batch(index, cycle, j == len(order) - 1, tokens, n_new)
            index += 1
        cycle += 1
