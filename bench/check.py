"""The check of outputs: what the timed window served, held against the
plain reference.

Once the window has closed and the program is freed, a sample of the
window's requests, drawn from the seed and holding one of the longest
prompts, is run through the family's reference in float32 over its
prompt and its served tokens (each served token but the last is the
input of a decode step), on weights drawn again from the same seed. At
every position that produced a served token, the gap by which that
token's reference logit lies below the reference's best is taken. The
numbers compared are a cell's choice (``limits/<cell>.json``): the
widest gap, or the mean gap where routing flips make the widest swing
as far in the program as in the control. The control takes the
reference in float8 in the program's place: at the same positions, the
gap of the token that float8 puts first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench import weights
from bench.reference.common import Block

MAX_BLOCK_ROWS = 8   # reference rows a block, so that it fits beside W


@dataclass
class Served:
    """One request of the window: its prompt and the tokens served."""
    prompt: np.ndarray   # (S,)
    tokens: np.ndarray   # (n_new,)


def sample(units: Sequence[List[Served]], n: int,
           rng: np.random.Generator) -> List[List[Served]]:
    """``n`` units (the rows of one routing group; one row where rows do
    not depend on each other), one of them of the longest prompt, the
    rest drawn at random without replacement."""
    if not units:
        return []
    longest = max(len(u[0].prompt) for u in units)
    first = int(rng.choice([i for i, u in enumerate(units)
                            if len(u[0].prompt) == longest]))
    rest = [i for i in range(len(units)) if i != first]
    pick = rng.choice(rest, size=min(n - 1, len(rest)), replace=False)
    return [units[first]] + [units[int(i)] for i in sorted(pick)]


def blocks(chosen: List[List[Served]], device) -> List[Tuple[Block, List[Served]]]:
    """The chosen units as reference blocks of equal length, at most
    ``MAX_BLOCK_ROWS`` rows (whole units) each."""
    by_len: Dict[Tuple[int, int, int], List[List[Served]]] = {}
    for u in chosen:
        key = (len(u[0].prompt), len(u[0].tokens), len(u))
        by_len.setdefault(key, []).append(u)
    out = []
    for (S, n_new, gr), units in sorted(by_len.items()):
        per = max(1, MAX_BLOCK_ROWS // gr)
        for i in range(0, len(units), per):
            rows = [r for u in units[i:i + per] for r in u]
            seq = np.stack([np.concatenate([r.prompt, r.tokens[:-1]])
                            for r in rows])
            b = Block(tokens=torch.as_tensor(seq, dtype=torch.long,
                                             device=device),
                      judged=list(range(S - 1, S - 1 + n_new)), prompt=S,
                      group_rows=gr)
            out.append((b, rows))
    return out


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(…, J) gap of ``tokens``' reference logits below the best."""
    best = ref_logits.amax(-1)
    return best - ref_logits.gather(-1, tokens[..., None].long())[..., 0]


def numbers(gaps: Sequence[float]) -> Dict[str, float]:
    """The numbers a cell may compare (``limits/<cell>.json``), over the
    gaps of the judged tokens."""
    return {"widest_gap": float(max(gaps)),
            "mean_gap": float(sum(gaps) / len(gaps))}


def judge(cfg: dict, reference, weight_seed: int, dtype: torch.dtype,
          device, chosen: List[List[Served]],
          control: bool = False) -> Dict[str, object]:
    """{"widest_gap", "mean_gap", "tokens", "gaps"[, "control_gaps"]}
    over ``chosen``: ``gaps`` every judged token's gap, in the order of
    ``chosen``'s blocks. Draws the weights again from ``weight_seed``."""
    W = weights.draw(reference.param_specs(cfg), weight_seed, dtype, device)
    bl = blocks(chosen, device)
    ref = reference.logits(cfg, W, [b for b, _ in bl], "fp32")
    ctl = reference.logits(cfg, W, [b for b, _ in bl], "fp8") \
        if control else None
    got, got_ctl = [], []
    for i, (b, rows) in enumerate(bl):
        served = torch.as_tensor(np.stack([r.tokens for r in rows]),
                                 device=device)
        got.append(gaps(ref[i], served).flatten())
        if ctl is not None:
            got_ctl.append(gaps(ref[i], ctl[i].argmax(-1)).flatten())
    g = torch.cat(got).cpu().tolist()
    out: Dict[str, object] = dict(numbers(g), tokens=len(g), gaps=g)
    if control:
        out["control_gaps"] = torch.cat(got_ctl).cpu().tolist()
    return out
