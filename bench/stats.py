"""Statistics of the window's records: the nearest-rank percentile.

``percentile`` is a copy of the port's ``repro_torch.core.stats``
function (nearest rank, ``x[ceil(q * n) - 1]`` of the sorted series),
kept here so that the yardstick does not move with the program.
"""
from __future__ import annotations

import math
from typing import Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of ``xs`` (q in [0, 1]). Raises on an
    empty series: a metric over no requests has no value."""
    if not xs:
        raise ValueError("percentile of an empty series")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"percentile q={q} outside [0, 1]")
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, math.ceil(q * len(ys)) - 1))
    return ys[i]

