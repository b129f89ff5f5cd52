"""Shared latency-series statistics.

One percentile convention for the whole stack (simulator TenantStats,
serve-layer reports, autoscaler hooks): the nearest-rank method,
``x[ceil(q * n) - 1]`` on the sorted series. This is the exact index
arithmetic the seed ``TenantStats.p95`` used, extracted so every layer
agrees bit-for-bit on what "p95" means.

These helpers are unit-agnostic: they return a value in whatever unit
the input series carries. By convention the simulator feeds them
CYCLES and the serve layer feeds them MILLISECONDS — callers must not
mix series from the two domains (convert with ``1e3 / freq_hz`` at
the TenantReport boundary, nowhere else).
"""
from __future__ import annotations

import math
from typing import Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of ``xs`` (q in [0, 1]); 0.0 if empty."""
    if not xs:
        return 0.0
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"percentile q={q} outside [0, 1]")
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, math.ceil(q * len(ys)) - 1))
    return ys[i]


def p50(xs: Sequence[float]) -> float:
    return percentile(xs, 0.50)


def p95(xs: Sequence[float]) -> float:
    return percentile(xs, 0.95)


def p99(xs: Sequence[float]) -> float:
    return percentile(xs, 0.99)


def mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0
