"""vNPU allocator (§III-B): pick the ME/VE split for a tenant.

Implements the paper's Amdahl-style model verbatim:

  Eq. 1  T(n_m, n_v)   = (1-v)/n_m + (1-m)/n_v + (m+v-1)/min(n_m,n_v)
  Eq. 2  U = T_h / T,   T_h = (m+v)/(n_m+n_v)
  Eq. 4  k* = n_m/n_v = sqrt(m/(1-m))      if m < 0.5
                       sqrt((1-v)/v)       if v < 0.5
                       1                   otherwise

(m, v) are the ME/VE active-time fractions profiled on a 1ME+1VE
core at compile time (``WorkloadTrace.profile_mv``). Integer splits
are chosen by evaluating U over the feasible lattice — the continuous
k* only seeds the search, matching the paper's "approximate the
allocated quantity ratio" language.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

from repro_torch.core.vnpu import VNPUConfig
from repro_torch.npu.cost_model import WorkloadTrace
from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.fabric import FabricTopology


def normalized_exec_time(m: float, v: float, n_m: int, n_v: int) -> float:
    """Paper Eq. 1. Requires m+v >= 1 (at least one engine active)."""
    if n_m < 1 or n_v < 1:
        return math.inf
    both = max(m + v - 1.0, 0.0)
    only_me = max(1.0 - v, 0.0)
    only_ve = max(1.0 - m, 0.0)
    return only_me / n_m + only_ve / n_v + both / min(n_m, n_v)


def hypothetical_exec_time(m: float, v: float, n_m: int, n_v: int) -> float:
    return (m + v) / (n_m + n_v)


def eu_utilization(m: float, v: float, n_m: int, n_v: int) -> float:
    """Paper Eq. 2: ratio of hypothetical to modeled execution time."""
    t = normalized_exec_time(m, v, n_m, n_v)
    if not math.isfinite(t) or t <= 0:
        return 0.0
    return hypothetical_exec_time(m, v, n_m, n_v) / t


def optimal_ratio(m: float, v: float) -> float:
    """Paper Eq. 4 closed form (continuous k* = n_m / n_v)."""
    if m < 0.5:
        return math.sqrt(m / (1.0 - m)) if m > 0 else 1e-6
    if v < 0.5:
        return math.sqrt((1.0 - v) / v) if v > 0 else 1e6
    return 1.0


@dataclass(frozen=True)
class Allocation:
    n_me: int
    n_ve: int
    utilization: float
    k_star: float
    m: float
    v: float

    def as_vnpu_config(self, trace: Optional[WorkloadTrace] = None,
                       core: NPUCoreConfig = DEFAULT_CORE,
                       priority: float = 1.0) -> VNPUConfig:
        sram, hbm = 0, 0
        if trace is not None:
            sram, hbm = estimate_memory(trace, self.n_me, core)
        return VNPUConfig(n_me=self.n_me, n_ve=self.n_ve,
                          sram_bytes=sram, hbm_bytes=hbm, priority=priority)


def allocate_eus(m: float, v: float, total_eus: int,
                 core: NPUCoreConfig = DEFAULT_CORE) -> Allocation:
    """Split a total-EU budget (the pay-as-you-go knob) into MEs/VEs.

    Evaluates Eq. 2 over every feasible (n_m, n_v) with
    n_m + n_v = total_eus, n_m,n_v >= 1, capped by the pNPU core —
    equivalently, rounds the Eq. 4 continuous optimum to the best
    integer lattice point.
    """
    if total_eus < 2:
        raise ValueError("need at least 2 EUs (1 ME + 1 VE)")
    k_star = optimal_ratio(m, v)
    best: Optional[Tuple[float, int, int]] = None
    for n_m in range(1, total_eus):
        n_v = total_eus - n_m
        if n_m > core.n_me or n_v > core.n_ve:
            continue
        u = eu_utilization(m, v, n_m, n_v)
        if best is None or u > best[0] + 1e-12:
            best = (u, n_m, n_v)
    if best is None:  # budget exceeds a single core in every split
        n_m = min(core.n_me, max(1, round(total_eus * k_star / (1 + k_star))))
        n_v = min(core.n_ve, max(1, total_eus - n_m))
        best = (eu_utilization(m, v, n_m, n_v), n_m, n_v)
    return Allocation(best[1], best[2], best[0], k_star, m, v)


def allocate_for_trace(trace: WorkloadTrace, total_eus: int,
                       core: NPUCoreConfig = DEFAULT_CORE) -> Allocation:
    m, v = trace.profile_mv()
    return allocate_eus(m, v, total_eus, core)


def place_phase_pair(topology: "FabricTopology",
                     loads: Optional[Sequence[float]] = None,
                     kv_bytes: float = 0.0,
                     distinct: bool = True) -> Tuple[int, int]:
    """Topology-aware companion to the Eq. 1-4 split: pick the
    (prefill_core, decode_core) pair for a chatty phase pair — a
    generative tenant's prefill pool hands every request's KV to its
    decode pool, so the pools must land on NEIGHBORING cores.

    Minimizes, in order: the priced hand-off cost
    (``topology.transfer_cycles`` of one request's ``kv_bytes`` —
    hop count x bytes over the link model), then the combined load of
    the two cores (``loads``, any per-core utilization measure; the
    control plane passes EU + memory used fractions), then the core
    ids (deterministic tie-break). ``distinct`` keeps the pools on
    separate cores (the disaggregation invariant) whenever the fabric
    has more than one."""
    n = topology.n_cores
    if loads is not None and len(loads) != n:
        raise ValueError(
            f"loads has {len(loads)} entries for {n} cores")
    best_key: Optional[Tuple] = None
    best = (0, 0)
    for a in range(n):
        for b in range(n):
            if distinct and n > 1 and a == b:
                continue
            cost = topology.transfer_cycles(a, b, kv_bytes)
            if not math.isfinite(cost):
                continue              # disconnected: never pair them
            load = (loads[a] + loads[b]) if loads is not None else 0.0
            key = (cost, load, a, b)
            if best_key is None or key < best_key:
                best_key, best = key, (a, b)
    if best_key is None:
        raise ValueError("no connected core pair in the topology")
    return best


def pick_evacuation_core(topology: "FabricTopology", src: int,
                         healthy: Sequence[int],
                         loads: Optional[Sequence[float]] = None,
                         kv_bytes: float = 0.0) -> Optional[int]:
    """Failover companion to :func:`place_phase_pair`: pick the core a
    whole vNPU evacuates to after ``src`` faults.

    Minimizes, in order: the priced bulk-transfer cost of the vNPU's
    live occupancy (``topology.transfer_cycles(src, dst, kv_bytes)``
    — an unreachable destination still qualifies, but only after every
    reachable one, since the state must then be rebuilt rather than
    copied), then the destination load, then the core id. ``src``
    itself and non-``healthy`` cores are never candidates. Returns
    ``None`` when no healthy destination exists (the caller falls
    back to suspend/restart)."""
    best_key: Optional[Tuple] = None
    best: Optional[int] = None
    for dst in healthy:
        if dst == src:
            continue
        cost = topology.transfer_cycles(src, dst, kv_bytes)
        load = loads[dst] if loads is not None else 0.0
        key = (0 if math.isfinite(cost) else 1,
               cost if math.isfinite(cost) else 0.0, load, dst)
        if best_key is None or key < best_key:
            best_key, best = key, dst
    return best


def credit_weighted_fill(asks: Sequence[Tuple[str, float, int, int]],
                         free_eus: int, free_segments: int,
                         total_eus: int, total_segments: int,
                         ) -> List[str]:
    """Credit-weighted DRF/knapsack over the fleet's two scarce
    resources — the admission companion to the Eq. 1-4 split. Each
    ask is ``(name, credit, eus, hbm_segments)``; the fill ranks asks
    by credit per dominant share (DRF's scalar:
    ``max(eus/total_eus, segs/total_segs)``) and greedily grants
    while the free pool lasts, skipping asks that no longer fit
    (classic knapsack greedy — a big low-density ask never blocks a
    small affordable one behind it).

    Tie-breaks, in order (all deterministic): higher credit-per-
    dominant-share, then higher absolute credit (of two equal-density
    asks the longer-accrued account goes first), then ascending name.
    Returns the granted names in drain order."""
    def density(credit: float, eus: int, segs: int) -> float:
        dom = max(eus / total_eus if total_eus else 0.0,
                  segs / total_segments if total_segments else 0.0)
        return credit / dom if dom > 0 else math.inf
    ranked = sorted(asks, key=lambda a: (-density(a[1], a[2], a[3]),
                                         -a[1], a[0]))
    granted: List[str] = []
    for name, _credit, eus, segs in ranked:
        if eus <= free_eus and segs <= free_segments:
            granted.append(name)
            free_eus -= eus
            free_segments -= segs
    return granted


def estimate_memory(trace: WorkloadTrace, n_me: int,
                    core: NPUCoreConfig = DEFAULT_CORE) -> Tuple[int, int]:
    """§III-B memory allocation: HBM from the compiler's footprint
    estimate; SRAM proportional to allocated MEs (larger tile sizes).
    Rounded up to the isolation segment granularity."""
    sram = int(core.sram_bytes * n_me / core.n_me)
    sram = -(-sram // core.sram_segment) * core.sram_segment
    hbm = -(-int(trace.hbm_footprint) // core.hbm_segment) * core.hbm_segment
    hbm = min(hbm, core.hbm_bytes)
    return sram, hbm
