"""Vectorized fleet simulator (beyond-paper): the Neu10 spatial
scheduler as a fluid-flow model in PyTorch.

The port of the reference package's ``core/sim_jax.py``, with the same
model, public names and return dicts. The Python simulator
(simulator.py) is the discrete-event ORACLE. This module trades
per-μTOp discreteness for a group-granular fluid approximation in which
a whole fleet evaluation — every workload pair × every EU split × every
HBM-bandwidth point — advances as one batch of cells on the device.
Cloud operators use this shape of model for capacity planning /
collocation search, where the question is "which pairs co-locate well at
what EU splits", not exact per-request tails.

Model
-----
Per tenant: a compiled NeuISA program flattened to per-group arrays
  me[g]    total ME work (cycles), parallel up to par[g] engines
  ve[g]    total VE work (cycles), parallel up to n_y engines
  hbm[g]   HBM bytes
Groups execute sequentially; within a group ME/VE/HBM proceed
concurrently (the μTOp + operation schedulers' pipelining). Rates:
  me_rate = min(par_remaining, own_me + harvestable_from_other)
  ve_rate = min(n_y_cap,       own_ve + harvestable)
  hbm_rate = BW / #{tenants with hbm remaining}
Harvestable = the other tenant's idle engines (zero under neu10_nh).
Advance to the next group-completion event; closed-loop requests.

Batching
--------
The reference nests ``jax.vmap`` up to three deep over one
``lax.while_loop``. Here every (pair, split, bandwidth) cell is one row
of a batch dimension N, each state leaf an (N, 2) tensor (two tenants),
and one Python loop advances all cells by one event per iteration.
Like the vmapped ``while_loop``, the loop runs while any cell runs and
freezes every cell whose condition is false, its time and event count
included. The host asks whether any cell still runs only every
``SYNC_EVERY`` iterations; frozen cells do not change, so the result
does not depend on it.

Arithmetic is fp32, as the reference computes with x64 off, one op at a
time in the reference's order (no ``torch.compile``, which would fuse
and reorder).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.neuisa import NeuISAProgram
from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig

BIG = 1e30
MAX_EVENTS = 200_000
# Loop iterations between two host checks of whether any cell runs.
SYNC_EVERY = 64
# Loop iterations in this process; callers reset it to 0 to count a run.
iterations = 0

F32 = torch.float32
# The least normal fp32. XLA on the CPU flushes subnormal results to
# zero (and reads subnormal inputs as zero); the port does the same on
# every op whose result can be subnormal, so that the same cells finish
# or stall on both sides and on every device.
FLT_MIN = torch.finfo(F32).tiny


@dataclass
class FluidProgram:
    """Per-group arrays (padded to a common length for batching)."""

    me: np.ndarray     # (G,) cycles
    ve: np.ndarray     # (G,) cycles
    hbm: np.ndarray    # (G,) bytes
    par: np.ndarray    # (G,) max engines the group's μTOps can use
    n_groups: int

    @staticmethod
    def from_program(prog: NeuISAProgram) -> "FluidProgram":
        me, ve, hbm, par = [], [], [], []
        for g in prog.groups:
            me.append(g.me_work)
            ve.append(g.ve_work)
            hbm.append(sum(u.hbm_bytes for u in g.all_utops()))
            par.append(max(len(g.me_utops), 1))
        return FluidProgram(
            np.asarray(me, np.float64), np.asarray(ve, np.float64),
            np.asarray(hbm, np.float64), np.asarray(par, np.float64),
            len(prog.groups))

    def padded(self, G: int) -> "FluidProgram":
        def pad(a):
            return np.pad(a, (0, G - len(a)))

        return FluidProgram(pad(self.me), pad(self.ve), pad(self.hbm),
                            np.pad(self.par, (0, G - len(self.par)),
                                   constant_values=1.0),
                            self.n_groups)


def _pack_numpy(pairs: Sequence[Tuple[NeuISAProgram, NeuISAProgram]]
                ) -> Dict[str, np.ndarray]:
    """(P, 2, G) float64 program arrays and (P, 2) group counts, every
    program padded to the widest group count (pad groups carry zero work
    and par=1, so they complete instantly and never affect rates)."""
    fluid = [(FluidProgram.from_program(a), FluidProgram.from_program(b))
             for a, b in pairs]
    G = max(f.n_groups for pair in fluid for f in pair)
    fluid = [(a.padded(G), b.padded(G)) for a, b in fluid]
    out = {k: np.stack([np.stack([getattr(a, k), getattr(b, k)])
                        for a, b in fluid])
           for k in ("me", "ve", "hbm", "par")}
    out["n_groups"] = np.asarray([[a.n_groups, b.n_groups]
                                  for a, b in fluid], np.int32)
    return out


def _to_device(packed: Dict[str, np.ndarray], dev: torch.device
               ) -> Dict[str, torch.Tensor]:
    # float64 -> float32 rounds to nearest, as jnp.asarray does with x64 off
    return {k: torch.from_numpy(v).to(
                device=dev, dtype=torch.int32 if k == "n_groups" else F32)
            for k, v in packed.items()}


def pack_pair(p1: NeuISAProgram, p2: NeuISAProgram,
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """-> dict of (2, G) fp32 tensors + (2,) int32 group counts."""
    dev = resolve_device(device)
    return {k: v[0] for k, v in _to_device(_pack_numpy([(p1, p2)]),
                                           dev).items()}


def pack_batch(pairs: List[Tuple[NeuISAProgram, NeuISAProgram]],
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Stack ``pack_pair`` outputs for a list of pairs into one
    (P, 2, G) dict, padding every program to the widest group count
    (pad groups carry zero work and par=1, so they complete instantly
    and never affect rates)."""
    return _to_device(_pack_numpy(pairs), resolve_device(device))


def _fma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         sign: float = 1.0) -> torch.Tensor:
    """fp32 ``c + sign * a * b`` rounded once. XLA on the CPU contracts
    the reference's products and sums into fused multiply-adds, where
    eager torch would round the product and the sum apart; in
    ``rem - rate * dt`` that moves group completions, and so the event
    count, in some cells. A product of two fp32 values is exact in
    float64, so the float64 sum cast to fp32 rounds as the fused op does
    (but for float64 results that tie exactly between two fp32 values)."""
    return torch.addcmul(c.double(), a.double(), b.double(),
                         value=sign).to(F32)


def _simulate(prog: Dict[str, torch.Tensor], cells_per_pair: int,
              alloc_me: torch.Tensor, alloc_ve: torch.Tensor,
              bw0: torch.Tensor, n_requests: int, harvest: bool,
              core: NPUCoreConfig, max_events: int
              ) -> Dict[str, torch.Tensor]:
    """Every cell of the batch to completion. ``prog`` holds (P, 2, G)
    tensors and (P, 2) group counts; the N = P * C cells are pair-major,
    C = ``cells_per_pair`` per pair, with (N, 2) allocations and (N,)
    bandwidths ``bw0``. Returns the leaves of ``simulate_pair``'s dict
    over N."""
    global iterations
    dev = bw0.device
    P, _, G = prog["me"].shape
    C = cells_per_pair
    N = P * C
    # (P, C, 2, G) views of the pair tables: no copy per cell
    table = {k: prog[k].unsqueeze(1).expand(P, C, 2, G)
             for k in ("me", "ve", "hbm", "par")}
    n_groups = prog["n_groups"].repeat_interleave(C, 0)        # (N, 2)

    def index(gidx: torch.Tensor) -> torch.Tensor:
        return gidx.clamp(max=G - 1).view(P, C, 2, 1)

    def current(field: str, idx: torch.Tensor) -> torch.Tensor:
        return torch.gather(table[field], 3, idx).view(N, 2)

    def full(value: float) -> torch.Tensor:
        return torch.full((N, 2), value, dtype=F32, device=dev)

    n_y = full(float(core.n_ve))
    zero = full(0.0)
    big = full(BIG)
    floor = full(1e-12)
    bw0 = bw0.unsqueeze(-1)                                    # (N, 1)

    gidx = torch.zeros((N, 2), dtype=torch.long, device=dev)
    idx = index(gidx)
    rem_me = current("me", idx)
    rem_ve = current("ve", idx)
    rem_hbm = current("hbm", idx)
    done = torch.zeros((N, 2), dtype=torch.bool, device=dev)
    reqs = torch.zeros((N, 2), dtype=torch.int32, device=dev)
    req_t = zero.clone()               # completion time of the Nth request
    me_busy, ve_busy = zero.clone(), zero.clone()
    t = torch.zeros((N,), dtype=F32, device=dev)
    ev = torch.zeros((N,), dtype=torch.int32, device=dev)

    def finish_time(rem, rate):
        # rem >= 0, so the reference's "rem > 0" test is the flush's
        q = rem / torch.maximum(rate, floor)
        return torch.where(q < FLT_MIN, zero, q)

    def body():
        nonlocal gidx, idx, rem_me, rem_ve, rem_hbm, done, reqs, req_t
        nonlocal me_busy, ve_busy, t, ev
        active = ~done.all(-1) & (ev < max_events)              # (N,)
        a2 = active.unsqueeze(-1)
        # rates
        par = current("par", idx)
        want = torch.where(done | (rem_me <= 0), zero, par)
        own = torch.minimum(want, alloc_me)
        idle = torch.maximum(alloc_me - want, zero)
        if harvest:
            surplus = torch.maximum(want - alloc_me, zero)
            me_r = own + torch.minimum(surplus, idle.flip(-1))
        else:
            me_r = own
        ve_want = torch.where(done | (rem_ve <= 0), zero, n_y)
        ve_own = torch.minimum(ve_want, alloc_ve)
        ve_idle = torch.maximum(alloc_ve - ve_want, zero)
        if harvest:
            ve_r = ve_own + torch.minimum(
                torch.maximum(ve_want - alloc_ve, zero), ve_idle.flip(-1))
        else:
            ve_r = ve_own
        has_mem = ~done & (rem_hbm > 0)
        n_mem = has_mem.sum(-1, keepdim=True, dtype=torch.int32).clamp(min=1)
        hbm_r = torch.where(has_mem, bw0 / n_mem, zero)
        # group completion = max over the three resources
        t_grp = torch.maximum(
            finish_time(rem_me, me_r),
            torch.maximum(finish_time(rem_ve, ve_r),
                          finish_time(rem_hbm, hbm_r)))
        t_grp = torch.where(done, big, t_grp)
        dt = t_grp.amin(-1, keepdim=True)                       # (N, 1)
        dt = torch.where(torch.isfinite(dt) & (dt < big[:, :1]), dt,
                         zero[:, :1])
        dt64 = dt.double()
        n_rem_me = _fma(rem_me, me_r, dt64, -1.0)
        n_rem_ve = _fma(rem_ve, ve_r, dt64, -1.0)
        n_rem_hbm = _fma(rem_hbm, hbm_r, dt64, -1.0)
        # max(x, 0) with subnormal x flushed: x < FLT_MIN -> 0
        n_rem_me = torch.where(n_rem_me < FLT_MIN, zero, n_rem_me)
        n_rem_ve = torch.where(n_rem_ve < FLT_MIN, zero, n_rem_ve)
        n_rem_hbm = torch.where(n_rem_hbm < FLT_MIN, zero, n_rem_hbm)
        n_me_busy = me_busy + torch.where(done, zero, me_r * dt)
        n_ve_busy = ve_busy + torch.where(done, zero, ve_r * dt)
        n_t = t + dt.squeeze(-1)
        finished = ~done & (n_rem_me <= 0) & (n_rem_ve <= 0) \
            & (n_rem_hbm <= 0)
        # advance finished tenants to next group (or next request)
        next_g = gidx + 1
        wrapped = next_g >= n_groups
        n_reqs = reqs + (finished & wrapped).to(torch.int32)
        n_req_t = torch.where(finished & wrapped & (n_reqs <= n_requests),
                              n_t.unsqueeze(-1), req_t)
        next_g = torch.where(wrapped, 0, next_g)
        n_gidx = torch.where(finished, next_g, gidx)
        n_idx = index(n_gidx)
        n_rem_me = torch.where(finished, current("me", n_idx), n_rem_me)
        n_rem_ve = torch.where(finished, current("ve", n_idx), n_rem_ve)
        n_rem_hbm = torch.where(finished, current("hbm", n_idx), n_rem_hbm)
        n_done = done | (n_reqs >= n_requests)
        # frozen cells keep their old carry, as under a vmapped while_loop
        gidx = torch.where(a2, n_gidx, gidx)
        idx = index(gidx)
        rem_me = torch.where(a2, n_rem_me, rem_me)
        rem_ve = torch.where(a2, n_rem_ve, rem_ve)
        rem_hbm = torch.where(a2, n_rem_hbm, rem_hbm)
        done = torch.where(a2, n_done, done)
        reqs = torch.where(a2, n_reqs, reqs)
        req_t = torch.where(a2, n_req_t, req_t)
        me_busy = torch.where(a2, n_me_busy, me_busy)
        ve_busy = torch.where(a2, n_ve_busy, ve_busy)
        t = torch.where(active, n_t, t)
        # A cell that neither advanced its clock nor finished a group
        # leaves its state as it was: it would repeat this step until
        # max_events, as the reference's loop does, so it jumps there.
        stalled = active & (dt.squeeze(-1) == 0) & ~finished.any(-1)
        ev = torch.where(stalled, max_events, ev + active.to(torch.int32))

    while True:
        for _ in range(SYNC_EVERY):
            body()
        iterations += SYNC_EVERY
        if not bool((~done.all(-1) & (ev < max_events)).any()):
            break

    makespan = torch.maximum(t, torch.full_like(t, 1e-9))
    # XLA turns the reference's division by the constant clock into a
    # product with its fp32 reciprocal, fused with the add that follows
    inv_freq = full(1.0) / full(core.freq_hz)
    busy_den = torch.full_like(t, float(core.n_me)) * makespan
    ve_den = torch.full_like(t, float(core.n_ve)) * makespan
    return {
        "makespan": makespan,
        "throughput": reqs.to(F32) / _fma(floor, req_t, inv_freq),
        "me_util": (me_busy[:, 0] + me_busy[:, 1]) / busy_den,
        "ve_util": (ve_busy[:, 0] + ve_busy[:, 1]) / ve_den,
        "events": ev,
    }


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _bw0(core: NPUCoreConfig, scales: torch.Tensor) -> torch.Tensor:
    # the reference multiplies a weakly typed Python float by an fp32
    # scale: the float is rounded to fp32 first
    return torch.full_like(scales, core.hbm_bytes_per_cycle) * scales


def simulate_pair(
    prog: Dict[str, torch.Tensor],   # dict from pack_pair
    alloc_me,                        # (2,) MEs per vNPU
    alloc_ve,                        # (2,)
    n_requests: int,
    harvest: bool = True,
    hbm_scale: float = 1.0,
    core: NPUCoreConfig = DEFAULT_CORE,
    max_events: int = MAX_EVENTS,
    device: DeviceLike = None,
):
    """Returns dict: makespan (cycles), per-tenant request throughput,
    me/ve busy-cycle utilizations, and the number of events."""
    dev = resolve_device(device)
    batch = {k: v.to(dev).unsqueeze(0) for k, v in prog.items()}
    out = _simulate(
        batch, 1,
        _f32(alloc_me, dev).reshape(1, 2), _f32(alloc_ve, dev).reshape(1, 2),
        _bw0(core, _f32([hbm_scale], dev)), n_requests, harvest, core,
        max_events)
    return {k: v[0] for k, v in out.items()}


def sweep_collocations(
    pairs: List[Tuple[NeuISAProgram, NeuISAProgram]],
    eu_splits,                 # S ((me1, me2), (ve1, ve2)) splits
    bw_points=(1.0,),          # B HBM-bandwidth scale factors
    n_requests: int = 6,
    harvest: bool = True,
    core: NPUCoreConfig = DEFAULT_CORE,
    device: DeviceLike = None,
):
    """The whole collocation-search grid — every workload pair ×
    EU split × HBM-bandwidth point — as one batch of cells.

    This is the fleet-planning query behind the fig22/fig25 outer
    grids: "which pairs co-locate well at which splits, and how does
    that ranking move under memory pressure". The discrete simulator
    answers it one cell at a time (a fresh event loop per cell); here
    the full (P, S, B) lattice advances together, one event per
    iteration for every cell, with one transfer of the programs to the
    device.

    ``eu_splits`` entries are ``((me1, me2), (ve1, ve2))`` engine
    counts, one per collocated tenant. Returns the
    :func:`simulate_pair` dict with every leaf shaped ``(P, S, B)``
    (``throughput`` ``(P, S, B, 2)``).
    """
    dev = resolve_device(device)
    batch = pack_batch(pairs, dev)
    P, S, B = len(pairs), len(eu_splits), len(bw_points)
    mes = _f32([s[0] for s in eu_splits], dev)                 # (S, 2)
    ves = _f32([s[1] for s in eu_splits], dev)                 # (S, 2)
    scales = _f32(bw_points, dev)                              # (B,)
    cells = torch.arange(P * S * B, device=dev)
    split, point = (cells // B) % S, cells % B
    out = _simulate(batch, S * B, mes[split], ves[split],
                    _bw0(core, scales[point]), n_requests, harvest, core,
                    MAX_EVENTS)
    return {k: v.reshape((P, S, B) + v.shape[1:]) for k, v in out.items()}


def fleet_sweep(
    pairs: List[Tuple[NeuISAProgram, NeuISAProgram]],
    alloc_me=(2, 2),
    alloc_ve=(2, 2),
    n_requests: int = 6,
    hbm_scales=(1.0,),
    harvest: bool = True,
    core: NPUCoreConfig = DEFAULT_CORE,
    device: DeviceLike = None,
):
    """Every (pair × hbm_scale) cell in one batch: the one-split case
    of :func:`sweep_collocations`, leaves shaped ``(P, B)``."""
    out = sweep_collocations(pairs, [(alloc_me, alloc_ve)],
                             bw_points=hbm_scales, n_requests=n_requests,
                             harvest=harvest, core=core, device=device)
    return {k: v[:, 0] for k, v in out.items()}
