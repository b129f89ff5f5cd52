"""Pluggable vNPU scheduler policies (§III-E, §V-A).

The simulator in :mod:`repro_torch.core.simulator` is a policy-agnostic
event loop; everything that decides *which* ready chunk runs on
*which* engine lives here. A policy is a class implementing
:class:`SchedulerPolicy` and registered under a name:

    from repro_torch.core.policies import SchedulerPolicy, register_policy

    @register_policy("my_policy")
    class MyPolicy(SchedulerPolicy):
        spatial = False           # engines shared, not owned
        isa = "vliw"              # compile whole operators

        def schedule(self, sim, t):
            for rt in sim.active_tenants():
                ...sim.dispatch(chunk, engines, t)...

``Simulator(..., policy="my_policy")`` then resolves it through the
registry — no changes to ``repro_torch.core`` required. The four paper
policies (``pmt`` / ``v10`` / ``neu10_nh`` / ``neu10``) are themselves
registered this way.

Policy API surface on the simulator (stable for third parties):

* ``sim.active_tenants()`` — live tenant runtimes, each with
  ``ready_me`` / ``ready_ve`` chunk queues, ``active_cycles`` fair-
  share counters, and ``spec.weight`` priorities.
* ``sim.mes`` / ``sim.ves`` — engine pools; an engine has ``.free``,
  ``.owner`` (tenant idx under spatial policies), ``.chunk``,
  ``.tenant``.
* ``sim.dispatch(chunk, engines, t, harvested=False)`` — start a
  chunk on one or more free engines.
* ``sim.preempt(engine, t, blocked_owner=None)`` — preempt the chunk
  on an engine (and VLIW siblings); remaining work returns to its
  tenant's ready queue with the context-switch penalty.
* ``sim.core`` / ``sim.fair_slice`` — hardware config and the
  fair-share imbalance threshold.
"""
from __future__ import annotations

import heapq
from abc import ABC, abstractmethod
from collections import deque
from typing import (TYPE_CHECKING, Callable, Deque, Dict, Optional, Tuple,
                    Type, Union)

from repro_torch.core.compiler import (PIGGYBACK, PREFILL, ProgramCache,
                                 compile_neuisa, compile_request_plan,
                                 compile_vliw)
from repro_torch.core.neuisa import ME, VE, FusedIssueGroup, form_fused_group

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.simulator import Simulator


class UnknownPolicyError(KeyError):
    """Raised when a policy name is not in the registry."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(
            f"unknown scheduler policy {name!r}; "
            f"registered: {', '.join(available_policies())}")

    def __str__(self) -> str:  # KeyError quotes its arg; keep it readable
        return self.args[0]


_REGISTRY: Dict[str, Type["SchedulerPolicy"]] = {}


def register_policy(name: str) -> Callable[[Type["SchedulerPolicy"]],
                                           Type["SchedulerPolicy"]]:
    """Class decorator: make a :class:`SchedulerPolicy` resolvable by
    name from ``Simulator`` / ``NPUCluster`` / benchmarks."""

    def deco(cls: Type["SchedulerPolicy"]) -> Type["SchedulerPolicy"]:
        if not (isinstance(cls, type) and issubclass(cls, SchedulerPolicy)):
            raise TypeError(f"{cls!r} is not a SchedulerPolicy subclass")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_policy(name: str) -> Type["SchedulerPolicy"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownPolicyError(name) from None


def available_policies() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


PolicyLike = Union[str, "SchedulerPolicy", Type["SchedulerPolicy"]]


def resolve_policy(policy: PolicyLike) -> "SchedulerPolicy":
    """Accept a registry name, a policy class, or an instance; return
    a fresh (or the given) instance ready to bind to one simulator."""
    if isinstance(policy, str):
        return get_policy(policy)()
    if isinstance(policy, type) and issubclass(policy, SchedulerPolicy):
        return policy()
    if isinstance(policy, SchedulerPolicy):
        return policy
    raise TypeError(f"cannot resolve scheduler policy from {policy!r}")


# ----------------------------------------------------------------------
class SchedulerPolicy(ABC):
    """One scheduling discipline for collocated vNPU tenants.

    Class attributes declare the contract the rest of the stack reads:

    * ``spatial`` — engines carry per-tenant ownership (hardware
      isolation); also selects the ``"spatial"`` vNPU mapping in the
      control plane (``"temporal"`` otherwise).
    * ``isa`` — ``"neuisa"`` (μTOp groups, per-engine chunks) or
      ``"vliw"`` (whole operators); picks the compiler front-end.

    Instances are stateful and bound to ONE simulator at a time
    (``Simulator`` resolves names to fresh instances).
    """

    name: str = ""
    spatial: bool = False
    isa: str = "vliw"

    @property
    def mapping(self) -> str:
        """vNPU mapping scheme this policy implies (``"spatial"`` =
        engines owned per tenant, ``"temporal"`` = shared)."""
        return "spatial" if self.spatial else "temporal"

    @classmethod
    def compile_program(cls, trace, core):
        """Compile a :class:`WorkloadTrace` into the program form this
        policy schedules."""
        if cls.isa == "neuisa":
            return compile_neuisa(trace, core)
        return compile_vliw(trace, core)

    @classmethod
    def compile_plan(cls, plan, core, cache: Optional[ProgramCache] = None):
        """Compile a phase-structured
        :class:`~repro_torch.npu.cost_model.RequestPlan` into per-phase
        programs, sharing ``cache`` so decode programs at each context
        bucket compile once per (model shape, policy ISA)."""
        return compile_request_plan(plan, core, isa=cls.isa, cache=cache)

    # ---------------- lifecycle hooks ----------------
    def on_attach(self, sim: "Simulator") -> None:
        """Called once when the simulator binds this policy."""

    def on_tenant_added(self, sim: "Simulator", rt) -> None:
        """Called after a tenant runtime joins (possibly mid-run)."""

    def on_tenant_removed(self, sim: "Simulator", rt) -> None:
        """Called after a tenant runtime is deregistered mid-run."""

    def on_request_migrated(self, sim: "Simulator", rt, req) -> None:
        """Called after a request migrated in from ANOTHER core's
        simulator (cross-core prefill->decode hand-off over the
        cluster fabric) and joined ``rt``'s continuous decode batch.
        Policies with per-tenant warm state can prime it here; the
        default is a no-op — the request is already queued and the
        dispatch pass that follows the hand-off event schedules it
        like any decode work."""

    # ---------------- the actual scheduler ----------------
    @abstractmethod
    def schedule(self, sim: "Simulator", t: float) -> None:
        """Dispatch ready chunks onto free engines at time ``t``.

        Policies may ALSO define the opt-in hook::

            def schedule_incremental(self, sim, t, dirty) -> None

        When present (and the simulator runs with
        ``fast_path=True, incremental=True``), the simulator calls it
        instead of ``schedule`` and ONLY when the dirty set is
        non-empty — ``dirty`` is the frozen set of tenant indices
        whose scheduling inputs changed since the last pass (-1 marks
        a global change). The hook must reach the same fixpoint a full
        ``schedule`` pass would; a policy that keeps enabling state
        outside the ready queues / engine pools must call
        ``sim.mark_dirty`` when that state changes, or its work will
        sit unscheduled until an unrelated event lands. Policies
        without the hook (``pmt``/``v10``) transparently fall back to
        a full ``schedule`` pass per event. See ``docs/architecture.md``
        ("Event engine") for the marking contract."""


# ----------------------------------------------------------------------
# Built-in policies — the paper's baselines and Neu10 itself, extracted
# verbatim from the former Simulator._schedule_* branches.
# ----------------------------------------------------------------------
def _ve_drain_first(c) -> bool:
    """VE ready-queue sort key: drains of ME groups run first (the
    operation scheduler's rule) — hoisted to module level so the hot
    schedule pass doesn't rebuild a closure per call."""
    return not c.from_me_group


def _harvest_order_me(r) -> tuple:
    """Harvest priority (ME pool): decode-phase tenants first, then
    least-served — hoisted like :func:`_ve_drain_first`."""
    return (not any(c.phase == "decode" for c in r.ready_me),
            r.active_cycles)


def _harvest_order_ve(r) -> tuple:
    """Harvest priority (VE pool) — see :func:`_harvest_order_me`."""
    return (not any(c.phase == "decode" for c in r.ready_ve),
            r.active_cycles)




class _SpatialPolicy(SchedulerPolicy):
    """Spatially-isolated vNPUs (dedicated engines per tenant).

    ``harvest``: idle engines may run co-tenant μTOps (reclaimed by
    preemption when the owner needs them back). ``fuse``: harvested
    decode VE μTOps landing under a co-tenant's in-flight prefill ME
    μTOps form a :class:`~repro_torch.core.neuisa.FusedIssueGroup` — the
    paper's Fig. 6 ISA-level co-scheduling — and run to completion
    (the reclaim pass skips fused members, so neither side pays a
    preemption drain for the shared window). Piggybacked iterations
    interact naturally with both mechanisms: their ME μTOps (phase
    ``"piggyback"``) anchor fused groups exactly like prefill MEs —
    the fused program's own window is prefill-dominated — while
    reclaim treats non-fused piggyback μTOps like any other harvested
    work (preemptible with the standard drain).

    ``schedule`` has two result-identical implementations selected by
    ``Simulator.fast_path``: the reference pass (kept for the A/B
    equality + speedup proof in ``fig25_scaling``) and a tightened
    pass that buckets free engines per owner once per pool and skips
    empty ready queues."""

    spatial = True
    isa = "neuisa"
    harvest = False
    fuse = False

    def __init__(self) -> None:
        # the most recent fused issue groups formed, newest last —
        # observability for tests/operators (who anchored, who rode):
        # inspect via ``sim.policy_obj.recent_fused``
        self.recent_fused: Deque[FusedIssueGroup] = deque(maxlen=64)

    def schedule(self, sim: "Simulator", t: float) -> None:
        if getattr(sim, "fast_path", False):
            self._schedule_fast(sim, t)
        else:
            self._schedule_ref(sim, t)

    def _schedule_ref(self, sim: "Simulator", t: float) -> None:
        tenants = sim.active_tenants()
        # 1) owners dispatch on their own engines (MEs then VEs)
        for pool, ready_attr in ((sim.mes, "ready_me"), (sim.ves, "ready_ve")):
            for rt in tenants:
                ready = getattr(rt, ready_attr)
                if ready_attr == "ready_ve":
                    # operation scheduler: prioritize drains of ME groups
                    ready.sort(key=lambda c: not c.from_me_group)
                own_free = [e for e in pool
                            if e.owner == rt.idx and e.free]
                while own_free and ready:
                    sim.dispatch(ready.pop(0), [own_free.pop(0)], t)
                # 2) reclaim: preempt harvested μTOps on my engines.
                # Engines drain in PARALLEL, so the owner is wall-
                # blocked for ONE ctx window per reclaim pass (what
                # Table III measures), however many engines it takes
                # back. Fused issue-group members are exempt: they
                # were co-issued INTO the owner's prefill window and
                # complete with it (Fig. 6).
                if self.harvest and ready:
                    reclaimed = 0
                    for e in pool:
                        if reclaimed >= len(ready):
                            break
                        if (e.owner == rt.idx and not e.free
                                and e.chunk is not None
                                and e.tenant != rt.idx):
                            if e.chunk.fused:
                                continue
                            sim.preempt(e, t)
                            reclaimed += 1
                    if reclaimed:
                        ctx = float(sim.core.ctx_switch_cycles
                                    if pool is sim.mes else 32)
                        rt.stats.reclaim_blocked += ctx
        if not self.harvest:
            return
        # 3) harvest: leftover ready chunks take others' idle engines.
        for pool, ready_attr in ((sim.mes, "ready_me"), (sim.ves, "ready_ve")):
            # only engines whose owner has no pending demand are up for
            # harvest (§III-E scheduling policy). Phase-aware ordering:
            # decode μTOps (tiny, latency-critical) harvest first, so a
            # decoding tenant interleaves into the VE-idle window under
            # a co-located tenant's prefill (Fig. 2/6); ties fall back
            # to the fair-share counter. Single-phase tenants all rank
            # equal on the first key — seed ordering is unchanged.
            def _order(r):
                has_decode = any(c.phase == "decode"
                                 for c in getattr(r, ready_attr))
                return (not has_decode, r.active_cycles)

            for rt in sorted(tenants, key=_order):
                ready = getattr(rt, ready_attr)
                if not ready:
                    continue
                for e in pool:
                    if not ready:
                        break
                    if not e.free or e.owner == rt.idx:
                        continue
                    owner = (sim.tenants[e.owner]
                             if e.owner is not None else None)
                    owner_ready = getattr(owner, ready_attr) if owner else []
                    if owner_ready:
                        continue  # owner will use it this round
                    chunk = ready.pop(0)
                    if (self.fuse and pool is sim.ves and owner is not None
                            and chunk.phase == "decode"):
                        self._try_fuse(sim, chunk, e.owner, rt)
                    sim.dispatch(chunk, [e], t, harvested=True)

    def _schedule_fast(self, sim: "Simulator", t: float) -> None:
        """Tightened schedule pass — decision-for-decision identical
        to :meth:`_schedule_ref` (dispatch order, reclaim victims,
        harvest order), with the per-tenant engine scans replaced by
        one free-engine bucketing per pool (ownership is disjoint, so
        dispatches never consume another owner's bucket) and empty
        ready queues skipped outright."""
        tenants = sim.active_tenants()
        harvest = self.harvest
        # `_dispatch` is aliased to `dispatch` at class-definition
        # time, so comparing the two detects overrides made any way —
        # instance patch (spies), subclass method, or class-level
        # monkeypatch — without caching state that a patch could
        # poison. Overridden dispatches route through the documented
        # API so the observation point keeps seeing every chunk.
        if ("dispatch" in sim.__dict__
                or type(sim).dispatch is not type(sim)._dispatch):
            def dispatch(c, e, t_, harvested=False):
                sim.dispatch(c, [e], t_, harvested=harvested)
        else:
            dispatch = sim._dispatch1
        # 1) owners dispatch on their own engines (MEs then VEs);
        # 2) reclaim harvested μTOps squatting on needed engines.
        # A pool sub-pass only runs when some tenant has ready work of
        # that kind — with none, no dispatch NOR reclaim can happen,
        # and (since only reclaim preemption refills ready queues
        # mid-pass) none can appear either. Ready queues are stable
        # list objects (mutated in place, never reassigned), so the
        # (tenant, queue) pairing is taken once per sub-pass.
        for is_ve, pool in ((False, sim.mes), (True, sim.ves)):
            work = [(rt, rt.ready_ve if is_ve else rt.ready_me)
                    for rt in tenants]
            if not any(ready for _, ready in work):
                continue
            free_by_owner: Dict = {}
            for e in pool:
                if e.token < 0:
                    free_by_owner.setdefault(e.owner, []).append(e)
            for rt, ready in work:
                if not ready:
                    continue
                if is_ve and len(ready) > 1:
                    ready.sort(key=_ve_drain_first)
                own_free = free_by_owner.get(rt.idx)
                while own_free and ready:
                    dispatch(ready.pop(0), own_free.pop(0), t)
                # reclaim scan only when this owner actually has
                # foreign chunks squatting on its engines (the
                # simulator counts them incrementally) — with none the
                # scan is a provable no-op
                if harvest and ready and sim._squat.get(rt.idx):
                    reclaimed = 0
                    for e in pool:
                        if reclaimed >= len(ready):
                            break
                        if (e.owner == rt.idx and e.token >= 0
                                and e.chunk is not None
                                and e.tenant != rt.idx):
                            if e.chunk.fused:
                                continue
                            sim.preempt(e, t)
                            reclaimed += 1
                    if reclaimed:
                        ctx = float(sim.core.ctx_switch_cycles
                                    if pool is sim.mes else 32)
                        rt.stats.reclaim_blocked += ctx
        if not harvest:
            return
        # 3) harvest: leftover ready chunks take others' idle engines
        # (same phase-aware decode-first order as the reference pass).
        # Harvest only dispatches — no queue refills — so the src and
        # free-engine snapshots taken here stay exhaustive; the token
        # re-check covers engines consumed within this section.
        for is_ve, pool in ((False, sim.mes), (True, sim.ves)):
            src = [rt for rt in tenants
                   if (rt.ready_ve if is_ve else rt.ready_me)]
            if not src:
                continue
            free_list = [e for e in pool if e.token < 0]
            if not free_list:
                continue

            def _order(r):
                has_decode = any(c.phase == "decode" for c in
                                 (r.ready_ve if is_ve else r.ready_me))
                return (not has_decode, r.active_cycles)

            for rt in sorted(src, key=_order):
                ready = rt.ready_ve if is_ve else rt.ready_me
                for e in free_list:
                    if not ready:
                        break
                    if e.token >= 0 or e.owner == rt.idx:
                        continue
                    owner = (sim.tenants[e.owner]
                             if e.owner is not None else None)
                    if owner is not None and (owner.ready_ve if is_ve
                                              else owner.ready_me):
                        continue  # owner will use it this round
                    chunk = ready.pop(0)
                    if (self.fuse and is_ve and owner is not None
                            and chunk.phase == "decode"):
                        self._try_fuse(sim, chunk, e.owner, rt)
                    dispatch(chunk, e, t, harvested=True)

    def schedule_incremental(self, sim: "Simulator", t: float,
                             dirty) -> None:
        """Dirty-set schedule pass (the incremental core's opt-in
        hook): decision-for-decision identical to
        :meth:`_schedule_fast` — the simulator already guarantees it
        only runs when ``dirty`` is non-empty, i.e. something changed
        a scheduling input since the last pass. On top of that gate it
        (a) consumes the simulator's maintained per-owner free-engine
        index instead of re-bucketing each pool, (b) inlines the
        single-engine dispatch body (token issue, duration, heap
        push), and (c) dispatches runs of identical compute-only
        sibling chunks (a VE μTOp's slot chunks) as one *cohort*
        sharing a single completion event — same end time, one heap
        entry, per-chunk accounting replayed in engine order at
        completion, and heap tie-order unchanged because the merged
        entries' sequence numbers were consecutive. Cohort members run
        on the owner's OWN engines, which this policy never preempts,
        so the shared token is never partially invalidated.
        ``dirty``'s content is not needed for correctness here — every
        enabling transition for this policy lives in the ready queues
        and engine pools, which the pass re-reads — but one re-mark
        is: reclaim is bounded per pass (one ctx window per owner), so
        an owner still squatted-on with leftover ready work re-marks
        itself to keep the next pass coming. When ``dispatch`` is
        overridden (spies/subclasses), the whole pass routes through
        :meth:`_schedule_fast` so the documented API keeps seeing
        every chunk."""
        if ("dispatch" in sim.__dict__
                or type(sim).dispatch is not type(sim)._dispatch):
            self._schedule_fast(sim, t)
            return
        act = sim._act
        harvest = self.harvest
        heap = sim._heap
        push = heapq.heappush
        tok = sim._tok.__next__
        seq = sim._seq.__next__
        squat = sim._squat
        duration = sim._duration
        bw_register = sim._bw_register
        bpc = sim._bpc
        mes, ves = sim.mes, sim.ves
        left_me = left_ve = False   # pool has leftover ready work
                                    # after owner dispatch -> harvest
        # 1) owner dispatch + 2) reclaim, MEs then VEs (the fast
        # pass's structure; ready queues are stable list objects read
        # live, exactly like the fast pass's work-list snapshot)
        for is_ve in (False, True):
            if is_ve:
                free_own, kind, nd = sim._free_ve_own, VE, 0
            else:
                free_own, kind, nd = sim._free_me_own, ME, 0
            for rt in act:
                ready = rt.ready_ve if is_ve else rt.ready_me
                if not ready:
                    continue
                if is_ve and len(ready) > 1:
                    # operation scheduler: drains of ME groups first
                    ready.sort(key=_ve_drain_first)
                own = free_own.get(rt.idx)
                if own:
                    is_neu = rt.is_neuisa
                    while own and ready:
                        c = ready.pop(0)
                        e = own[0]
                        del own[0]
                        nd += 1
                        c.n_dispatched = 1
                        token = tok()
                        hbm = c.hbm_bytes
                        # a non-contender μTOp (compute-bound: would
                        # not pass _bw_register's test, same float
                        # expression) has a pressure-stable duration —
                        # identical consecutive siblings can form a
                        # cohort around one completion event
                        if is_neu and (hbm <= 0.0
                                       or hbm / bpc < c.cycles):
                            if hbm <= 0.0:
                                end = t + c.cycles + c.penalty
                            else:
                                end = t + duration(c, 1)
                            e.token = token
                            e.chunk = c
                            e.tenant = c.tenant
                            e.start = t
                            e.end = end
                            e.harvested = False
                            n = 1
                            while own and ready:
                                c2 = ready[0]
                                if (c2.cycles != c.cycles
                                        or c2.penalty != c.penalty
                                        or c2.hbm_bytes != hbm):
                                    break
                                del ready[0]
                                e2 = own[0]
                                del own[0]
                                nd += 1
                                c2.n_dispatched = 1
                                c2.cohort = 1   # member marker
                                e2.token = token
                                e2.chunk = c2
                                e2.tenant = c2.tenant
                                e2.start = t
                                e2.end = end
                                e2.harvested = False
                                n += 1
                            if n > 1:
                                c.cohort = n
                            push(heap, (end, seq(), kind, e.eid, token))
                        else:
                            dur = duration(c, 1)
                            bw_register(c)
                            e.token = token
                            e.chunk = c
                            e.tenant = c.tenant
                            e.start = t
                            end = t + dur
                            e.end = end
                            e.harvested = False
                            push(heap, (end, seq(), kind, e.eid, token))
                if harvest and ready and squat.get(rt.idx):
                    pool = ves if is_ve else mes
                    reclaimed = 0
                    for e in pool:
                        if reclaimed >= len(ready):
                            break
                        if (e.owner == rt.idx and e.token >= 0
                                and e.chunk is not None
                                and e.tenant != rt.idx):
                            if e.chunk.fused:
                                continue
                            sim.preempt(e, t)
                            reclaimed += 1
                    if reclaimed:
                        ctx = float(sim.core.ctx_switch_cycles
                                    if not is_ve else 32)
                        rt.stats.reclaim_blocked += ctx
                        # the preempted remainder went back on the
                        # VICTIM's ready queue (this pool): harvest
                        # must still look at it
                        if is_ve:
                            left_ve = True
                        else:
                            left_me = True
                    # reclaim is bounded per pass: if this owner is
                    # still squatted-on with work left, the full pass
                    # would reclaim again next event — keep that event
                    # coming even if nothing else marks
                    if ready and squat.get(rt.idx):
                        sim._dirty.add(rt.idx)
                if ready:
                    # leftover ready work (or a reclaim preemption put
                    # work back on a queue of this pool): the harvest
                    # section below must look at this pool
                    if is_ve:
                        left_ve = True
                    else:
                        left_me = True
            if is_ve:
                sim._nfree_ve -= nd
            else:
                sim._nfree_me -= nd
        if not harvest:
            return
        # 3) harvest — identical structure and order to _schedule_fast
        # (the leftover flags + maintained free counters make the
        # common nothing-to-harvest case two boolean checks per pool)
        for is_ve in (False, True):
            if not (left_ve if is_ve else left_me):
                continue
            if not (sim._nfree_ve if is_ve else sim._nfree_me):
                continue
            src = [rt for rt in act
                   if (rt.ready_ve if is_ve else rt.ready_me)]
            if not src:
                continue
            pool = ves if is_ve else mes
            free_list = [e for e in pool if e.token < 0]
            kind = VE if is_ve else ME
            if len(src) > 1:
                src.sort(key=_harvest_order_ve if is_ve
                         else _harvest_order_me)
            for rt in src:
                ready = rt.ready_ve if is_ve else rt.ready_me
                for e in free_list:
                    if not ready:
                        break
                    if e.token >= 0 or e.owner == rt.idx:
                        continue
                    ow = e.owner
                    owner = sim.tenants[ow] if ow is not None else None
                    if owner is not None and (owner.ready_ve if is_ve
                                              else owner.ready_me):
                        continue  # owner will use it this round
                    chunk = ready.pop(0)
                    if (self.fuse and is_ve and owner is not None
                            and chunk.phase == "decode"):
                        self._try_fuse(sim, chunk, ow, rt)
                    sim._free_idx_remove(e)
                    if chunk.hbm_bytes <= 0.0 and rt.is_neuisa:
                        dur = chunk.cycles + chunk.penalty
                    else:
                        dur = duration(chunk, 1)
                        bw_register(chunk)
                    chunk.n_dispatched = 1
                    token = tok()
                    e.token = token
                    e.chunk = chunk
                    e.tenant = chunk.tenant
                    e.start = t
                    end = t + dur
                    e.end = end
                    e.harvested = True
                    if ow is not None:
                        squat[ow] = squat.get(ow, 0) + 1
                    push(heap, (end, seq(), kind, e.eid, token))

    def _try_fuse(self, sim: "Simulator", chunk, owner_idx: int, rt) -> None:
        """Fuse a harvested decode VE μTOp into the engine owner's
        in-flight prefill ME group, if it has one (Fig. 6): the μTOp
        becomes a fused issue-group member and is exempt from reclaim
        until it completes. Piggybacked ME μTOps anchor too — a
        budgeted iteration's ME window is its prefill slice, so a
        co-tenant's decode VE μTOp rides it exactly like a plain
        prefill window."""
        anchor = next(
            (m.chunk for m in sim.mes
             if m.chunk is not None and m.tenant == owner_idx
             and m.chunk.kind == ME
             and m.chunk.phase in (PREFILL, PIGGYBACK)),
            None)
        if anchor is None:
            return
        group = form_fused_group(
            owner_idx, anchor.op_name,
            [(chunk.tenant, chunk.op_name, chunk.phase)], max_ve=1)
        if group.fused:
            chunk.fused = True
            rt.stats.fused_groups += 1
            self.recent_fused.append(group)


@register_policy("neu10_nh")
class Neu10NoHarvestPolicy(_SpatialPolicy):
    """Spatial-isolated vNPUs, no harvesting (MIG-like static
    partition)."""

    harvest = False


@register_policy("neu10")
class Neu10Policy(_SpatialPolicy):
    """Spatial-isolated + dynamic μTOp scheduling with ME/VE
    harvesting, reclaim preemption, and fused prefill+decode issue
    groups (the paper's system; fusion is the Fig. 6 co-scheduling of
    a prefill chunk's MU-heavy μTOps with co-tenant decode VE
    μTOps)."""

    harvest = True
    fuse = True


@register_policy("v10")
class V10Policy(SchedulerPolicy):
    """V10: operator-granular temporal sharing; an ME operator
    occupies ALL MEs (VLIW control-flow coupling); VE-only operators
    from other vNPUs may run concurrently; priority-based
    preemption."""

    spatial = False
    isa = "vliw"

    def schedule(self, sim: "Simulator", t: float) -> None:
        order = sorted(sim.active_tenants(),
                       key=lambda r: r.active_cycles / r.spec.weight)
        free_mes = [e for e in sim.mes if e.free]
        all_mes_free = len(free_mes) == len(sim.mes)
        for rt in order:
            # ME op: needs the WHOLE ME array (VLIW coupling)
            if rt.ready_me:
                if all_mes_free:
                    chunk = rt.ready_me.pop(0)
                    sim.dispatch(chunk, list(sim.mes), t)
                    all_mes_free = False
                else:
                    # priority-based preemption of the running op
                    running = next((e for e in sim.mes if not e.free
                                    and e.chunk is not None), None)
                    if running is not None and running.tenant >= 0:
                        holder = sim.tenants[running.tenant]
                        deficit = (holder.active_cycles / holder.spec.weight
                                   - rt.active_cycles / rt.spec.weight)
                        if deficit > sim.fair_slice:
                            sim.preempt(running, t)
            # VE-only ops run on the free VE pool concurrently
            if rt.ready_ve:
                free_ves = [e for e in sim.ves if e.free]
                if free_ves:
                    chunk = rt.ready_ve.pop(0)
                    sim.dispatch(chunk, free_ves, t)
        # note: dispatching a VE op across k free VEs divides its span
        # (VLIW VE ops address all VE slots).


@register_policy("pmt")
class PMTPolicy(SchedulerPolicy):
    """PREMA-style whole-core temporal sharing; preemptive fair
    scheduling at operator boundaries."""

    spatial = False
    isa = "vliw"

    def __init__(self) -> None:
        self._last: int = -1  # tenant currently holding the core

    def schedule(self, sim: "Simulator", t: float) -> None:
        # whole core belongs to one tenant at a time (PREMA-style
        # task-level sharing): the core changes hands at operator
        # boundaries only when the fair-share deficit is large —
        # switches are coarse and expensive.
        busy = any(not e.free for e in sim.mes + sim.ves)
        if busy:
            return
        order = sorted(
            (rt for rt in sim.active_tenants()
             if rt.ready_me or rt.ready_ve),
            key=lambda r: r.active_cycles / r.spec.weight)
        if not order:
            return
        rt = order[0]
        if self._last >= 0 and self._last != rt.idx:
            holder = sim.tenants[self._last]
            if holder.ready_me or holder.ready_ve:
                deficit = (holder.active_cycles / holder.spec.weight
                           - rt.active_cycles / rt.spec.weight)
                if deficit < 4 * sim.fair_slice:
                    rt = holder  # keep the core; not worth a switch yet
        # whole-core context switch cost when the core changes hands
        penalty = 0.0
        if self._last not in (-1, rt.idx):
            penalty = float(sim.core.ctx_switch_cycles * sim.core.n_me)
        self._last = rt.idx
        if rt.ready_me:
            chunk = rt.ready_me.pop(0)
            chunk.penalty += penalty
            sim.dispatch(chunk, list(sim.mes), t)
        elif rt.ready_ve:
            chunk = rt.ready_ve.pop(0)
            chunk.penalty += penalty
            sim.dispatch(chunk, list(sim.ves), t)

    def on_tenant_removed(self, sim: "Simulator", rt) -> None:
        if self._last == rt.idx:
            self._last = -1


# ----------------------------------------------------------------------
# KV-pressure eviction victim selection (PREMA-style, arXiv 1909.04548)
# ----------------------------------------------------------------------
def estimated_remaining_cycles(plan, req, context: int) -> float:
    """PREMA-style per-request service estimate: decode tokens
    remaining x the per-step cost of the request's CURRENT context
    bucket (``CompiledPhase.est_cycles``, the ideal-parallel lower
    bound of the bucket's decode trace). Requests still mid-prefill
    count their full generation. Units: cycles."""
    steps = max(req.gen_len - max(req.tokens_done, 1), 0) + 1
    if not plan.has_decode:
        return float(steps)
    return steps * max(plan.decode_phase_for(context).est_cycles, 1.0)


def pick_eviction_victim(requests, plan, context_of, shared_refs_of=None):
    """Choose which in-flight decoding request loses its KV segments
    when a tenant's continuous batch outgrows its HBM budget: the one
    with the LARGEST estimated remaining service (it would occupy the
    segments longest, so parking it frees the most byte-time for the
    short requests whose TBT the SLO watches — PREMA's
    estimate-driven preemption applied to memory instead of compute).
    Deterministic: ties break toward the latest arrival, then the
    candidate list order.

    ``shared_refs_of`` (``req -> int``, optional) marks requests
    holding a shared KV prefix entry: a holder whose entry is still
    referenced by OTHER live requests (refs > 1) is picked LAST —
    evicting it cannot free the shared segments (the refcount keeps
    them resident), so it frees the least bytes per eviction. With the
    callback omitted the ordering is identical to the pre-sharing
    picker."""
    best, best_key = None, None
    for i, req in enumerate(requests):
        key = (estimated_remaining_cycles(plan, req, context_of(req)),
               req.arrival, i)
        if shared_refs_of is not None:
            key = (0 if shared_refs_of(req) > 1 else 1,) + key
        if best_key is None or key > best_key:
            best, best_key = req, key
    return best


# ----------------------------------------------------------------------
# live SLO violation signals (credit-based admission, PREMA tokens)
# ----------------------------------------------------------------------
def slo_violation_signal(stats, slo_ttft_cycles=None, slo_tbt_cycles=None,
                         ttft_seen: int = 0, tbt_seen: int = 0,
                         ) -> Tuple[int, int, int]:
    """Count NEW latency samples violating the tenant's declared SLOs
    — the live signal the credit admission controller debits accounts
    with (:mod:`repro_torch.core.admission`). Scans the tenant's
    ``TenantStats`` TTFT / TBT series past the caller's cursors (the
    controller stores them per account, so every sample is converted
    into at most one debit) against the SLOs in CYCLES (the stats
    domain; the serving layer converts its ms SLOs once). Returns
    ``(violations, new_ttft_cursor, new_tbt_cursor)``; a None SLO
    skips its series entirely."""
    v = 0
    if slo_ttft_cycles is not None:
        v += sum(1 for x in stats.ttft[ttft_seen:] if x > slo_ttft_cycles)
        ttft_seen = len(stats.ttft)
    if slo_tbt_cycles is not None:
        v += sum(1 for x in stats.tbt[tbt_seen:] if x > slo_tbt_cycles)
        tbt_seen = len(stats.tbt)
    return v, ttft_seen, tbt_seen
