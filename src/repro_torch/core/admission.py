"""Credit-based SLO admission control (fleet scale).

Registration today always succeeds when segments fit; under bursty
multi-tenant load that melts the well-behaved tenants' tails. This
module adds the cluster-level gate in front of
:meth:`repro_torch.serve.session.ServingSession.register`: every tenant
holds a :class:`CreditAccount` whose balance follows PREMA's
token scheme —

* **accrual**: credit accrues continuously at a rate set by the
  tenant's DECLARED SLOs (``base_rate`` plus ``slo_rate`` times the
  summed strictness ``1/slo_ms`` of each declared TTFT / TBT / e2e
  target). A tenant that promises tight service pays for — and is
  owed — tight admission.
* **decay**: the opening balance decays exponentially toward zero
  with half-life ``decay_halflife_s`` (PREMA's aging, continuous
  form), so hoarded credit is bounded by ``rate * tau`` and a
  long-idle tenant cannot bank unbounded priority.
* **debits**: every observed violation — a TTFT / TBT sample over
  its declared SLO, or an admission-deadline miss — debits
  ``violation_debit``; admissions and approved scale-ups debit their
  price. A tenant that keeps missing its own SLOs stops outbidding
  its neighbors.

Every account conserves exactly::

    credit == initial + accrued - decayed - debited

(the hypothesis property pinned in ``tests/test_admission.py``).

Admission itself is a credit-weighted DRF/knapsack over the fleet's
two scarce resources — execution units and HBM isolation segments
(:func:`repro_torch.core.allocator.credit_weighted_fill` ranks competing
asks). An ask's price is its *dominant share* (the DRF scalar:
``max(eus/total_eus, segs/total_segs)``) scaled by fleet pressure:
below ``free_level`` utilization admission is free (an idle fleet
admits everyone — the off-state a bit-identical cluster expects);
above it the price rises linearly to ``price_scale * dominant`` at
saturation. A low-credit ask is first *down-sized* (fewer EUs at a
cheaper price; the HBM ask is never shrunk — resident weights must
fit) and only then *deferred*, to be retried from the serving
session's re-admission queue as credit recovers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.allocator import credit_weighted_fill

__all__ = ["AdmissionAsk", "AdmissionDecision", "CreditAccount",
           "FleetState", "AdmissionController"]


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class AdmissionAsk:
    """One tenant's resource ask at the admission gate. ``eus`` is
    execution units (ME+VE engines); ``hbm_segments`` is HBM isolation
    segments (0 when the ask carries no explicit HBM pin — the gate
    then prices EUs alone); ``slo_*`` are the tenant's DECLARED
    targets in milliseconds (they set the accrual rate, not a
    verdict); ``min_eus`` floors how far a down-size may shrink."""

    name: str
    eus: int
    hbm_segments: int = 0
    slo_ttft_ms: Optional[float] = None
    slo_tbt_ms: Optional[float] = None
    slo_p95_ms: Optional[float] = None
    min_eus: int = 2


@dataclass
class AdmissionDecision:
    """Gate verdict: ``status`` is ``"admit"`` (full ask),
    ``"downsize"`` (admitted at ``eus < ask.eus``) or ``"defer"``
    (queue and retry as credit recovers). ``price`` is the credit
    debited (0 for a deferral); ``reason`` says why a deferral
    happened (``"credit"`` vs ``"capacity"``)."""

    status: str
    eus: int = 0
    price: float = 0.0
    reason: str = ""


@dataclass
class FleetState:
    """Cluster-wide resource snapshot the gate prices against: free
    counts over HEALTHY cores, totals over the full fleet (a faulted
    core's capacity still counts toward the denominator — pressure
    rises when cores fail, exactly when admission should tighten)."""

    free_eus: int
    total_eus: int
    free_hbm_segments: int
    total_hbm_segments: int

    @property
    def pressure(self) -> float:
        """Fleet utilization, dominant-resource form: the max of the
        EU and HBM used fractions."""
        eu = 1.0 - self.free_eus / self.total_eus if self.total_eus else 0.0
        hbm = (1.0 - self.free_hbm_segments / self.total_hbm_segments
               if self.total_hbm_segments else 0.0)
        return max(eu, hbm)

    def dominant_share(self, eus: int, hbm_segments: int) -> float:
        """DRF's scalar: the ask's largest fraction of any one fleet
        resource."""
        eu = eus / self.total_eus if self.total_eus else 0.0
        hbm = (hbm_segments / self.total_hbm_segments
               if self.total_hbm_segments else 0.0)
        return max(eu, hbm)

    def fits(self, eus: int, hbm_segments: int) -> bool:
        return eus <= self.free_eus and hbm_segments <= self.free_hbm_segments


# ----------------------------------------------------------------------
@dataclass
class CreditAccount:
    """Per-tenant PREMA-style credit balance plus its conservation
    ledger (``accrued`` / ``decayed`` / ``debited`` are lifetime
    totals; ``decayed`` is signed — a negative balance decays toward
    zero too, so debt is forgiven at the same half-life credit ages).
    The ``*_seen`` cursors mark how much of the tenant's live
    :class:`~repro_torch.core.simulator.TenantStats` series the controller
    has already converted into debits."""

    name: str
    rate: float                  # accrual, credit per simulated second
    tau_s: float                 # decay time constant (halflife/ln 2)
    credit: float = 0.0
    initial: float = 0.0
    accrued: float = 0.0
    decayed: float = 0.0
    debited: float = 0.0
    last_s: float = 0.0
    violations: int = 0          # SLO-sample + deadline-miss debits
    deferrals: int = 0           # times the gate said "defer"
    scaleups_denied: int = 0     # autoscale grows the gate refused
    ttft_seen: int = 0
    tbt_seen: int = 0
    misses_seen: int = 0

    def advance(self, now_s: float) -> None:
        """Roll the balance forward to ``now_s``: decay the opening
        balance, then add the interval's accrual (discrete PREMA
        update; order documented, deterministic)."""
        dt = now_s - self.last_s
        if dt <= 0.0:
            return
        d = self.credit * (1.0 - math.exp(-dt / self.tau_s))
        self.credit -= d
        self.decayed += d
        a = self.rate * dt
        self.credit += a
        self.accrued += a
        self.last_s = now_s

    def spend(self, amount: float) -> None:
        self.credit -= amount
        self.debited += amount

    def conserved(self, tol: float = 1e-6) -> bool:
        """The invariant every mutation preserves."""
        return abs(self.credit - (self.initial + self.accrued
                                  - self.decayed - self.debited)) <= tol


# ----------------------------------------------------------------------
class AdmissionController:
    """The fleet-scale credit gate. Stateless about the cluster — the
    serving session snapshots a :class:`FleetState` per decision — so
    it is directly unit-testable. All times are simulated SECONDS (the
    session's API domain); all SLO inputs are milliseconds."""

    def __init__(self, initial_credit: float = 1.0,
                 decay_halflife_s: float = 1.0,
                 base_rate: float = 0.1, slo_rate: float = 1.0,
                 violation_debit: float = 0.25,
                 price_scale: float = 4.0, free_level: float = 0.5,
                 min_eus: int = 2, charge_admission: bool = True):
        if decay_halflife_s <= 0:
            raise ValueError(
                f"decay_halflife_s must be > 0, got {decay_halflife_s}")
        if not 0.0 <= free_level < 1.0:
            raise ValueError(
                f"free_level must be in [0, 1), got {free_level}")
        self.initial_credit = float(initial_credit)
        self.tau_s = decay_halflife_s / math.log(2.0)
        self.base_rate = float(base_rate)
        self.slo_rate = float(slo_rate)
        self.violation_debit = float(violation_debit)
        self.price_scale = float(price_scale)
        self.free_level = float(free_level)
        self.min_eus = int(min_eus)
        self.charge_admission = bool(charge_admission)
        self.accounts: Dict[str, CreditAccount] = {}

    # ------------------------------------------------------------------
    def accrual_rate(self, ask: AdmissionAsk) -> float:
        """Credit/second from declared strictness: ``base_rate`` plus
        ``slo_rate`` per unit of summed ``1/slo_ms`` over the declared
        targets. No SLOs -> the base rate alone (a best-effort tenant
        accrues slowly and queues behind everyone under pressure)."""
        strict = sum(1.0 / s for s in (ask.slo_ttft_ms, ask.slo_tbt_ms,
                                       ask.slo_p95_ms)
                     if s is not None and s > 0)
        return self.base_rate + self.slo_rate * strict

    def touch(self, ask: AdmissionAsk, now_s: float) -> CreditAccount:
        """Get-or-create the tenant's account (idempotent; re-attach
        after failover must not reset a balance)."""
        acct = self.accounts.get(ask.name)
        if acct is None:
            acct = CreditAccount(name=ask.name, rate=self.accrual_rate(ask),
                                 tau_s=self.tau_s,
                                 credit=self.initial_credit,
                                 initial=self.initial_credit,
                                 last_s=now_s)
            self.accounts[ask.name] = acct
        return acct

    def balance(self, name: str, now_s: float) -> float:
        """The tenant's rolled-forward balance (0 for unknown names)."""
        acct = self.accounts.get(name)
        if acct is None:
            return 0.0
        acct.advance(now_s)
        return acct.credit

    def observe(self, name: str, now_s: float, violations: int) -> None:
        """Feed live violation signals (SLO-violating TTFT/TBT samples
        and deadline misses, counted by
        :func:`repro_torch.core.policies.slo_violation_signal`) into the
        account as debits."""
        acct = self.accounts.get(name)
        if acct is None or violations <= 0:
            return
        acct.advance(now_s)
        acct.violations += violations
        acct.spend(self.violation_debit * violations)

    # ------------------------------------------------------------------
    def price(self, eus: int, hbm_segments: int,
              fleet: FleetState) -> float:
        """Credit price of an ask: dominant share x pressure slack.
        Free below ``free_level`` fleet utilization; rises linearly to
        ``price_scale * dominant_share`` at saturation."""
        slack = (fleet.pressure - self.free_level) / (1.0 - self.free_level)
        slack = min(max(slack, 0.0), 1.0)
        return self.price_scale * fleet.dominant_share(
            eus, hbm_segments) * slack

    def decide(self, ask: AdmissionAsk, now_s: float,
               fleet: FleetState) -> AdmissionDecision:
        """Gate one ask. Admit at full size when the balance covers
        the price and the fleet has the capacity; otherwise walk the
        EU ask down toward ``ask.min_eus`` (the HBM ask never shrinks
        — resident weights must fit) looking for a size that is both
        affordable and placeable; otherwise defer. Admission debits
        its price (``charge_admission=False`` turns the gate into a
        pure ranking, for A/B rows)."""
        acct = self.touch(ask, now_s)
        acct.advance(now_s)
        floor = max(min(ask.min_eus, ask.eus), self.min_eus)
        for eus in range(ask.eus, floor - 1, -1):
            if not fleet.fits(eus, ask.hbm_segments):
                continue
            p = self.price(eus, ask.hbm_segments, fleet)
            if acct.credit + 1e-12 < p:
                continue
            if self.charge_admission:
                acct.spend(p)
            status = "admit" if eus == ask.eus else "downsize"
            return AdmissionDecision(status=status, eus=eus, price=p)
        acct.deferrals += 1
        reason = ("capacity"
                  if not fleet.fits(floor, ask.hbm_segments) else "credit")
        return AdmissionDecision(status="defer", reason=reason)

    def approve_scaleup(self, name: str, extra_eus: int, now_s: float,
                        fleet: FleetState) -> bool:
        """Autoscale grows pass the same gate: the incremental EUs are
        priced like a fresh ask (no HBM delta — resizes keep the HBM
        pin) and debited from the tenant's balance. Unknown tenants
        are approved (the session opens an account for every attached
        tenant; this is only a guard)."""
        acct = self.accounts.get(name)
        if acct is None or extra_eus <= 0:
            return True
        acct.advance(now_s)
        p = self.price(extra_eus, 0, fleet)
        if acct.credit + 1e-12 < p:
            acct.scaleups_denied += 1
            return False
        if self.charge_admission:
            acct.spend(p)
        return True

    def rank(self, asks: Sequence[AdmissionAsk], now_s: float,
             fleet: FleetState) -> List[str]:
        """Credit-weighted drain order for the re-admission queue:
        delegate to the allocator's knapsack
        (:func:`~repro_torch.core.allocator.credit_weighted_fill`) over the
        fleet's free EUs/segments, using each account's rolled-forward
        balance as the weight."""
        rows = [(a.name, self.balance(a.name, now_s)
                 if a.name in self.accounts else self.touch(a, now_s).credit,
                 a.eus, a.hbm_segments) for a in asks]
        return credit_weighted_fill(rows, fleet.free_eus,
                                    fleet.free_hbm_segments,
                                    fleet.total_eus,
                                    fleet.total_hbm_segments)
