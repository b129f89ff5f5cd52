"""Deprecated closed-loop facade over the online control plane.

`MultiTenantServer` predates the :mod:`repro_torch.serve.session` API: it
registers every tenant up front, then runs a closed-loop batch
(`simulate(n_requests)`). It is kept as a thin shim so existing call
sites keep working — new code should use
:class:`~repro_torch.serve.session.NPUCluster` (resource plane) plus
:class:`~repro_torch.serve.session.ServingSession` (open-loop request
plane, mid-run register/deregister/resize, SLO autoscale hook).

The pipeline it drives is unchanged:

  tenant workload -> compile-time (m, v) profile -> vNPU allocator
  (Eq. 1-4) -> vNPU manager mapping (spatial/temporal) -> NeuISA
  compilation -> μTOp scheduler simulation -> SLO accounting.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocator import allocate_for_trace, estimate_memory
from repro_torch.core.simulator import SimResult
from repro_torch.core.vnpu import VNPUConfig
from repro_torch.npu.cost_model import WorkloadTrace
from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig
from repro_torch.serve.session import (NPUCluster, TenantHandle, TenantReport,
                                 run_closed_loop)

# back-compat names: the old dataclasses are the new ones
Tenant = TenantHandle
__all__ = ["MultiTenantServer", "Tenant", "TenantReport"]


class MultiTenantServer:
    """Closed-loop batch server (deprecated shim over NPUCluster)."""

    def __init__(self, core: NPUCoreConfig = DEFAULT_CORE,
                 n_pnpus: int = 1, policy: str = "neu10"):
        self.cluster = NPUCluster(core=core, n_pnpus=n_pnpus, policy=policy)
        self.core = core
        self.policy = self.cluster.policy_name

    @property
    def manager(self):
        return self.cluster.manager

    @property
    def tenants(self) -> List[TenantHandle]:
        return self.cluster.tenants

    # ------------------------------------------------------------------
    def register(self, name: str, trace: WorkloadTrace, eu_budget: int,
                 priority: float = 1.0,
                 slo_p95_ms: Optional[float] = None) -> TenantHandle:
        return self.cluster.register(name, trace, eu_budget,
                                     priority=priority,
                                     slo_p95_ms=slo_p95_ms)

    def register_model(self, cfg: ModelConfig, phase: str = "prefill",
                       batch: int = 8, seq: int = 512, eu_budget: int = 4,
                       **kw) -> TenantHandle:
        return self.cluster.register_model(cfg, phase=phase, batch=batch,
                                           seq=seq, eu_budget=eu_budget, **kw)

    def register_generative(self, name: str, cfg: ModelConfig,
                            **kw) -> TenantHandle:
        """Phase-structured LLM tenant (prefill -> decode chain). The
        closed loop replays whole requests back to back; continuous
        batching across arrivals needs the open-loop
        :class:`~repro_torch.serve.session.ServingSession`."""
        return self.cluster.register_generative(name, cfg, **kw)

    def deregister(self, tenant: TenantHandle) -> None:
        self.cluster.deregister(tenant)

    # ------------------------------------------------------------------
    def simulate(self, n_requests: int = 8, hbm_scale: float = 1.0,
                 ) -> Tuple[SimResult, List[TenantReport]]:
        """Run the multi-tenant schedule; returns per-tenant SLO report."""
        return run_closed_loop(self.cluster, n_requests=n_requests,
                               hbm_scale=hbm_scale)

    def autoscale_to_slo(self, n_requests: int = 6,
                         max_eus: int = 8) -> List[TenantReport]:
        """Grow a tenant's EU budget until its SLO holds (or cap).

        Deprecated: online sessions do this with an
        :class:`~repro_torch.serve.session.SLOAutoscaler` hook instead of
        re-running the whole batch."""
        while True:
            _, reports = self.simulate(n_requests)
            violators = [
                (t, r) for t, r in zip(self.tenants, reports)
                if r.slo_ok is False and t.eu_budget < max_eus
            ]
            if not violators:
                return reports
            for t, _ in violators:
                t.eu_budget += 2
                alloc = allocate_for_trace(t.trace, t.eu_budget, self.core)
                sram, hbm = estimate_memory(t.trace, alloc.n_me, self.core)
                t.allocation = alloc
                t.vnpu = self.manager.reconfigure(
                    t.vnpu, VNPUConfig(
                        n_me=alloc.n_me, n_ve=alloc.n_ve,
                        sram_bytes=sram, hbm_bytes=hbm,
                        priority=t.priority))
