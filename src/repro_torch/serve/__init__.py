"""Serving layer of the port: the functional engine (``ServeEngine``)
and the reference's serving control plane (``session``, ``vserve``),
copied."""
from repro_torch.serve.engine import GenerationResult, ServeEngine
from repro_torch.serve.session import (
    FabricTenant,
    FaultEvent,
    FaultSchedule,
    GenLenDistribution,
    NPUCluster,
    PoissonArrivals,
    PrefixProfile,
    SLOAutoscaler,
    ServingSession,
    TenantHandle,
    TenantReport,
    TraceArrivals,
    run_closed_loop,
)
from repro_torch.serve.vserve import MultiTenantServer, Tenant

__all__ = [
    "ServeEngine",
    "FabricTenant",
    "FaultEvent",
    "FaultSchedule",
    "GenLenDistribution",
    "NPUCluster",
    "ServingSession",
    "PoissonArrivals",
    "PrefixProfile",
    "TraceArrivals",
    "SLOAutoscaler",
    "TenantHandle",
    "TenantReport",
    "run_closed_loop",
    "MultiTenantServer",
    "Tenant",
    "GenerationResult",
]
