"""Neu10: the paper's primary contribution.

vNPU abstraction (§III-A) -> allocator (§III-B) -> mapper (§III-C) ->
NeuISA μTOp compiler (§III-D) -> hardware scheduler + event-driven
simulator (§III-E/G) with the PMT / V10 / Neu10-NH baselines (§V-A).
"""
from repro_torch.core.allocator import (
    Allocation,
    allocate_eus,
    allocate_for_trace,
    eu_utilization,
    normalized_exec_time,
    optimal_ratio,
    place_phase_pair,
)
from repro_torch.core.allocator import pick_evacuation_core
from repro_torch.core.fabric import (
    FabricLink,
    FabricTopology,
    Placement,
    random_phase_pair,
)
from repro_torch.core.faults import FaultEvent, FaultSchedule
from repro_torch.core.compiler import (
    CompiledPhase,
    CompiledRequestPlan,
    ProgramCache,
    compile_neuisa,
    compile_request_plan,
    compile_vliw,
)
from repro_torch.core.mapper import VNPUManager
from repro_torch.core.stats import mean, p50, p95, p99, percentile
from repro_torch.core.neuisa import MuTOp, MuTOpGroup, NeuISAProgram, VLIWProgram
from repro_torch.core.policies import (
    SchedulerPolicy,
    UnknownPolicyError,
    available_policies,
    get_policy,
    register_policy,
    resolve_policy,
)
from repro_torch.core.simulator import (
    SimResult,
    Simulator,
    TenantSpec,
    run_collocation,
)
from repro_torch.core.vnpu import PRESETS, VNPU, VNPUConfig, VNPUState

__all__ = [
    "Allocation",
    "allocate_eus",
    "allocate_for_trace",
    "eu_utilization",
    "normalized_exec_time",
    "optimal_ratio",
    "place_phase_pair",
    "pick_evacuation_core",
    "FabricLink",
    "FaultEvent",
    "FaultSchedule",
    "FabricTopology",
    "Placement",
    "random_phase_pair",
    "CompiledPhase",
    "CompiledRequestPlan",
    "ProgramCache",
    "compile_neuisa",
    "compile_request_plan",
    "compile_vliw",
    "percentile",
    "mean",
    "p50",
    "p95",
    "p99",
    "VNPUManager",
    "MuTOp",
    "MuTOpGroup",
    "NeuISAProgram",
    "VLIWProgram",
    "SchedulerPolicy",
    "UnknownPolicyError",
    "available_policies",
    "get_policy",
    "register_policy",
    "resolve_policy",
    "SimResult",
    "Simulator",
    "TenantSpec",
    "run_collocation",
    "PRESETS",
    "VNPU",
    "VNPUConfig",
    "VNPUState",
]
