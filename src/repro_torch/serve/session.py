"""Online multi-tenant vNPU serving control plane.

Layered request-level API over the policy-agnostic simulator:

* :class:`NPUCluster` — the resource plane: vNPU manager + pay-as-you-
  go admission (Eq. 1-4 allocator, constrained fallback, §III-B/C),
  tenant register / deregister / resize. Policy-agnostic: any
  registered :class:`~repro_torch.core.policies.SchedulerPolicy` name (or
  class) selects the mapping scheme and compiler front-end.
* :class:`ServingSession` — the request plane: an *open-loop* run on
  a pNPU cluster (one live simulator per core, lockstep-driven;
  :meth:`ServingSession.register_generative` with a ``placement``
  disaggregates prefill/decode pools across cores with priced
  cross-core KV hand-offs). Requests arrive from Poisson or
  trace-driven arrival
  processes (or one at a time via :meth:`ServingSession.submit`),
  queue per tenant, and are scheduled at μTOp granularity by the
  cluster's policy. Tenants can be registered, deregistered, and
  re-sized **mid-run** — the simulation never restarts, exercising
  ``VNPUManager.reconfigure`` dynamically. Latency is measured from
  arrival (queueing included), so the session reports true per-request
  p95 / mean / throughput.
* :class:`SLOAutoscaler` — SLO-aware autoscaling as a *hook*: after
  every ``run_until`` window the session offers each tenant's recent
  latency tail to the hook, which may grow its EU budget (a resize,
  not a restart). Operators plug in their own policy by passing any
  callable with the same signature.

Example::

    cluster = NPUCluster(policy="neu10")
    sess = ServingSession(cluster)
    llm = sess.register("llm", lm_trace(cfg, 8, 512, "prefill"), eu_budget=4)
    sess.submit_arrivals(llm, PoissonArrivals(rate_rps=80.0, n=200, seed=0))
    sess.drain()
    print(sess.report()[0].p95_ms)
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass, field, fields as _dc_fields
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.admission import (AdmissionAsk, AdmissionController,
                                  FleetState)
from repro_torch.core.allocator import (Allocation, allocate_for_trace,
                                  estimate_memory, eu_utilization,
                                  pick_evacuation_core, place_phase_pair)
from repro_torch.core.compiler import CompiledRequestPlan, ProgramCache
from repro_torch.core.fabric import FabricTopology, Placement, random_phase_pair
from repro_torch.core.faults import FaultEvent, FaultSchedule
from repro_torch.core.mapper import ReconfigureError, VNPUManager
from repro_torch.core.policies import (PolicyLike, resolve_policy,
                                 slo_violation_signal)
from repro_torch.core.simulator import (SimResult, Simulator, TenantSpec,
                                  TenantStats)
from repro_torch.core.stats import percentile
from repro_torch.core.vnpu import KVLedgerError, VNPU, VNPUConfig
from repro_torch.npu.cost_model import RequestPlan, WorkloadTrace
from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig
from repro_torch.npu.trace import lm_trace, request_plan


# ----------------------------------------------------------------------
@dataclass
class GenLenDistribution:
    """Generation-length distribution for a generative tenant: each
    injected request samples its token count (deterministically — the
    rng is seeded per (seed, stream), where the session advances the
    stream with every submission batch)."""

    mean: float = 64.0
    max_len: int = 512
    seed: int = 0
    kind: str = "geometric"      # "geometric" | "lognormal" | "fixed"

    def sample(self, n: int, stream: int = 0) -> np.ndarray:
        rng = np.random.default_rng([self.seed, stream])
        if self.kind == "fixed":
            xs = np.full(n, self.mean)
        elif self.kind == "geometric":
            xs = rng.geometric(1.0 / max(self.mean, 1.0), size=n)
        elif self.kind == "lognormal":
            sigma = 0.6
            mu = math.log(max(self.mean, 1.0)) - sigma * sigma / 2.0
            xs = rng.lognormal(mu, sigma, size=n)
        else:
            raise ValueError(f"unknown gen-length distribution {self.kind!r}")
        return np.clip(np.round(xs).astype(int), 1, self.max_len)


@dataclass
class PrefixProfile:
    """Shared-prompt profile for a generative tenant (system prompts,
    few-shot templates, RAG preambles): each injected request shares
    its leading ``prefix_len`` prompt tokens with probability
    ``share_ratio``, drawing one of ``n_prefixes`` hot prefix groups;
    the rest of the prompt is always unique. Same-key requests
    refcount ONE resident copy of the prefix KV in the tenant's ledger
    — a hit admits charging only the unshared suffix and prefills only
    the suffix positions.

    Sampling is deterministic per (seed, stream) like
    :class:`GenLenDistribution`, and monotone in ``share_ratio`` at a
    fixed seed: raising the ratio only ADDS shared arrivals (the
    uniform draw is compared against the ratio), so benchmark sweeps
    see hit sets grow, never reshuffle."""

    prefix_len: int
    share_ratio: float = 0.5
    n_prefixes: int = 1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.prefix_len <= 0:
            raise ValueError(
                f"prefix_len must be > 0 tokens, got {self.prefix_len}")
        if not 0.0 <= self.share_ratio <= 1.0:
            raise ValueError(
                f"share_ratio must be in [0, 1], got {self.share_ratio}")
        if self.n_prefixes < 1:
            raise ValueError(
                f"n_prefixes must be >= 1, got {self.n_prefixes}")

    def sample(self, n: int, stream: int = 0) -> np.ndarray:
        """Per-request prefix-group keys: 0 = unique prompt, k >= 1 =
        member of hot prefix group k."""
        rng = np.random.default_rng([self.seed, stream])
        u = rng.random(n)
        g = rng.integers(1, self.n_prefixes + 1, size=n)
        return np.where(u < self.share_ratio, g, 0).astype(int)


# ----------------------------------------------------------------------
@dataclass
class TenantHandle:
    """A registered tenant, tracked across the cluster and (when
    serving) the live simulation.

    Units: ``eu_budget`` is execution units (engines); every ``slo_*``
    field is milliseconds of simulated time; ``attached_at`` is cycles
    (simulator domain)."""

    name: str
    trace: WorkloadTrace
    eu_budget: int
    priority: float = 1.0
    slo_p95_ms: Optional[float] = None
    allocation: Optional[Allocation] = None
    vnpu: Optional[VNPU] = None
    sim_idx: int = -1            # index in the live simulator (-1: none)
    attached_at: float = 0.0     # cycles when the session attached it
    # ---- cluster fabric (multi-pNPU sessions) ----
    core_idx: int = 0            # core whose per-core simulator owns it
    core_hint: Optional[int] = None  # placement pin: resizes must stay
                                 # on this core (a live per-core sim
                                 # cannot follow a silent core hop)
    fabric_role: str = ""        # "" | "prefill" | "decode" — set when
                                 # the handle is one side of a
                                 # disaggregated FabricTenant pair
    # ---- generative tenants (phase-structured requests) ----
    plan: Optional[RequestPlan] = None
    gen_lens: Optional[GenLenDistribution] = None
    slo_ttft_ms: Optional[float] = None   # time-to-first-token SLO
    slo_tbt_ms: Optional[float] = None    # time-between-tokens SLO
    submitted: int = 0           # gen-length sampling stream cursor
    # live KV-cache accounting: "" = off (static hbm_footprint),
    # "evict" = swap-out + HBM re-read resume, "reject" = abort victims
    # back to admission (see repro_torch.core.simulator.TenantSpec)
    kv_policy: str = ""
    # registration-time HBM pin (bytes; None = footprint estimate).
    # Resizes keep honoring it — a KV-pressure-constrained allocation
    # must not silently re-inflate to the estimate on the first resize.
    hbm_bytes: Optional[int] = None
    # cross-request shared KV prefix: per-request prefix-group keys
    # sampled from this profile alongside gen_lens (None = no sharing)
    prefix_profile: Optional[PrefixProfile] = None
    # cross-tenant HBM borrowing: under pressure this tenant may
    # borrow idle segments from co-resident ledgers (whole-segment
    # grants through VNPUManager.borrow_hbm, reclaimed when the owner
    # itself hits pressure). False keeps every charge path identical.
    kv_borrow: bool = False
    # ---- deadline/retry admission (all off at the defaults) ----
    # per-attempt admission deadline: a request still WAITING this
    # many ms after (re-)admission times out and re-enters admission
    # (bounded by max_retries, exponential backoff from
    # retry_backoff_ms). Fault-aborted requests take the same path.
    deadline_ms: Optional[float] = None
    max_retries: int = 0
    retry_backoff_ms: float = 0.0
    # LRU retention window for shared prefix entries: a prefix whose
    # last holder released it stays resident this many ms (revived at
    # zero cost by the next same-key arrival; evicted FIRST under
    # pressure). 0 frees at refcount zero — bit-identical off state.
    kv_retention_ms: float = 0.0

    @property
    def generative(self) -> bool:
        return self.plan is not None


@dataclass
class TenantReport:
    """Operator-facing per-tenant report.

    Unit convention (the single documented boundary): the simulator
    domain is CYCLES (:class:`~repro_torch.core.simulator.TenantStats`);
    every ``*_ms`` field here is MILLISECONDS, converted exactly once
    in ``_tenant_report`` via ``1e3 / NPUCoreConfig.freq_hz``;
    ``throughput_rps`` is requests per SECOND of simulated time;
    ``requests_done`` / ``queued`` / ``tokens_done`` are counts. SLO
    verdicts are None when no SLO was set or no samples exist yet."""

    name: str
    n_me: int
    n_ve: int
    p95_ms: float                # e2e request latency tail (arrival->done)
    mean_ms: float
    throughput_rps: float
    slo_ok: Optional[bool]
    harvested_me_ms: float       # ME work executed on non-owned engines
    blocked_ms: float            # stall while reclaiming harvested engines
    requests_done: int = 0
    queued: int = 0              # open loop: requests admitted, not done
    # ---- phase-aware serving (single-phase tenants: TTFT == e2e
    #      latency, TBT series empty) ----
    ttft_p95_ms: float = 0.0     # time-to-first-token tail
    tbt_p95_ms: float = 0.0      # time-between-tokens tail
    tokens_done: int = 0
    slo_ttft_ok: Optional[bool] = None
    slo_tbt_ok: Optional[bool] = None
    # ---- live KV-cache pressure (zero without a kv_policy) ----
    kv_evictions: int = 0        # requests that lost their KV segments
    kv_swapins: int = 0          # eviction round-trips completed
    kv_peak_segments: int = 0    # peak HBM isolation segments occupied
    # request-loss accounting: an operator must be able to tell
    # "still in flight" from "the ledger dropped it"
    kv_rejected: int = 0         # admission-rejected (prompt can never fit)
    kv_restarts: int = 0         # reject-policy victims re-queued from 0
    kv_truncated: int = 0        # force-finished (single-request OOM)
    # ---- cross-core fabric migration (zero off-fabric) ----
    kv_migrations: int = 0       # prefill->decode hand-offs to another core
    kv_migrated_bytes: float = 0.0  # KV bytes moved over inter-core links
    cross_core_hops: int = 0     # cumulative fabric hops those moves took
    kv_migration_rejects: int = 0  # hand-offs refused on destination
                                 # pressure (decoded locally instead)
    # ---- cross-request shared KV prefix (zero with sharing off) ----
    kv_prefix_hits: int = 0      # admissions that found the prefix resident
    kv_shared_bytes: float = 0.0  # prefix bytes those hits did not re-charge
    # ---- cross-tenant HBM borrowing (zero with borrowing off) ----
    kv_borrowed_bytes: float = 0.0  # bytes granted from idle peer segments
    kv_reclaimed_bytes: float = 0.0  # lent bytes pulled back under pressure
    # ---- fault injection / failover (all zero with faults off) ----
    faults_survived: int = 0     # injected faults ridden out in place
    evacuations: int = 0         # whole-vNPU migrations off a failed core
    evacuated_bytes: float = 0.0  # live KV bytes those evacuations moved
    hbm_fault_segments: int = 0  # HBM segments lost to segment faults
    deadline_misses: int = 0     # admission-queue timeouts
    retries: int = 0             # re-admissions scheduled (distinct
                                 # from kv_restarts)
    retry_successes: int = 0     # retried requests that completed
    retries_exhausted: int = 0   # dropped after the last retry failed
    downtime_ms: float = 0.0     # time frozen by faults (transfers,
                                 # suspend-until-recovery gaps)
    availability: float = 1.0    # 1 - downtime / attached lifetime
    # ---- credit admission (zero with the gate off) ----
    credit: float = 0.0          # rolled-forward account balance
    admission_deferrals: int = 0  # times the gate deferred this tenant


# ----------------------------------------------------------------------
# arrival processes (open loop)
# ----------------------------------------------------------------------
@dataclass
class PoissonArrivals:
    """Memoryless open-loop arrivals: ``n`` requests at ``rate_rps``
    requests/second from ``start_s``, seeded for determinism."""

    rate_rps: float
    n: int
    seed: int = 0
    start_s: float = 0.0

    def times_s(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1.0 / self.rate_rps, size=self.n)
        return self.start_s + np.cumsum(gaps)


@dataclass
class TraceArrivals:
    """Trace-driven arrivals: explicit request timestamps (seconds),
    e.g. replayed from production logs."""

    times: Sequence[float]

    def times_s(self) -> np.ndarray:
        return np.asarray(sorted(self.times), dtype=float)


ArrivalProcess = object  # anything with .times_s() -> seconds array


# ----------------------------------------------------------------------
class NPUCluster:
    """Resource plane: admission control + vNPU placement for one or
    more pNPUs, under a pluggable scheduler policy."""

    def __init__(self, core: NPUCoreConfig = DEFAULT_CORE,
                 n_pnpus: int = 1, policy: PolicyLike = "neu10",
                 topology: Optional[FabricTopology] = None):
        """``topology`` wires the pNPUs into a cluster fabric
        (:class:`~repro_torch.core.fabric.FabricTopology`): it fixes the
        core count and prices every cross-core KV hand-off. Default:
        a single core, or — for ``n_pnpus > 1`` with no explicit
        fabric — a fully-connected one-hop fabric (the degenerate
        pre-fabric behavior)."""
        self.policy_cls = type(resolve_policy(policy))
        self.core = core
        if topology is not None:
            if n_pnpus not in (1, topology.n_cores):
                raise ValueError(
                    f"n_pnpus={n_pnpus} contradicts the "
                    f"{topology.n_cores}-core topology")
            n_pnpus = topology.n_cores
        elif n_pnpus == 1:
            topology = FabricTopology.single()
        else:
            topology = FabricTopology.fully_connected(n_pnpus)
        self.topology = topology
        self.manager = VNPUManager(n_pnpus=n_pnpus, core=core)
        self.tenants: List[TenantHandle] = []
        # per-(phase, context-bucket) compiled programs, shared across
        # every tenant of this cluster (§III-D)
        self.programs = ProgramCache()

    @property
    def policy_name(self) -> str:
        """Registry name of the cluster's scheduler policy."""
        return self.policy_cls.name or self.policy_cls.__name__

    @property
    def mapping(self) -> str:
        """vNPU mapping scheme the policy implies: ``"spatial"``
        (engines owned per tenant) or ``"temporal"`` (shared)."""
        return "spatial" if self.policy_cls.spatial else "temporal"

    def compile(self, trace: WorkloadTrace):
        """Compile a trace into the program form the policy schedules
        (NeuISA μTOp groups or whole VLIW operators)."""
        return self.policy_cls.compile_program(trace, self.core)

    def compile_plan(self, plan: RequestPlan) -> CompiledRequestPlan:
        """Compile a phase-structured request plan through the shared
        program cache — decode programs at context 512/1k/2k/... are
        built once per model shape, however many tenants serve it."""
        return self.policy_cls.compile_plan(plan, self.core,
                                            cache=self.programs)

    # ------------------------------------------------------------------
    def register(self, name: str, trace: WorkloadTrace, eu_budget: int,
                 priority: float = 1.0,
                 slo_p95_ms: Optional[float] = None,
                 plan: Optional[RequestPlan] = None,
                 gen_lens: Optional[GenLenDistribution] = None,
                 slo_ttft_ms: Optional[float] = None,
                 slo_tbt_ms: Optional[float] = None,
                 kv_policy: Optional[str] = None,
                 hbm_bytes: Optional[int] = None,
                 core_hint: Optional[int] = None,
                 prefix_profile: Optional[PrefixProfile] = None,
                 kv_borrow: bool = False,
                 deadline_ms: Optional[float] = None,
                 max_retries: int = 0,
                 retry_backoff_ms: float = 0.0,
                 kv_retention_ms: float = 0.0) -> TenantHandle:
        """Pay-as-you-go entry point: the tenant buys `eu_budget` EUs;
        the allocator picks the ME/VE split from the compile-time
        profile (§III-B). Generative tenants pass ``plan`` (the trace
        argument should then be the plan's profile trace).

        ``hbm_bytes`` pins the vNPU's HBM allocation (bytes, rounded
        up to isolation segments) instead of the footprint estimate —
        the knob the KV-pressure benchmarks sweep. ``kv_policy``
        (``"evict"`` | ``"reject"``) turns on live KV-cache
        accounting against that allocation: the plan's weights are
        reserved up front and every request's KV is charged to the
        vNPU's :class:`~repro_torch.core.vnpu.KVLedger` as it runs.

        ``core_hint`` pins placement (and every later resize) to one
        core index — the fabric control plane's topology-aware
        choice.

        ``prefix_profile`` (requires ``kv_policy`` and a plan built
        with a matching ``prefix_len``) samples per-request shared-
        prefix keys: same-key requests refcount one resident copy of
        the prefix KV and admit charging only the unshared suffix.
        ``kv_borrow`` lets the tenant borrow idle HBM segments from
        co-resident ledgers under pressure (reclaimed whole when the
        owner needs them back).

        ``deadline_ms`` sets a per-attempt admission deadline from the
        tenant's SLO: a request still waiting that long times out and
        re-enters admission up to ``max_retries`` times with
        exponential backoff from ``retry_backoff_ms`` (fault-aborted
        requests take the same path; retries are counted separately
        from ``kv_restarts``). ``kv_retention_ms`` keeps a shared
        prefix entry resident that long after its LAST holder releases
        it — the next same-key arrival revives it at zero fill cost,
        and retained entries are the FIRST eviction victims under
        pressure."""
        if kv_policy and (plan is None or plan.kv_token_bytes <= 0):
            raise ValueError(
                f"kv_policy={kv_policy!r} needs a generative plan with "
                f"per-token KV bytes (attention-family request_plan); "
                f"tenant {name!r} has none")
        if prefix_profile is not None:
            if not kv_policy:
                raise ValueError(
                    f"tenant {name!r}: prefix_profile needs live KV "
                    f"accounting (set kv_policy='evict' or 'reject') — "
                    f"prefix sharing is a ledger feature")
            if plan is None or plan.prefix_len <= 0 \
                    or plan.prefix_builder is None:
                raise ValueError(
                    f"tenant {name!r}: prefix_profile needs a plan built "
                    f"with prefix_len > 0 (request_plan(prefix_len=...) "
                    f"or register_generative(prefix_profile=...))")
            if plan.prefix_len != prefix_profile.prefix_len:
                raise ValueError(
                    f"tenant {name!r}: profile prefix_len="
                    f"{prefix_profile.prefix_len} does not match the "
                    f"plan's prefix_len={plan.prefix_len}")
        if kv_borrow and not kv_policy:
            raise ValueError(
                f"tenant {name!r}: kv_borrow needs live KV accounting "
                f"(set kv_policy='evict' or 'reject')")
        if (deadline_ms is not None or max_retries) and plan is None:
            raise ValueError(
                f"tenant {name!r}: deadline/retry admission needs a "
                f"generative plan (register_generative)")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"tenant {name!r}: deadline_ms must be > 0, "
                f"got {deadline_ms}")
        if max_retries < 0 or retry_backoff_ms < 0:
            raise ValueError(
                f"tenant {name!r}: max_retries and retry_backoff_ms "
                f"must be >= 0")
        if kv_retention_ms < 0:
            raise ValueError(
                f"tenant {name!r}: kv_retention_ms must be >= 0, "
                f"got {kv_retention_ms}")
        if kv_retention_ms and prefix_profile is None:
            raise ValueError(
                f"tenant {name!r}: kv_retention_ms retains shared "
                f"prefix entries — it needs a prefix_profile")
        alloc = allocate_for_trace(trace, eu_budget, self.core)
        sram, hbm = estimate_memory(trace, alloc.n_me, self.core)
        if hbm_bytes is not None:
            hbm = int(hbm_bytes)
        try:
            vnpu = self.manager.create(
                VNPUConfig(n_me=alloc.n_me, n_ve=alloc.n_ve,
                           sram_bytes=sram, hbm_bytes=hbm,
                           priority=priority),
                name=name, mapping=self.mapping, core_hint=core_hint)
        except RuntimeError:
            # admission control: the unconstrained Eq.-4 pick doesn't
            # fit next to existing tenants — re-allocate over the
            # FEASIBLE splits, still maximizing Eq. 2. Harvesting
            # recovers most of the gap at runtime (§III-B).
            alloc, vnpu = self._constrained_register(
                trace, alloc, eu_budget, priority, name,
                hbm_override=hbm_bytes, core_hint=core_hint)
        if kv_policy:
            # weights are resident for the tenant's lifetime; the
            # remainder of the segment allocation is the KV budget
            weights = int(plan.weight_bytes)
            if weights >= vnpu.kv_ledger.capacity:
                self.manager.destroy(vnpu)
                raise ValueError(
                    f"tenant {name!r}: resident weights ({weights} B) fill "
                    f"the {vnpu.kv_ledger.capacity} B HBM allocation — no "
                    f"KV budget left; raise hbm_bytes")
            vnpu.kv_ledger.reserve(weights)
        h = TenantHandle(name=name, trace=trace, eu_budget=eu_budget,
                         priority=priority, slo_p95_ms=slo_p95_ms,
                         allocation=alloc, vnpu=vnpu, plan=plan,
                         gen_lens=gen_lens, slo_ttft_ms=slo_ttft_ms,
                         slo_tbt_ms=slo_tbt_ms,
                         kv_policy=kv_policy or "",
                         hbm_bytes=(int(hbm_bytes)
                                    if hbm_bytes is not None else None),
                         core_hint=core_hint,
                         prefix_profile=prefix_profile,
                         kv_borrow=bool(kv_borrow),
                         deadline_ms=deadline_ms,
                         max_retries=int(max_retries),
                         retry_backoff_ms=float(retry_backoff_ms),
                         kv_retention_ms=float(kv_retention_ms))
        self.tenants.append(h)
        return h

    def register_generative(
        self, name: str, cfg: ModelConfig,
        prompt_len: int = 512,
        gen_lens: Union[int, GenLenDistribution] = 64,
        batch: int = 1, eu_budget: int = 4,
        bucket: int = 512, prefill_chunk_tokens: int = 0,
        iteration_token_budget: int = 0,
        prefix_profile: Optional[PrefixProfile] = None, **kw,
    ) -> TenantHandle:
        """Register an LLM serving tenant with a phase-structured
        request lifecycle: prefill over ``prompt_len`` tokens, then a
        generation-length-distributed decode chain with context-
        bucketed cost. ``gen_lens`` is either a fixed token count or a
        :class:`GenLenDistribution` sampled per request. The allocator
        profile reflects the full prefill+decode cycle mix.

        ``prefill_chunk_tokens`` > 0 chunks the prefill (SARATHI
        style): prompts longer than one chunk run as a chain of chunk
        phases, and the tenant's in-flight decode iterations
        interleave between its own chunks instead of waiting out the
        whole prompt. 0 (the default) keeps monolithic prefill —
        scheduling is then bit-identical to the pre-chunking engine.

        ``iteration_token_budget`` > 0 *replaces* the static chunk
        knob (the two are mutually exclusive) with SARATHI-SF
        piggybacked iterations: each iteration fuses a prefill slice
        of ``budget - live decode batch`` tokens with the tenant's
        decode tokens into ONE program, so decoding requests keep
        their token cadence through a neighbor request's prefill. The
        knob stays adjustable live
        (:meth:`ServingSession.set_iteration_token_budget`) — an
        autoscale hook can trade TBT against TTFT mid-run without
        re-registering.

        ``kv_policy="evict"`` (or ``"reject"``) plus an optional
        ``hbm_bytes`` pin — both forwarded to :meth:`register` — turn
        on live KV-cache accounting: decode context growth consumes
        the tenant's HBM segments as it happens, and under pressure a
        PREMA-style victim is swapped out (resumed via an HBM
        re-read) or aborted back to admission.

        ``prefix_profile`` (requires a ``kv_policy``) turns on
        cross-request shared-prefix KV: the plan grows a suffix-only
        prefill path over the profile's ``prefix_len`` leading tokens,
        and arrivals sample prefix-group keys — same-key requests
        refcount one resident copy of the prefix KV, so a hit admits
        charging (and prefilling) only the unshared suffix.

        Units: ``prompt_len`` / ``gen_lens`` / ``bucket`` /
        ``prefill_chunk_tokens`` / ``iteration_token_budget`` are
        token counts; ``eu_budget`` is execution units (ME+VE
        engines); ``hbm_bytes`` is bytes."""
        if isinstance(gen_lens, GenLenDistribution):
            dist: Optional[GenLenDistribution] = gen_lens
            gen_len = max(int(round(gen_lens.mean)), 1)
            max_gen = gen_lens.max_len
        else:
            dist = None
            gen_len = max(int(gen_lens), 1)
            max_gen = gen_len
        plan = request_plan(cfg, batch, prompt_len, gen_len,
                            core=self.core, max_gen=max_gen, bucket=bucket,
                            prefill_chunk_tokens=prefill_chunk_tokens,
                            iteration_token_budget=iteration_token_budget,
                            prefix_len=(prefix_profile.prefix_len
                                        if prefix_profile is not None
                                        else 0))
        return self.register(name, plan.profile_trace(), eu_budget,
                             plan=plan, gen_lens=dist,
                             prefix_profile=prefix_profile, **kw)

    def _constrained_register(self, trace, alloc, eu_budget, priority,
                              name, hbm_override: Optional[int] = None,
                              core_hint: Optional[int] = None,
                              ) -> Tuple[Allocation, VNPU]:
        cores = (self.manager.cores if core_hint is None
                 else [self.manager.cores[core_hint]])
        feasible = set()
        for cs in cores:
            free_me, free_ve = len(cs.free_mes), len(cs.free_ves)
            for n_me in range(1, free_me + 1):
                for n_ve in range(1, free_ve + 1):
                    if n_me + n_ve <= eu_budget:
                        feasible.add((n_me, n_ve))
        if not feasible:
            raise RuntimeError(
                f"admission denied for {name}: no free EUs on any pNPU")
        # deterministic: Eq.-2 utilization first, then the larger
        # (n_me, n_ve) tuple — never set iteration order
        n_me, n_ve = max(
            feasible,
            key=lambda s: (eu_utilization(alloc.m, alloc.v, *s), s))
        sram, hbm = estimate_memory(trace, n_me, self.core)
        if hbm_override is not None:
            hbm = int(hbm_override)
        # cap the memory ask to what remains (§III-B: oversized models
        # fall back to tensor swapping / multi-vNPU allocation)
        free_hbm = max(len(cs.free_hbm_segs) for cs in cores)
        free_sram = max(len(cs.free_sram_segs) for cs in cores)
        hbm = min(hbm, free_hbm * self.core.hbm_segment)
        sram = min(sram, free_sram * self.core.sram_segment)
        vnpu = self.manager.create(
            VNPUConfig(n_me=n_me, n_ve=n_ve, sram_bytes=sram,
                       hbm_bytes=hbm, priority=priority),
            name=name, mapping=self.mapping, core_hint=core_hint)
        new_alloc = Allocation(
            n_me, n_ve, eu_utilization(alloc.m, alloc.v, n_me, n_ve),
            alloc.k_star, alloc.m, alloc.v)
        return new_alloc, vnpu

    def register_model(self, cfg: ModelConfig, phase: str = "prefill",
                       batch: int = 8, seq: int = 512, eu_budget: int = 4,
                       **kw) -> TenantHandle:
        """Register a fixed-phase tenant from a model config: one
        ``lm_trace`` replayed per request (no decode chain). ``seq``
        is tokens; ``eu_budget`` is execution units."""
        trace = lm_trace(cfg, batch, seq, phase, self.core)
        return self.register(cfg.name, trace, eu_budget, **kw)

    def register_vnpu(self, name: str, trace: WorkloadTrace,
                      config: VNPUConfig) -> TenantHandle:
        """Register with an explicit vNPU shape (bypasses the
        allocator — benchmark/§V-A setups with fixed splits)."""
        vnpu = self.manager.create(config, name=name, mapping=self.mapping)
        h = TenantHandle(name=name, trace=trace,
                         eu_budget=config.n_eus, priority=config.priority,
                         allocation=None, vnpu=vnpu)
        self.tenants.append(h)
        return h

    def deregister(self, handle: TenantHandle) -> None:
        """Destroy the tenant's vNPU (engines + memory segments free
        immediately) and drop it from the cluster roster."""
        if handle.vnpu is not None:
            self.manager.destroy(handle.vnpu)
        self.tenants.remove(handle)

    def resize(self, handle: TenantHandle, eu_budget: int) -> TenantHandle:
        """Grow/shrink a tenant's EU budget: re-run the allocator and
        reconfigure its vNPU in place.

        If the unconstrained Eq.-4 split doesn't fit next to the
        neighbors, fall back to the best FEASIBLE split over the free
        EUs plus the ones the tenant already holds (same admission
        logic as register). Only when no feasible split beats the
        current shape does :class:`ReconfigureError` propagate — the
        handle stays valid (old mapping restored) either way.

        KV-accounted tenants: the HBM ask is floored at the ledger's
        LIVE occupancy (weights + resident KV), so a shrink can never
        pull segments out from under in-flight requests — a resize
        that cannot hold them is rejected with
        :class:`ReconfigureError` (the vNPU manager re-checks when
        migrating the ledger; evict or drain first)."""
        alloc = allocate_for_trace(handle.trace, eu_budget, self.core)
        sram, hbm = estimate_memory(handle.trace, alloc.n_me, self.core)
        if handle.hbm_bytes is not None:
            hbm = handle.hbm_bytes   # keep the registration-time pin
        hbm = max(hbm, self._kv_floor(handle))
        try:
            handle.vnpu = self.manager.reconfigure(
                handle.vnpu, VNPUConfig(
                    n_me=alloc.n_me, n_ve=alloc.n_ve,
                    sram_bytes=sram, hbm_bytes=hbm,
                    priority=handle.priority),
                core_hint=handle.core_hint)
        except ReconfigureError as exc:
            handle.vnpu = exc.restored
            alloc = self._constrained_resize(handle, eu_budget, alloc, exc)
        handle.eu_budget = eu_budget
        handle.allocation = alloc
        return handle

    def _kv_floor(self, handle: TenantHandle) -> int:
        """Bytes a resize of ``handle`` must keep: the live ledger
        occupancy (reserved weights + in-flight KV + refcounted shared
        prefix segments + bytes lent to co-residents), segment-
        rounded. 0 for tenants without KV accounting.

        Using ``KVLedger.occupancy`` (not ``reserved + in_use``) is
        load-bearing: a shrink computed from per-request KV alone
        would strand live shared-prefix entries — and segments a
        borrower's KV currently lives in — outside the new
        allocation."""
        v = handle.vnpu
        if not handle.kv_policy or v is None or v.kv_ledger is None:
            return 0
        led = v.kv_ledger
        seg = self.core.hbm_segment
        return -(-led.occupancy // seg) * seg

    def _constrained_resize(self, handle: TenantHandle, eu_budget: int,
                            alloc: Allocation,
                            exc: ReconfigureError) -> Allocation:
        cs = self.manager._core_of(handle.vnpu)
        cur = handle.vnpu.config
        # temporal mappings don't own engines exclusively, so the free
        # list stays at core width — cap free+held at the physical core
        avail_me = min(len(cs.free_mes) + cur.n_me if cs else cur.n_me,
                       self.core.n_me)
        avail_ve = min(len(cs.free_ves) + cur.n_ve if cs else cur.n_ve,
                       self.core.n_ve)
        feasible = {
            (n_me, n_ve)
            for n_me in range(1, avail_me + 1)
            for n_ve in range(1, avail_ve + 1)
            if n_me + n_ve <= eu_budget
        }
        feasible.discard((cur.n_me, cur.n_ve))
        # Eq.-2 utilization is only comparable at a fixed EU total
        # (fewer EUs always look "efficient"), so rank by total EUs
        # first — a resize exists to change capacity — then Eq. 2
        rank = lambda s: (s[0] + s[1],
                          eu_utilization(alloc.m, alloc.v, *s), s)
        best = max(feasible, key=rank, default=None)
        if best is None or rank(best) <= rank((cur.n_me, cur.n_ve)):
            raise exc  # nothing feasible beats the current shape
        n_me, n_ve = best
        sram, hbm = estimate_memory(handle.trace, n_me, self.core)
        if handle.hbm_bytes is not None:
            hbm = handle.hbm_bytes   # keep the registration-time pin
        kv_floor = self._kv_floor(handle)
        hbm = max(hbm, kv_floor)
        if cs is not None and handle.vnpu.segments is not None:
            held_s = len(handle.vnpu.segments.sram_segments)
            held_h = len(handle.vnpu.segments.hbm_segments)
            sram = min(sram,
                       (len(cs.free_sram_segs) + held_s) * self.core.sram_segment)
            hbm = min(hbm,
                      (len(cs.free_hbm_segs) + held_h) * self.core.hbm_segment)
        if hbm < kv_floor:
            # the feasible segments cannot hold the live KV occupancy:
            # reject rather than shrink resident state out from under
            # in-flight requests (the ledger-migration check in
            # VNPUManager.reconfigure guarantees this invariant even
            # for callers that skip the session layer)
            raise exc
        handle.vnpu = self.manager.reconfigure(
            handle.vnpu, VNPUConfig(n_me=n_me, n_ve=n_ve,
                                    sram_bytes=sram, hbm_bytes=hbm,
                                    priority=handle.priority),
            core_hint=handle.core_hint)
        return Allocation(
            n_me, n_ve, eu_utilization(alloc.m, alloc.v, n_me, n_ve),
            alloc.k_star, alloc.m, alloc.v)


# ----------------------------------------------------------------------
# closed-loop helper (paper figures, legacy MultiTenantServer)
# ----------------------------------------------------------------------
def build_closed_loop_specs(cluster: NPUCluster,
                            n_requests: int = 8) -> List[TenantSpec]:
    """Compile every registered tenant into the :class:`TenantSpec`
    list a closed-loop :class:`Simulator` consumes. Split out of
    :func:`run_closed_loop` so benchmark A/B rows can compile once and
    time only ``Simulator(...).run()`` (specs are read-only to the
    simulator — safe to reuse across runs)."""
    specs = []
    for h in cluster.tenants:
        if h.plan is not None:
            cplan = cluster.compile_plan(h.plan)
            specs.append(TenantSpec(cplan.prefill.program, h.vnpu,
                                    n_requests, weight=h.priority,
                                    plan=cplan, kv_policy=h.kv_policy))
        else:
            specs.append(TenantSpec(cluster.compile(h.trace), h.vnpu,
                                    n_requests, weight=h.priority))
    return specs


def run_closed_loop(cluster: NPUCluster, n_requests: int = 8,
                    hbm_scale: float = 1.0, fast_path: bool = True,
                    incremental: bool = True,
                    ) -> Tuple[SimResult, List[TenantReport]]:
    """Batch-mode run: every registered tenant replays its program
    ``n_requests`` times back to back (the paper's §V-A methodology).
    Generative tenants replay their full phase chain (prefill + the
    default generation length of decode steps) per request.
    ``fast_path=False`` selects the simulator's reference
    implementations (result-identical; see :class:`Simulator`) — the
    fig25 fast-path benchmark row uses it for its A/B proof;
    ``incremental=False`` likewise disables the dirty-set scheduling
    core (the ``sched_incremental`` row's baseline)."""
    specs = build_closed_loop_specs(cluster, n_requests)
    res = Simulator(specs, policy=cluster.policy_cls, core=cluster.core,
                    hbm_scale=hbm_scale, fast_path=fast_path,
                    incremental=incremental).run()
    return res, reports_from_result(cluster.tenants, res, cluster.core)


def reports_from_result(tenants: Sequence[TenantHandle], res: SimResult,
                        core: NPUCoreConfig) -> List[TenantReport]:
    ms = 1e3 / core.freq_hz
    return [
        _tenant_report(h, res.tenants[i], ms, res.throughput(i))
        for i, h in enumerate(tenants)
    ]


def _tenant_report(h: TenantHandle, st, ms: float,
                   throughput_rps: float, queued: int = 0,
                   elapsed_cycles: float = 0.0) -> TenantReport:
    """One TenantReport from a handle + its simulator stats — the
    single place where cycles become milliseconds (``ms`` is the
    cycles->ms factor, ``1e3 / freq_hz``) and where SLO verdicts
    (e2e / TTFT / TBT) are computed, shared by the open- and
    closed-loop reporters. Every latency series in ``st`` is in
    cycles; every latency field emitted here is in ms."""
    p95 = st.p95() * ms
    ttft_p95 = st.ttft_p95() * ms
    tbt_p95 = st.tbt_p95() * ms
    return TenantReport(
        name=h.name,
        n_me=h.vnpu.config.n_me,
        n_ve=h.vnpu.config.n_ve,
        p95_ms=p95,
        mean_ms=st.mean() * ms,
        throughput_rps=throughput_rps,
        # an SLO verdict needs samples: a tenant with zero completions
        # must report None, not a vacuous pass on p95 == 0.0
        slo_ok=((p95 <= h.slo_p95_ms)
                if h.slo_p95_ms and st.latencies else None),
        harvested_me_ms=st.harvested_me_work * ms,
        blocked_ms=st.reclaim_blocked * ms,
        requests_done=st.requests_done,
        queued=queued,
        ttft_p95_ms=ttft_p95,
        tbt_p95_ms=tbt_p95,
        tokens_done=st.tokens,
        slo_ttft_ok=((ttft_p95 <= h.slo_ttft_ms)
                     if h.slo_ttft_ms and st.ttft else None),
        slo_tbt_ok=((tbt_p95 <= h.slo_tbt_ms)
                    if h.slo_tbt_ms and st.tbt else None),
        kv_evictions=st.kv_evictions,
        kv_swapins=st.kv_swapins,
        kv_peak_segments=st.kv_peak_segments,
        kv_rejected=st.kv_rejected,
        kv_restarts=st.kv_restarts,
        kv_truncated=st.kv_truncated,
        kv_migrations=st.kv_migrations,
        kv_migrated_bytes=st.kv_migrated_bytes,
        cross_core_hops=st.cross_core_hops,
        kv_migration_rejects=st.kv_migration_rejects,
        kv_prefix_hits=st.kv_prefix_hits,
        kv_shared_bytes=st.kv_shared_bytes,
        kv_borrowed_bytes=st.kv_borrowed_bytes,
        kv_reclaimed_bytes=st.kv_reclaimed_bytes,
        faults_survived=st.faults_survived,
        evacuations=st.evacuations,
        evacuated_bytes=st.evacuated_bytes,
        hbm_fault_segments=st.hbm_fault_segments,
        deadline_misses=st.deadline_misses,
        retries=st.retries,
        retry_successes=st.retry_successes,
        retries_exhausted=st.retries_exhausted,
        downtime_ms=st.downtime_cycles * ms,
        availability=(max(0.0, 1.0 - st.downtime_cycles / elapsed_cycles)
                      if elapsed_cycles > 0 else 1.0),
    )


# ----------------------------------------------------------------------
@dataclass
class FabricTenant:
    """A disaggregated generative tenant on the cluster fabric: a
    prefill pool and a decode pool, each its own :class:`TenantHandle`
    on its own core, joined by the priced cross-core KV hand-off
    (:meth:`ServingSession.register_generative` with ``placement=``).
    ``in_transit`` counts hand-offs currently on the wire (charged to
    the destination ledger, not yet landed in its decode batch)."""

    name: str
    prefill: TenantHandle
    decode: TenantHandle
    prefill_core: int
    decode_core: int
    hops: int                    # fabric hops each hand-off traverses
    in_transit: int = 0


@dataclass
class AdmissionTicket:
    """A registration the credit gate DEFERRED: the ask parks in the
    session's re-admission queue and is retried after every
    ``run_until`` window as the tenant's credit recovers (and the
    fleet's pressure drops). ``handle`` is set the moment the tenant
    is actually admitted; arrivals submitted against a still-deferred
    ticket queue in ``pending_arrivals`` and are injected at
    admission time with their ORIGINAL timestamps, so end-to-end
    latency spans the deferral."""

    name: str
    kind: str                    # "plain" | "model" | "generative"
    ask: AdmissionAsk
    args: tuple
    kwargs: dict
    deferrals: int = 0
    handle: Union[TenantHandle, FabricTenant, None] = None
    pending_arrivals: List[object] = field(default_factory=list)

    @property
    def admitted(self) -> bool:
        return self.handle is not None


# ----------------------------------------------------------------------
class SLOAutoscaler:
    """SLO-aware autoscaling as a session hook (replaces the ad-hoc
    ``autoscale_to_slo`` loop): after each window, if a tenant's
    recent p95 violates its SLO, grow its EU budget by ``step_eus``
    up to ``max_eus``. Returns the new budget, or None to hold.

    Fabric phase pairs are judged PER CORE through
    :meth:`decide_phase`: a TTFT violation grows the prefill-side
    vNPU on the prefill core, a TBT violation the decode-side one —
    never the wrong pool on the wrong core."""

    def __init__(self, step_eus: int = 2, max_eus: int = 8,
                 window: int = 16, min_samples: int = 4):
        # window bounds the p95 sample to the newest completions, so a
        # long-recovered spike can't keep triggering growth
        self.step_eus = step_eus
        self.max_eus = max_eus
        self.window = window
        self.min_samples = min_samples

    def __call__(self, session: "ServingSession", handle: TenantHandle,
                 recent_latency_ms: Sequence[float]) -> Optional[int]:
        if handle.slo_p95_ms is None or handle.eu_budget >= self.max_eus:
            return None
        if len(recent_latency_ms) < self.min_samples:
            return None
        if percentile(recent_latency_ms[-self.window:],
                      0.95) <= handle.slo_p95_ms:
            return None
        return min(handle.eu_budget + self.step_eus, self.max_eus)

    def decide_phase(self, session: "ServingSession", handle: TenantHandle,
                     recent_ms: Sequence[float],
                     slo_ms: Optional[float]) -> Optional[int]:
        """Per-phase variant for fabric pairs: judge ``recent_ms``
        (TTFT samples for a prefill pool, TBT samples for a decode
        pool) against that phase's own SLO, growing only ``handle`` —
        the vNPU on the violating core."""
        if slo_ms is None or handle.eu_budget >= self.max_eus:
            return None
        if len(recent_ms) < self.min_samples:
            return None
        if percentile(recent_ms[-self.window:], 0.95) <= slo_ms:
            return None
        return min(handle.eu_budget + self.step_eus, self.max_eus)


AutoscaleHook = Callable[["ServingSession", TenantHandle, Sequence[float]],
                         Optional[int]]


@dataclass
class _Suspended:
    """A tenant frozen by a core fault it could not evacuate from
    (``failover="restart"``, or no healthy destination): its vNPU is
    destroyed, every in-flight attempt was fault-aborted through the
    retry path, and the pieces needed to rebuild it — config, stats,
    rid counter, pending heap events — park here until the home core
    recovers (``core_up``)."""

    handle: TenantHandle
    cfg: VNPUConfig
    stats: TenantStats
    rid: object                  # the runtime's itertools.count cursor
    events: List[Tuple[float, str, object]]
    core: int                    # home core (resume target)
    since: float                 # cycles when the fault froze it
    attached_at: float           # original attach time (throughput)
    weights: int = 0             # reserved weight bytes to re-pin


# ----------------------------------------------------------------------
class ServingSession:
    """Request plane: an open-loop serving run on a pNPU cluster.

    The session owns ONE live :class:`Simulator` per physical core,
    driven in lockstep by a cluster-level scheduler (:meth:`_advance`:
    always advance the globally-earliest core, so a cross-core
    hand-off can never land in another core's past). Requests are
    injected at arrival timestamps and the simulation advances with
    :meth:`run_until` / :meth:`drain`. Between advances, tenants can
    be registered, deregistered, and re-sized without restarting —
    in-flight work continues. A single-core cluster drives its one
    simulator directly (bit-identical to the pre-fabric engine).

    Disaggregated serving: :meth:`register_generative` with a
    :class:`~repro_torch.core.fabric.Placement` splits a generative tenant
    into a prefill pool and a decode pool on (topology-aware) separate
    cores; every finished prefill hands its request — and its live KV
    bytes — to the decode core over the priced fabric link."""

    def __init__(self, cluster: NPUCluster, hbm_scale: float = 1.0,
                 fair_slice: float = 50_000.0,
                 autoscaler: Optional[AutoscaleHook] = None,
                 incremental: bool = True,
                 faults: Optional[FaultSchedule] = None,
                 failover: str = "evacuate",
                 admission: Optional[AdmissionController] = None):
        """``faults`` injects a deterministic
        :class:`~repro_torch.core.faults.FaultSchedule` into the run (event
        times and recovery windows in SECONDS, the session's API
        domain): core failures, per-link bandwidth degradation or
        outage, and HBM segment faults fire interleaved with the
        simulation at their scheduled instants. ``failover`` picks the
        core-fault response: ``"evacuate"`` migrates each resident
        vNPU whole — live KV, pending events, queue state — to the
        best surviving core over the priced fabric (falling back to
        suspend when no destination fits); ``"restart"`` is the
        kill-and-restart baseline — every in-flight request is
        fault-aborted into the deadline/retry path and the tenant
        rebuilds from scratch when its core recovers. With ``faults``
        left None every run is bit-identical to the fault-free
        engine.

        ``admission`` installs the fleet-scale credit gate
        (:class:`~repro_torch.core.admission.AdmissionController`):
        :meth:`register` / :meth:`register_generative` then consult
        it BEFORE placing a vNPU — a low-credit ask under fleet
        pressure is down-sized or deferred (returned as an
        :class:`AdmissionTicket` and retried from the re-admission
        queue after every ``run_until`` window), live TTFT/TBT
        violations debit tenant accounts, and autoscale grows pass
        the same gate. Left None (the default), every registration
        path is bit-identical to the ungated engine."""
        if failover not in ("evacuate", "restart"):
            raise ValueError(
                f"unknown failover policy {failover!r}; "
                f"use 'evacuate' or 'restart'")
        self.cluster = cluster
        self.autoscaler = autoscaler
        self.failover = failover
        self.faults = faults
        self._fseq = itertools.count()
        # fault events in CYCLES, heap-ordered; transient core faults
        # push their own core_up at fire time
        self._fault_q: List[Tuple[float, int, FaultEvent]] = []
        if faults is not None:
            for ev in faults:
                heapq.heappush(self._fault_q,
                               (self._cycles(ev.at), next(self._fseq), ev))
        self._suspended: List[_Suspended] = []
        self.sims: List[Simulator] = [
            Simulator((), policy=cluster.policy_cls, core=cluster.core,
                      hbm_scale=hbm_scale, fair_slice=fair_slice,
                      incremental=incremental)
            for _ in cluster.manager.cores
        ]
        self.sim = self.sims[0]   # single-core back-compat alias
        self.fabric_tenants: List[FabricTenant] = []
        # core indices whose event horizon a cross-core hand-off just
        # pulled EARLIER — the cluster event heap in _advance must
        # re-key them before its next pop (see _make_migrator)
        self._pending_bumps: List[int] = []
        # autoscale windows consumed, keyed (core_idx, sim_idx[, series])
        self._autoscale_cursor: Dict[Tuple, int] = {}
        self.admission = admission
        # deferred registrations, retried after every run_until window
        self.admission_queue: List[AdmissionTicket] = []
        # reentrancy latch: queue drains and fabric pool registrations
        # must not re-consult the gate for an already-admitted ask
        self._gate_bypass = False
        for h in cluster.tenants:
            self._attach(h)

    # ------------------------------------------------------------------
    @property
    def now_s(self) -> float:
        """Current simulated time in SECONDS (the simulators' clock is
        cycles; the session API is seconds everywhere). Multi-core:
        the furthest-advanced core's clock — lockstep driving keeps
        every core at most one pending event apart."""
        return max(s.now for s in self.sims) / self.cluster.core.freq_hz

    def _cycles(self, t_s: float) -> float:
        """Seconds (session API) -> cycles (simulator domain)."""
        return t_s * self.cluster.core.freq_hz

    def _attach(self, handle: TenantHandle) -> None:
        if handle.plan is not None:
            cplan = self.cluster.compile_plan(handle.plan)
            spec = TenantSpec(cplan.prefill.program, handle.vnpu,
                              weight=handle.priority, plan=cplan,
                              kv_policy=handle.kv_policy)
        else:
            prog = self.cluster.compile(handle.trace)
            spec = TenantSpec(prog, handle.vnpu, weight=handle.priority)
        handle.core_idx = self.cluster.manager.core_index_of(handle.vnpu)
        if handle.core_hint is None:
            # pin resizes to this core: the live per-core simulator
            # owns the tenant, so a reconfigure must not core-hop
            handle.core_hint = handle.core_idx
        sim = self.sims[handle.core_idx]
        handle.sim_idx = sim.add_tenant(spec, open_loop=True)
        handle.attached_at = sim.now
        if handle.kv_policy:
            # pressure relief: a failed ledger charge first reclaims
            # segments this tenant lent out, then (kv_borrow only)
            # borrows idle peer segments. With no loans and borrowing
            # off the hook frees nothing, so the retry never fires and
            # every charge path stays bit-identical.
            sim.tenants[handle.sim_idx].kv_pressure_hook = \
                self._make_kv_relief(handle)
        rt = sim.tenants[handle.sim_idx]
        freq = self.cluster.core.freq_hz
        if handle.deadline_ms:
            rt.deadline_cycles = handle.deadline_ms * freq / 1e3
        if handle.max_retries > 0:
            rt.max_retries = handle.max_retries
            rt.retry_hook = self._make_retry(handle)
        if handle.kv_retention_ms and handle.vnpu is not None \
                and handle.vnpu.kv_ledger is not None:
            handle.vnpu.kv_ledger.retention_window = \
                handle.kv_retention_ms * freq / 1e3
        self._autoscale_cursor[(handle.core_idx, handle.sim_idx)] = 0
        if self.admission is not None:
            # every attached tenant holds a credit account (pre-session
            # cluster registrations and failover re-attaches included);
            # touch is idempotent so a balance survives re-attachment
            self.admission.touch(self._handle_ask(handle), sim.now / freq)

    # ---------------- credit admission gate ----------------
    def _fleet_state(self) -> FleetState:
        """Cluster-wide free/total EU + HBM-segment snapshot the
        credit gate prices against (free over healthy cores; totals
        over the whole fleet, so pressure rises when cores fault)."""
        man = self.cluster.manager
        core = self.cluster.core
        free_eus = free_segs = 0
        for cs in man.cores:
            if cs.failed:
                continue
            free_eus += len(cs.free_mes) + len(cs.free_ves)
            free_segs += len(cs.free_hbm_segs)
        n = len(man.cores)
        return FleetState(
            free_eus=free_eus, total_eus=n * (core.n_me + core.n_ve),
            free_hbm_segments=free_segs,
            total_hbm_segments=n * (core.hbm_bytes // core.hbm_segment))

    def _segments_of(self, hbm_bytes: Optional[int]) -> int:
        if hbm_bytes is None:
            return 0
        seg = self.cluster.core.hbm_segment
        return -(-int(hbm_bytes) // seg)

    def _handle_ask(self, handle: TenantHandle) -> AdmissionAsk:
        return AdmissionAsk(name=handle.name, eus=handle.eu_budget,
                            hbm_segments=self._segments_of(handle.hbm_bytes),
                            slo_ttft_ms=handle.slo_ttft_ms,
                            slo_tbt_ms=handle.slo_tbt_ms,
                            slo_p95_ms=handle.slo_p95_ms)

    def _refund(self, name: str, price: float) -> None:
        """Undo an admission debit whose registration the manager then
        refused (the gate's fleet counts are fungible EUs; placement
        needs type-matched MEs/VEs — the manager stays authoritative).
        ``spend(-p)`` preserves the conservation ledger."""
        acct = self.admission.accounts.get(name)
        if acct is not None and price > 0.0:
            acct.spend(-price)

    def _gated(self, kind: str, name: str, eu_budget: int,
               args: tuple, kwargs: dict,
               ) -> Union[TenantHandle, "FabricTenant", AdmissionTicket]:
        """One registration ask through the credit gate. Admitted asks
        (possibly down-sized) register immediately and return the
        handle; deferred asks — by credit, by fleet capacity, or by a
        placement refusal the fleet-level counts could not see — queue
        an :class:`AdmissionTicket` that retries after every
        ``run_until`` window."""
        ask = AdmissionAsk(
            name=name, eus=eu_budget,
            hbm_segments=self._segments_of(kwargs.get("hbm_bytes")),
            slo_ttft_ms=kwargs.get("slo_ttft_ms"),
            slo_tbt_ms=kwargs.get("slo_tbt_ms"),
            slo_p95_ms=kwargs.get("slo_p95_ms"),
            min_eus=kwargs.pop("min_eus", 2))
        ticket = AdmissionTicket(name=name, kind=kind, ask=ask,
                                 args=args, kwargs=kwargs)
        decision = self.admission.decide(ask, self.now_s,
                                         self._fleet_state())
        if decision.status != "defer":
            try:
                self._admit_ticket(ticket, decision.eus)
                return ticket.handle
            except RuntimeError:
                self._refund(name, decision.price)
        ticket.deferrals += 1
        self.admission_queue.append(ticket)
        return ticket

    def _admit_ticket(self, ticket: AdmissionTicket, eus: int) -> None:
        """A queued ticket cleared the gate: perform the real
        registration (bypassing the gate — the decision is made) and
        inject every arrival that queued against the ticket, original
        timestamps intact."""
        bypass, self._gate_bypass = self._gate_bypass, True
        try:
            if ticket.kind == "plain":
                trace, = ticket.args
                h = self.register(ticket.name, trace, eus,
                                  **ticket.kwargs)
            elif ticket.kind == "model":
                cfg, = ticket.args
                h = self.register_model(cfg, eu_budget=eus,
                                        **ticket.kwargs)
            else:
                cfg, placement = ticket.args
                h = self.register_generative(ticket.name, cfg,
                                             placement=placement,
                                             eu_budget=eus,
                                             **ticket.kwargs)
        finally:
            self._gate_bypass = bypass
        ticket.handle = h
        for arrivals in ticket.pending_arrivals:
            self.submit_arrivals(h, arrivals, clamp=True)
        ticket.pending_arrivals.clear()

    def _admission_step(self) -> None:
        """Post-window credit bookkeeping: feed live violation
        signals (SLO-violating TTFT/TBT samples, deadline misses)
        into tenant accounts as debits, then retry the re-admission
        queue in credit-weighted knapsack order."""
        ctl = self.admission
        if ctl is None:
            return
        now_s = self.now_s
        freq = self.cluster.core.freq_hz
        for h in self.cluster.tenants:
            if h.sim_idx < 0:
                continue
            acct = ctl.accounts.get(h.name)
            if acct is None:
                continue
            st = self._rt(h).stats
            v, acct.ttft_seen, acct.tbt_seen = slo_violation_signal(
                st,
                slo_ttft_cycles=(h.slo_ttft_ms * freq / 1e3
                                 if h.slo_ttft_ms else None),
                slo_tbt_cycles=(h.slo_tbt_ms * freq / 1e3
                                if h.slo_tbt_ms else None),
                ttft_seen=acct.ttft_seen, tbt_seen=acct.tbt_seen)
            v += st.deadline_misses - acct.misses_seen
            acct.misses_seen = st.deadline_misses
            ctl.observe(h.name, now_s, v)
        if not self.admission_queue:
            return
        fleet = self._fleet_state()
        order = ctl.rank([t.ask for t in self.admission_queue],
                         now_s, fleet)
        by_name = {t.name: t for t in self.admission_queue}
        # ranked tickets drain first (credit-weighted knapsack order);
        # the rest still get a decide() pass — the knapsack ranks
        # full-size asks, but decide() may admit one down-sized.
        pending = [by_name[n] for n in order if n in by_name]
        ranked = set(order)
        pending += [t for t in list(self.admission_queue)
                    if t.name not in ranked]
        for ticket in pending:
            decision = ctl.decide(ticket.ask, now_s, self._fleet_state())
            if decision.status == "defer":
                ticket.deferrals += 1
                continue
            try:
                self._admit_ticket(ticket, decision.eus)
            except RuntimeError:
                # the manager refused placement (fleet counts are
                # fungible EUs; the mapper needs type-matched MEs/VEs)
                # — refund the debit and keep the ticket queued
                self._refund(ticket.name, decision.price)
                ticket.deferrals += 1
                continue
            self.admission_queue.remove(ticket)

    def _make_retry(self, handle: TenantHandle):
        """The re-admission scheduler for one tenant (installed as its
        runtime's ``retry_hook``): a timed-out or fault-aborted
        request re-enters admission after an exponential backoff
        (``retry_backoff_ms * 2^retries``), carrying its ORIGINAL
        arrival (e2e latency spans every attempt) and its TTFT flag (a
        first token emitted by an aborted attempt is never
        re-sampled)."""
        base = self._cycles(handle.retry_backoff_ms / 1e3)

        def retry(req, t: float) -> None:
            sim = self._sim_of(handle)
            delay = base * (2 ** req.retries)
            if delay <= 0.0:
                # zero-backoff floor: a re-admission landing at exactly
                # t re-enters the same still-congested queue instant it
                # just timed out of, and sustained pressure burns every
                # retry without the request ever leaving WAITING. Floor
                # the horizon at the next event tick (the earliest the
                # queue can have moved), or one sweep period when the
                # heap is idle.
                rt = sim.tenants[handle.sim_idx]
                nxt = sim.next_event_at
                if math.isfinite(nxt) and nxt > t:
                    delay = nxt - t
                elif rt.deadline_cycles > 0:
                    delay = rt.deadline_cycles
                else:
                    delay = 1.0
            sim.inject_retry(handle.sim_idx, t + delay,
                             gen_len=req.gen_len,
                             prefix_key=req.prefix_key,
                             retries=req.retries + 1,
                             orig_arrival=req.arrival,
                             ttft_seen=req.ttft_seen)
            # the injection may pull this core's horizon earlier than
            # its cluster-heap entry
            self._pending_bumps.append(handle.core_idx)

        return retry

    def _make_kv_relief(self, handle: TenantHandle):
        """The cross-tenant HBM relief callback for one KV-accounted
        tenant (installed as its runtime's ``kv_pressure_hook``).
        Reclaim-before-borrow ordering: lent segments come home BEFORE
        the owner's own admission blocks, and only then does the
        tenant reach into co-resident ledgers for idle segments."""
        man = self.cluster.manager

        def relief(need: float) -> float:
            if handle.vnpu is None or handle.sim_idx < 0:
                return 0.0
            want = int(math.ceil(max(need, 0.0)))
            if want <= 0:
                return 0.0
            st = self._rt(handle).stats
            freed = man.reclaim_hbm(handle.vnpu, want)
            if freed:
                st.kv_reclaimed_bytes += freed
            if freed < want and handle.kv_borrow:
                got = man.borrow_hbm(handle.vnpu, want - freed)
                if got:
                    st.kv_borrowed_bytes += got
                freed += got
            return float(freed)

        return relief

    def _sim_of(self, handle: TenantHandle) -> Simulator:
        return self.sims[handle.core_idx]

    def _rt(self, handle: TenantHandle):
        if handle.sim_idx < 0:
            raise ValueError(
                f"tenant {handle.name!r} is not attached to this session "
                f"(register it through the session, not the bare cluster)")
        return self.sims[handle.core_idx].tenants[handle.sim_idx]

    @staticmethod
    def _ingress(handle: Union[TenantHandle, FabricTenant]) -> TenantHandle:
        """Request-facing side of a tenant: a fabric pair admits every
        request at its prefill pool."""
        return handle.prefill if isinstance(handle, FabricTenant) else handle

    # ---------------- tenant lifecycle (all legal mid-run) ----------------
    def register(self, name: str, trace: WorkloadTrace, eu_budget: int,
                 **kw) -> Union[TenantHandle, AdmissionTicket]:
        """Register a tenant on the cluster AND attach it to the live
        simulation (legal mid-run). ``eu_budget`` is execution units
        (engines); SLO kwargs (``slo_p95_ms`` etc.) are milliseconds.
        See :meth:`NPUCluster.register`.

        With a credit :class:`~repro_torch.core.admission.AdmissionController`
        installed, the ask passes the gate first: it may be admitted
        down-sized (fewer EUs), or deferred — an
        :class:`AdmissionTicket` is returned instead of a handle and
        the registration retries after every ``run_until`` window."""
        if self.admission is not None and not self._gate_bypass:
            return self._gated("plain", name, eu_budget, (trace,),
                               dict(kw))
        h = self.cluster.register(name, trace, eu_budget, **kw)
        self._attach(h)
        return h

    def register_model(self, cfg: ModelConfig,
                       **kw) -> Union[TenantHandle, AdmissionTicket]:
        """Register a fixed-phase model tenant mid-run (trace built
        from ``cfg``; see :meth:`NPUCluster.register_model` for the
        batch/seq token knobs). Credit-gated like :meth:`register`."""
        if self.admission is not None and not self._gate_bypass:
            kwargs = dict(kw)
            eu_budget = kwargs.pop("eu_budget", 4)
            return self._gated("model", cfg.name, eu_budget, (cfg,),
                               kwargs)
        h = self.cluster.register_model(cfg, **kw)
        self._attach(h)
        return h

    def register_generative(self, name: str, cfg: ModelConfig,
                            placement: Optional[Placement] = None,
                            **kw) -> Union[TenantHandle, FabricTenant,
                                           AdmissionTicket]:
        """Register a phase-structured LLM tenant mid-run (prefill +
        gen-length-distributed decode chain; see
        :meth:`NPUCluster.register_generative`).

        ``placement`` disaggregates the tenant across the cluster
        fabric: a prefill pool and a decode pool are registered as
        separate vNPUs on separate cores (chosen topology-aware by
        default — see :class:`~repro_torch.core.fabric.Placement`), and
        every request that finishes prefill migrates its KV to the
        decode core over the priced link model. Returns a
        :class:`FabricTenant` in that case.

        Credit-gated like :meth:`register`; a disaggregated pair is
        gated as ONE ask (the summed EU budget) so a deferral parks
        the whole pair, never half of it."""
        if self.admission is not None and not self._gate_bypass:
            kwargs = dict(kw)
            eu_budget = kwargs.pop("eu_budget", 4)
            return self._gated("generative", name, eu_budget,
                               (cfg, placement), kwargs)
        if placement is not None:
            return self._register_fabric_gated(name, cfg, placement, **kw)
        h = self.cluster.register_generative(name, cfg, **kw)
        self._attach(h)
        return h

    def _register_fabric_gated(self, name: str, cfg: ModelConfig,
                               placement: Placement,
                               **kw) -> FabricTenant:
        """Fabric pair registration with the gate latched off: the
        pair's ask was decided as one unit; the per-pool inner
        ``register_generative`` calls must not be re-gated (half a
        pair deferred would strand the other half)."""
        bypass, self._gate_bypass = self._gate_bypass, True
        try:
            return self._register_fabric(name, cfg, placement, **kw)
        finally:
            self._gate_bypass = bypass

    def _register_fabric(self, name: str, cfg: ModelConfig,
                         placement: Placement, eu_budget: int = 4,
                         **kw) -> FabricTenant:
        """Split one generative tenant into a cross-core phase pair.

        The EU budget splits between the pools (half/half unless the
        placement overrides); the TTFT SLO follows the prefill pool,
        the TBT / e2e SLOs the decode pool. Core choice: explicit
        placement > ``strategy="random"`` seeded pick >
        topology-aware :func:`~repro_torch.core.allocator.place_phase_pair`
        (hand-off cost x load, the Eq. 1-4 allocator's fabric
        companion)."""
        topo = self.cluster.topology
        man = self.cluster.manager
        pre_eus = placement.prefill_eus or max(eu_budget // 2, 2)
        dec_eus = placement.decode_eus or max(eu_budget - pre_eus, 2)
        if (placement.prefill_core is not None
                and placement.decode_core is not None):
            cp, cd = placement.prefill_core, placement.decode_core
        elif placement.strategy == "random":
            cp, cd = random_phase_pair(topo, placement.seed)
        else:
            # price the pair by one request's hand-off payload: the
            # whole prompt's KV plus the first token's
            probe = request_plan(cfg, kw.get("batch", 1),
                                 kw.get("prompt_len", 512), 1,
                                 core=self.cluster.core)
            kv_req = probe.kv_token_bytes * (kw.get("prompt_len", 512) + 1)
            loads = [cs.eu_used_frac + cs.mem_used_frac
                     for cs in man.cores]
            cp, cd = place_phase_pair(topo, loads=loads, kv_bytes=kv_req)
        pre_kw = dict(kw)
        dec_kw = dict(kw)
        pre_kw.pop("slo_tbt_ms", None)    # decode-side SLO
        dec_kw.pop("slo_ttft_ms", None)   # prefill-side SLO
        if placement.prefill_hbm_bytes is not None:
            pre_kw["hbm_bytes"] = placement.prefill_hbm_bytes
        if placement.decode_hbm_bytes is not None:
            dec_kw["hbm_bytes"] = placement.decode_hbm_bytes
        hp = self.register_generative(f"{name}/prefill", cfg,
                                      eu_budget=pre_eus, core_hint=cp,
                                      **pre_kw)
        try:
            hd = self.register_generative(f"{name}/decode", cfg,
                                          eu_budget=dec_eus, core_hint=cd,
                                          **dec_kw)
        except Exception:
            self.deregister(hp)   # all-or-nothing registration
            raise
        hp.fabric_role, hd.fabric_role = "prefill", "decode"
        ft = FabricTenant(name=name, prefill=hp, decode=hd,
                          prefill_core=cp, decode_core=cd,
                          hops=int(topo.hops(cp, cd)))
        self._rt(hp).migrate_hook = self._make_migrator(ft)
        self.fabric_tenants.append(ft)
        return ft

    def _make_migrator(self, ft: FabricTenant):
        """The cross-core hand-off protocol, installed as the prefill
        runtime's ``migrate_hook``. Ordering is the all-or-nothing
        ledger rule: the DESTINATION ledger is charged first; only on
        success does the source free — a reject on destination
        pressure leaves both ledgers untouched and the request decodes
        locally on the prefill core (``kv_migration_rejects``)."""
        topo = self.cluster.topology

        def migrate(src_rt, req, t: float) -> bool:
            hd = ft.decode
            if hd.sim_idx < 0:
                return False           # decode pool gone: stay local
            # read the pair's cores per hand-off: failover may have
            # evacuated either pool to a different core, and a link
            # fault may have severed the path since the last hand-off
            cp, cd = ft.prefill_core, ft.decode_core
            hopf = topo.hops(cp, cd)
            if not math.isfinite(hopf):
                # link outage left the pools disconnected: refuse the
                # hand-off and decode locally, like destination
                # pressure does
                src_rt.stats.kv_migration_rejects += 1
                return False
            hops = int(hopf)
            dst_sim = self.sims[hd.core_idx]
            dst_rt = dst_sim.tenants[hd.sim_idx]
            if dst_rt.removed:
                return False
            mreq = dst_rt.clone_inbound(req)
            src_led = src_rt._kv_led()
            nbytes = (src_led.bytes_of(req.rid) if src_led is not None
                      else src_rt.plan.kv_prompt_bytes)
            dst_led = dst_rt._kv_led()
            # a request holding a shared-prefix reference carries only
            # its suffix in the rid; the prefix rides the refcounted
            # entry. On the destination: a resident same-key entry is
            # a HIT (only the suffix moves and charges), a first-fill
            # charges the prefix into the dst shared entry, and with
            # no room to share the full context lands in the rid.
            shared = req.prefix_ref is not None and src_led is not None
            pbytes = src_rt._kv_prefix_bytes() if shared else 0.0
            attach = None
            if dst_led is not None:
                if shared and dst_rt.prefix_enabled:
                    attach = dst_rt._kv_prefix_attach(dst_led, mreq)
                rid_bytes = nbytes if attach is not None \
                    else nbytes + pbytes
                if not dst_rt._kv_charge(dst_led, mreq, rid_bytes):
                    # all-or-nothing: undo the attach so a rejected
                    # hand-off leaves BOTH ledgers untouched
                    if attach is not None:
                        dst_rt._kv_prefix_release(dst_led, mreq)
                    src_rt.stats.kv_migration_rejects += 1
                    return False
                if attach == "hit":
                    dst_rt.stats.kv_prefix_hits += 1
                    dst_rt.stats.kv_shared_bytes += pbytes
            if src_led is not None:
                src_led.release(req.rid)   # free AFTER the dst charge
                src_rt._kv_prefix_release(src_led, req)
            # wire payload: the suffix, plus the prefix unless the
            # destination already holds it (a hit moves nothing extra)
            wire = nbytes + (0.0 if attach == "hit" else pbytes)
            st = src_rt.stats
            st.kv_migrations += 1
            st.kv_migrated_bytes += wire
            st.cross_core_hops += hops
            ft.in_transit += 1

            def land(_t: float) -> None:
                ft.in_transit -= 1

            delay = topo.transfer_cycles(cp, cd, wire)
            dst_sim.inject_migration(hd.sim_idx, t + delay, mreq,
                                     on_land=land)
            # the injection may have pulled the destination core's
            # horizon earlier than its cluster-heap entry
            self._pending_bumps.append(hd.core_idx)
            return True

        return migrate

    def deregister(self,
                   handle: Union[TenantHandle, FabricTenant]) -> None:
        """Remove a tenant mid-run: queued + in-flight requests are
        dropped, its engines free immediately, its stats survive in
        the session report. A :class:`FabricTenant` removes both pool
        handles (hand-offs still on the wire land on a removed tenant
        and are dropped — the ledger clear already released them)."""
        if isinstance(handle, FabricTenant):
            self._rt(handle.prefill).migrate_hook = None
            self.fabric_tenants.remove(handle)
            self.deregister(handle.prefill)
            self.deregister(handle.decode)
            return
        if handle not in self.cluster.tenants:
            raise ValueError(f"tenant {handle.name!r} is not registered")
        if handle.sim_idx >= 0:
            sim = self._sim_of(handle)
            man = self.cluster.manager
            v = handle.vnpu
            led = v.kv_ledger if v is not None else None
            if led is not None:
                # Unwind the LENDER side of every HBM loan before
                # teardown (same protocol as _evacuate): idle lent
                # segments come home first, then borrowers' live KV is
                # force-evicted until the rest follows. Destroying a
                # lender with live borrowed KV on its segments would
                # strand the loan table mid-settle and break
                # hbm_census conservation.
                t = sim.now
                for _ in range(100_000):
                    lent, _borrowed = man.loans_of(v)
                    if lent <= 0:
                        break
                    if man.reclaim_hbm(v, lent) > 0:
                        continue
                    if not self._evict_borrower(v, t):
                        raise KVLedgerError(
                            f"tenant {handle.name!r} deregistered while "
                            f"{lent} B of its segments hold a borrower's "
                            f"live KV that cannot be evicted; drain the "
                            f"borrower first")
            sim.remove_tenant(handle.sim_idx)
            if led is not None and led.borrowed > 0:
                # BORROWER side: remove_tenant cleared this tenant's
                # own KV, so every borrowed byte is idle now — return
                # it all (lender counters settle) instead of leaking
                # the grant into manager.destroy's settle path
                man.return_borrowed(v)
            # drop this slot's autoscale cursors (plain and per-series
            # fabric keys): a new tenant landing on a reused sim slot
            # must not inherit the old tenant's latency window
            slot = (handle.core_idx, handle.sim_idx)
            for key in [k for k in self._autoscale_cursor
                        if k[:2] == slot]:
                del self._autoscale_cursor[key]
        self.cluster.deregister(handle)

    def set_iteration_token_budget(self, handle: TenantHandle,
                                   tokens: int) -> None:
        """Adjust a generative tenant's per-iteration token budget
        LIVE (tokens; 0 disables piggybacking). Takes effect at the
        tenant's next iteration start — in-flight work finishes at its
        compiled cost. This is the knob an autoscale hook turns to
        trade decode cadence (bigger budget = larger prefill slices,
        faster TTFT) against TBT (smaller slices = shorter
        iterations); tenants registered with static
        ``prefill_chunk_tokens`` must re-register instead (the knobs
        are mutually exclusive).

        Disabling (``tokens=0``) RESTARTS any request parked
        mid-slice: the unset engine only has the whole-prompt
        monolithic program, so the partially-ingested KV is dropped
        and the prompt re-ingests from token 0 (the cost of the
        policy change is paid explicitly, never silently
        double-counted)."""
        if handle.plan is None:
            raise ValueError(
                f"tenant {handle.name!r} is not generative; there is "
                f"no iteration budget to set")
        if tokens < 0:
            raise ValueError(f"budget must be >= 0 tokens, got {tokens}")
        if tokens > 0 and handle.plan.chunked:
            raise ValueError(
                f"tenant {handle.name!r} uses static prefill_chunk_tokens="
                f"{handle.plan.prefill_chunk_tokens}; the adaptive budget "
                f"replaces that knob — re-register without it")
        rt = self._rt(handle)
        if tokens > 0 and not rt.plan.can_piggyback:
            raise ValueError(
                f"tenant {handle.name!r} was compiled without a piggyback "
                f"builder; re-register through register_generative")
        handle.plan.iteration_token_budget = int(tokens)
        rt.plan.iteration_token_budget = int(tokens)
        if tokens == 0:
            # back to the monolithic engine; the simulator resets any
            # mid-slice ingestion cursor when it next picks such a
            # request (the restart documented above)
            rt.force_prefill = False

    def resize(self, handle: TenantHandle, eu_budget: int) -> TenantHandle:
        """Re-size a tenant mid-run (the paper's reconfigure hypercall
        live): allocator re-splits, the vNPU manager re-places, and
        the running simulation moves ownership without restarting."""
        try:
            self.cluster.resize(handle, eu_budget)
        finally:
            # keep the live sim consistent with whatever vNPU the
            # handle ended up on (new or restored-after-failure)
            if handle.sim_idx >= 0:
                self._sim_of(handle).update_tenant_vnpu(
                    handle.sim_idx, handle.vnpu)
        return handle

    # ---------------- request admission ----------------
    def _gen_lens_for(self, handle: TenantHandle,
                      n: int) -> List[Optional[int]]:
        """Per-request generation lengths: sampled from the handle's
        distribution on a deterministic stream, or the plan default."""
        lens, _ = self._sample_requests(handle, n)
        return lens

    def _sample_requests(
            self, handle: TenantHandle, n: int,
    ) -> Tuple[List[Optional[int]], List[int]]:
        """Sample generation lengths AND shared-prefix keys for ``n``
        requests on the same deterministic stream slot, then advance
        the handle's cursor once — lengths and keys of request *i*
        always travel together regardless of which was sampled."""
        if handle.gen_lens is None:
            lens: List[Optional[int]] = [None] * n
        else:
            lens = [int(x) for x in
                    handle.gen_lens.sample(n, stream=handle.submitted)]
        if handle.prefix_profile is None:
            keys = [0] * n
        else:
            keys = [int(k) for k in handle.prefix_profile.sample(
                n, stream=handle.submitted)]
        handle.submitted += 1
        return lens, keys

    def submit(self, handle: Union[TenantHandle, FabricTenant],
               at_s: Optional[float] = None,
               gen_len: Optional[int] = None,
               prefix_key: Optional[int] = None) -> None:
        """Admit one request for ``handle`` at ``at_s`` seconds
        (default: now). ``gen_len`` pins this request's token count;
        otherwise the handle's distribution (or plan default) rules.
        ``prefix_key`` pins the shared-prefix group (0 = private);
        otherwise the handle's prefix profile samples it. Fabric
        tenants admit at their prefill pool."""
        handle = self._ingress(handle)
        self._rt(handle)
        sim = self._sim_of(handle)
        at = sim.now if at_s is None else self._cycles(at_s)
        if at < sim.now - 1e-9:
            raise ValueError(
                f"arrival at t={at_s}s is in the past "
                f"(session time {self.now_s:.6f}s)")
        if gen_len is None or (prefix_key is None
                               and handle.prefix_profile is not None):
            lens, keys = self._sample_requests(handle, 1)
            if gen_len is None:
                gen_len = lens[0]
            if prefix_key is None:
                prefix_key = keys[0]
        sim.inject_request(handle.sim_idx, at, gen_len=gen_len,
                           prefix_key=int(prefix_key or 0))

    def submit_arrivals(self,
                        handle: Union[TenantHandle, FabricTenant,
                                      AdmissionTicket],
                        arrivals: "ArrivalProcess",
                        clamp: bool = False) -> int:
        """Admit a whole arrival process (Poisson / trace-driven);
        returns the number of requests injected. A still-deferred
        :class:`AdmissionTicket` queues the process instead (0
        injected now); it is injected the moment the gate admits the
        tenant, with any arrival that fell due DURING the deferral
        landing at the admission instant (the earliest legal clock —
        ``clamp`` is how the replay path asks for that)."""
        if isinstance(handle, AdmissionTicket):
            if handle.admitted:
                return self.submit_arrivals(handle.handle, arrivals)
            handle.pending_arrivals.append(arrivals)
            return 0
        handle = self._ingress(handle)
        self._rt(handle)
        sim = self._sim_of(handle)
        times = arrivals.times_s()
        lens, keys = self._sample_requests(handle, len(times))
        for t_s, g, k in zip(times, lens, keys):
            at = self._cycles(float(t_s))
            if clamp and at < sim.now:
                at = sim.now
            sim.inject_request(handle.sim_idx, at,
                               gen_len=g, prefix_key=k or 0)
        return len(times)

    # ---------------- driving ----------------
    def run_until(self, t_s: float) -> float:
        """Advance the simulation to ``t_s`` seconds, then give the
        autoscale hook a chance to act on each tenant's latency tail.
        Returns the new session time (seconds)."""
        self._advance(self._cycles(t_s))
        self._autoscale_step()
        self._admission_step()
        return self.now_s

    def drain(self) -> float:
        """Process every injected arrival and all in-flight work.
        Deferred admissions are retried between passes until no
        further ticket clears the gate (credit accrues with simulated
        time, so an idle cluster cannot loop forever)."""
        self._advance(math.inf)
        while self.admission is not None and self.admission_queue:
            n = len(self.admission_queue)
            self._admission_step()
            if len(self.admission_queue) >= n:
                break             # nothing admitted: no more progress
            self._advance(math.inf)
        return self.now_s

    def _advance(self, t_end: float) -> None:
        """Drive the cluster to ``t_end`` cycles, firing injected
        faults at their scheduled instants: the simulation advances to
        each fault's timestamp first (every core aligned), the fault
        applies — core failure triggering evacuation or suspension,
        link degradation re-pricing the fabric, HBM segment faults
        shrinking vNPUs — and the run resumes. With no schedule this
        is exactly the fault-free lockstep drive (:meth:`_drive`)."""
        q = self._fault_q
        while q and q[0][0] <= t_end:
            at, _, ev = heapq.heappop(q)
            self._drive(at)
            self._apply_fault(ev, at)
        self._drive(t_end)

    def _drive(self, t_end: float) -> None:
        """Cluster-level lockstep scheduler: repeatedly advance the
        core simulator holding the globally-earliest pending event.
        Every cross-core hand-off is injected at
        ``t_handoff + transfer >= t_handoff``, and no simulator's
        clock ever passes the global event frontier — so a migration
        can never land in a destination core's past. Single-core
        sessions drive their one simulator directly (bit-identical to
        the pre-fabric engine).

        Multi-core driving uses a cluster event heap keyed on each
        core's ``next_event_at`` instead of a min() scan per event:
        a core's entry is re-pushed only when its horizon changes —
        after it runs, or when a cross-core hand-off pulls its
        horizon earlier (``_pending_bumps``, appended by the
        migration hook). Superseded entries are dropped lazily via
        the ``keyed`` horizon array. Ties pop lowest core index
        first, matching the min() scan, so drive order — and every
        SimResult — is unchanged."""
        sims = self.sims
        if len(sims) == 1:
            sims[0].run_until(t_end)
            self._pending_bumps.clear()   # same-core hand-offs
            return
        bumps = self._pending_bumps
        bumps.clear()
        keyed = [s.next_event_at for s in sims]
        heap = [(keyed[i], i) for i in range(len(sims))
                if math.isfinite(keyed[i])]
        heapq.heapify(heap)

        def push(i: int, horizon: float) -> None:
            keyed[i] = horizon
            if math.isfinite(horizon):
                heapq.heappush(heap, (horizon, i))

        while heap:
            h, i = heapq.heappop(heap)
            if h != keyed[i]:
                continue              # superseded by a later re-key
            nxt = sims[i].next_event_at
            if nxt != h:
                push(i, nxt)          # horizon moved; re-key
                continue
            if nxt > t_end:
                break                 # heap min: every core is beyond
            sims[i].run_until(nxt)
            for j in bumps:
                push(j, sims[j].next_event_at)
            bumps.clear()
            push(i, sims[i].next_event_at)
        if math.isfinite(t_end):
            for s in sims:
                s.run_until(t_end)   # clock alignment; no events left

    # ---------------- fault injection & failover ----------------
    def _apply_fault(self, ev: FaultEvent, t: float) -> None:
        """Fire one scheduled fault at cycle ``t`` (every simulator is
        aligned at ``t`` when this runs)."""
        man = self.cluster.manager
        topo = self.cluster.topology
        if ev.kind == "link_degrade":
            topo.degrade_link(ev.link[0], ev.link[1], ev.bw_scale)
        elif ev.kind == "link_restore":
            topo.restore_link(ev.link[0], ev.link[1])
        elif ev.kind == "core_down":
            self._core_down(ev, t)
        elif ev.kind == "core_up":
            man.restore_core(ev.core)
            self._resume_core(ev.core, t)
        elif ev.kind == "hbm_fault":
            self._hbm_fault(ev, t)

    def _core_down(self, ev: FaultEvent, t: float) -> None:
        """A core fails: mark it unplaceable, schedule its recovery if
        the fault is transient, then fail over every resident session
        tenant — whole-vNPU evacuation under ``failover="evacuate"``
        (suspend when no destination fits), kill-and-restart
        suspension under ``"restart"``."""
        man = self.cluster.manager
        if man.cores[ev.core].failed:
            return                     # already down: nothing new fails
        man.fail_core(ev.core)
        if ev.transient:
            up = t + self._cycles(ev.recovery)
            heapq.heappush(self._fault_q,
                           (up, next(self._fseq),
                            FaultEvent(at=0.0, kind="core_up",
                                       core=ev.core)))
        for h in [h for h in list(self.cluster.tenants)
                  if h.sim_idx >= 0 and h.core_idx == ev.core]:
            moved = self.failover == "evacuate" and self._evacuate(h, t)
            if not moved:
                self._suspend(h, t)

    def _evacuate(self, handle: TenantHandle, t: float) -> bool:
        """Whole-vNPU failover: move ``handle`` — vNPU shape, live KV
        ledger (per-request, shared-prefix AND retained entries),
        queue state, pending heap events — to the best surviving core,
        priced as one bulk transfer over the fabric. All-or-nothing:
        any step that cannot complete (no healthy destination, no
        fabric path, placement or ledger-migration failure, loans that
        cannot unwind) leaves the source mapping intact and returns
        False, and the caller falls back to suspend/restart. The
        tenant stays frozen until the transfer lands (downtime)."""
        man = self.cluster.manager
        topo = self.cluster.topology
        v = handle.vnpu
        if v is None:
            return False
        led = v.kv_ledger
        src = handle.core_idx
        sim = self.sims[src]
        rt = sim.tenants[handle.sim_idx]
        live_kv = (led.in_use + led.shared_in_use) if led is not None else 0
        occ = led.occupancy if led is not None else 0
        loads = [cs.eu_used_frac + cs.mem_used_frac for cs in man.cores]
        dst = pick_evacuation_core(topo, src, man.healthy_cores(),
                                   loads=loads, kv_bytes=float(occ))
        if dst is None:
            return False
        delay = topo.transfer_cycles(src, dst, float(occ))
        if not math.isfinite(delay):
            return False        # no fabric path: state cannot be copied
        # 1. cancel the in-flight iteration (lost attempts land back in
        #    the waiting queue and travel with it)
        sim.abort_tenant(handle.sim_idx, t)
        # 2. unwind HBM loans — same-core agreements cannot follow the
        #    vNPU to another core
        if led is not None and not self._unwind_loans(handle, rt, t):
            return False
        # 3. place the replacement on the destination core
        seg = self.cluster.core.hbm_segment
        cap = int(led.capacity) if led is not None else v.config.hbm_bytes
        cfg = VNPUConfig(n_me=v.config.n_me, n_ve=v.config.n_ve,
                         sram_bytes=v.config.sram_bytes,
                         hbm_bytes=-(-cap // seg) * seg,
                         priority=v.config.priority)
        try:
            nv = man.create(cfg, name=v.name, mapping=self.cluster.mapping,
                            core_hint=dst)
        except RuntimeError:
            return False
        # 4. carry the ledger (destination charged before the source
        #    frees — a failure here destroys the replacement and leaves
        #    the source untouched)
        if led is not None:
            try:
                nv.kv_ledger.migrate_from(led)
            except KVLedgerError:
                man.destroy(nv)
                return False
        # 5. the point of no return: pull pending events + queue state,
        #    detach from the failed core, re-attach on the destination
        events = sim.extract_tenant_events(handle.sim_idx)
        snap = (deque(rt.waiting), list(rt.prefilling), list(rt.decoding),
                list(rt.swapped), rt.stats, rt._rid,
                rt.yield_to_decode, rt.force_prefill)
        rt.stats = TenantStats(name=rt.stats.name)  # src sim: no double
        attached_at = handle.attached_at
        sim.remove_tenant(handle.sim_idx)
        man.destroy(v)
        handle.vnpu = nv
        handle.core_hint = dst
        self._attach(handle)
        handle.attached_at = attached_at
        nrt = self._rt(handle)
        (nrt.waiting, nrt.prefilling, nrt.decoding, nrt.swapped,
         nrt.stats, nrt._rid, nrt.yield_to_decode,
         nrt.force_prefill) = snap
        nrt.frozen_until = t + delay
        dst_sim = self.sims[dst]
        dst_sim.replay_tenant_events(handle.sim_idx, events)
        dst_sim.inject_wake(handle.sim_idx, t + delay)
        self._pending_bumps.append(dst)
        st = nrt.stats
        st.evacuations += 1
        st.faults_survived += 1
        st.evacuated_bytes += live_kv
        st.downtime_cycles += delay
        self._autoscale_cursor[(handle.core_idx, handle.sim_idx)] = \
            len(st.latencies)
        self._refresh_fabric(handle)
        return True

    def _unwind_loans(self, handle: TenantHandle, rt, t: float) -> bool:
        """Settle every HBM loan touching ``handle`` before its vNPU
        leaves the core. Lender side: idle lent segments come home
        first, then borrowers' KV is force-evicted (PREMA victims)
        until the rest follows. Borrower side: the tenant's own KV is
        evicted down to its own segments, then every borrowed byte
        returns. False when a loan cannot unwind (evacuation falls
        back to suspend)."""
        man = self.cluster.manager
        v = handle.vnpu
        for _ in range(100_000):
            lent, _borrowed = man.loans_of(v)
            if lent <= 0:
                break
            if man.reclaim_hbm(v, lent) > 0:
                continue
            if not self._evict_borrower(v, t):
                return False
        else:                          # pragma: no cover - guard rail
            return False
        for _ in range(100_000):
            try:
                man.return_borrowed(v)
                return True
            except KVLedgerError:
                led = v.kv_ledger
                if led is not None and led.retired \
                        and led.evict_retired(led.segment_bytes, now=t) > 0:
                    continue
                if not rt._kv_evict_one(t):
                    return False
        return False                   # pragma: no cover - guard rail

    def _evict_borrower(self, v: VNPU, t: float) -> bool:
        """Force one PREMA eviction inside a tenant borrowing from
        ``v`` (loan unwinding: the idle share already came home, so a
        borrower must give up live KV for the rest to follow)."""
        man = self.cluster.manager
        for bid in man.borrowers_of(v):
            bh = next((h for h in self.cluster.tenants
                       if h.vnpu is not None and h.vnpu.vnpu_id == bid
                       and h.sim_idx >= 0), None)
            if bh is None:
                continue
            brt = self._rt(bh)
            bled = bh.vnpu.kv_ledger
            if bled is not None and bled.retired \
                    and bled.evict_retired(bled.segment_bytes, now=t) > 0:
                return True
            if brt._kv_evict_one(t):
                return True
        return False

    def _suspend(self, handle: TenantHandle, t: float) -> None:
        """Kill-and-restart failover (the ``"restart"`` baseline, and
        the fallback when evacuation has nowhere to go): the in-flight
        iteration is cancelled, every live request is fault-aborted
        into the deadline/retry path (bounded budget — requests out of
        retries are dropped and counted), the vNPU is destroyed, and
        the tenant parks until its home core recovers."""
        man = self.cluster.manager
        sim = self._sim_of(handle)
        rt = self._rt(handle)
        sim.abort_tenant(handle.sim_idx, t)
        v = handle.vnpu
        led = v.kv_ledger if v is not None else None
        live = (list(rt.waiting) + list(rt.prefilling)
                + list(rt.swapped) + list(rt.decoding))
        for req in live:
            if led is not None:
                led.release(req.rid)
                rt._kv_prefix_release(led, req)
            # the retry hook injects into THIS sim's heap; the events
            # are extracted below and replayed at resume
            rt.retry_or_drop(req, t)
        rt.waiting.clear()
        rt.prefilling.clear()
        rt.decoding.clear()
        rt.swapped.clear()
        if led is not None:
            led.flush_retired()
        weights = int(led.reserved) if led is not None else 0
        seg = self.cluster.core.hbm_segment
        cap = int(led.capacity) if led is not None else \
            (v.config.hbm_bytes if v is not None else 0)
        cfg = VNPUConfig(n_me=v.config.n_me, n_ve=v.config.n_ve,
                         sram_bytes=v.config.sram_bytes,
                         hbm_bytes=-(-cap // seg) * seg,
                         priority=v.config.priority)
        events = sim.extract_tenant_events(handle.sim_idx)
        snap = _Suspended(handle=handle, cfg=cfg, stats=rt.stats,
                          rid=rt._rid, events=events,
                          core=handle.core_idx, since=t,
                          attached_at=handle.attached_at,
                          weights=weights)
        rt.stats = TenantStats(name=rt.stats.name)  # src sim: no double
        sim.remove_tenant(handle.sim_idx)
        if v is not None:
            man.destroy(v)             # settles any remaining loans
        handle.vnpu = None
        handle.sim_idx = -1
        self._suspended.append(snap)

    def _resume_core(self, core: int, t: float) -> None:
        """A core recovered: rebuild every tenant suspended from it —
        fresh vNPU at the pre-fault shape, stats and rid counter
        carried over, pending events replayed (stale arrivals keep
        their ORIGINAL timestamps so e2e latency spans the outage).
        Tenants that no longer fit stay suspended until the next
        recovery."""
        man = self.cluster.manager
        for s in list(self._suspended):
            if s.core != core:
                continue
            h = s.handle
            try:
                nv = man.create(s.cfg, name=h.name,
                                mapping=self.cluster.mapping,
                                core_hint=core)
            except RuntimeError:
                continue               # no room yet; stay suspended
            if h.kv_policy and s.weights:
                nv.kv_ledger.reserve(s.weights)
            h.vnpu = nv
            h.core_hint = core
            self._attach(h)
            h.attached_at = s.attached_at
            nrt = self._rt(h)
            nrt.stats = s.stats
            nrt._rid = s.rid
            self._replay_preserving(self._sim_of(h), h.sim_idx, s.events)
            st = nrt.stats
            st.downtime_cycles += t - s.since
            st.faults_survived += 1
            self._autoscale_cursor[(h.core_idx, h.sim_idx)] = \
                len(st.latencies)
            self._refresh_fabric(h)
            self._pending_bumps.append(h.core_idx)
            self._suspended.remove(s)

    def _replay_preserving(self, sim: Simulator, idx: int,
                           events: Sequence[Tuple[float, str, object]]
                           ) -> None:
        """Replay extracted heap events after a suspend gap. Events
        still in the future replay verbatim; plain/keyed arrivals the
        outage swallowed land NOW but keep their original timestamp as
        the request's arrival (via a zero-count retry), so queueing
        time spent suspended stays in the latency record."""
        now = sim.now
        for t, kind, payload in events:
            if t >= now:
                sim.replay_tenant_events(idx, [(t, kind, payload)])
                continue
            if kind == "arr":
                g = payload
                sim.inject_retry(idx, now, gen_len=None if g < 0 else g,
                                 retries=0, orig_arrival=t)
            elif kind == "arrk":
                g, pk = payload
                sim.inject_retry(idx, now, gen_len=None if g < 0 else g,
                                 prefix_key=pk, retries=0, orig_arrival=t)
            else:                      # retries / migrations: clamp
                sim.replay_tenant_events(idx, [(t, kind, payload)])

    def _hbm_fault(self, ev: FaultEvent, t: float) -> None:
        """``n_segments`` HBM segments fault on one core. The victim
        is the resident session tenant holding the most HBM (the
        widest blast surface; deterministic tie-break). Graceful
        degradation: live KV is evicted down — retained prefix entries
        first, then PREMA victims — until the shrunken allocation
        holds the occupancy, and the vNPU's ledger + segment list
        shrink in place (resizes keep honoring the smaller size). When
        even the resident weights cannot fit, the fault escalates to
        whole-vNPU failover and the vacated segments fault out of the
        core's free pool."""
        man = self.cluster.manager
        cands = [h for h in self.cluster.tenants
                 if h.sim_idx >= 0 and h.core_idx == ev.core
                 and h.vnpu is not None and h.vnpu.segments is not None]
        if not cands:
            man.fault_free_hbm_segments(ev.core, ev.n_segments)
            return
        h = max(cands, key=lambda x: (len(x.vnpu.segments.hbm_segments),
                                      -x.vnpu.vnpu_id))
        rt = self._rt(h)
        sim = self._sim_of(h)
        led = h.vnpu.kv_ledger
        seg = self.cluster.core.hbm_segment
        n = min(ev.n_segments, len(h.vnpu.segments.hbm_segments))
        if n <= 0 or led is None:
            return
        if led.reserved > led.capacity - n * seg:
            # weights alone overflow the shrunken vNPU: escalate
            moved = self.failover == "evacuate" and self._evacuate(h, t)
            if not moved:
                self._suspend(h, t)
            man.fault_free_hbm_segments(ev.core, n)
            return
        target = led.capacity - n * seg + led.borrowed
        if led.occupancy > target:
            sim.abort_tenant(h.sim_idx, t)
        for _ in range(100_000):
            if led.occupancy <= target:
                break
            if led.retired \
                    and led.evict_retired(led.occupancy - target,
                                          now=t) > 0:
                continue
            if not rt._kv_evict_one(t):
                break
        if led.occupancy > target:
            # eviction could not clear the segments (e.g. lent bytes
            # pinned by a borrower): escalate like the weights case
            moved = self.failover == "evacuate" and self._evacuate(h, t)
            if not moved:
                self._suspend(h, t)
            man.fault_free_hbm_segments(ev.core, n)
            return
        man.fault_hbm_segments(h.vnpu, n)
        h.hbm_bytes = int(led.capacity)
        st = rt.stats
        st.hbm_fault_segments += n
        st.faults_survived += 1
        sim.inject_wake(h.sim_idx, t)   # re-kick if the abort idled it
        self._pending_bumps.append(h.core_idx)

    def _refresh_fabric(self, handle: TenantHandle) -> None:
        """Failover moved a disaggregated pool to another core: point
        its :class:`FabricTenant` record — and, for a prefill pool,
        its freshly-attached runtime's migrate hook — at the new
        placement. Hand-off pricing re-reads the pair's cores per
        request, so in-flight accounting stays consistent."""
        topo = self.cluster.topology
        for ft in self.fabric_tenants:
            if handle is ft.prefill:
                ft.prefill_core = handle.core_idx
            elif handle is ft.decode:
                ft.decode_core = handle.core_idx
            else:
                continue
            hopf = topo.hops(ft.prefill_core, ft.decode_core)
            ft.hops = int(hopf) if math.isfinite(hopf) else 0
            if ft.prefill.sim_idx >= 0:
                self._rt(ft.prefill).migrate_hook = self._make_migrator(ft)

    def _autoscale_step(self) -> None:
        if self.autoscaler is None:
            return
        ms = 1e3 / self.cluster.core.freq_hz
        for h in list(self.cluster.tenants):
            if h.sim_idx < 0 or h.fabric_role:
                continue   # fabric pools scale per phase below
            stats = self._rt(h).stats
            key = (h.core_idx, h.sim_idx)
            cursor = self._autoscale_cursor.get(key, 0)
            recent = [x * ms for x in stats.latencies[cursor:]]
            new_budget = self.autoscaler(self, h, recent)
            if new_budget is not None and new_budget != h.eu_budget:
                if not self._approve_scaleup(h, new_budget):
                    continue   # credit gate refused; retry next window
                self._autoscale_cursor[key] = len(stats.latencies)
                try:
                    self.resize(h, new_budget)
                except ReconfigureError:
                    pass  # no room to grow; hold at current size
        for ft in self.fabric_tenants:
            self._autoscale_fabric(ft, ms)

    def _approve_scaleup(self, h: TenantHandle, new_budget: int) -> bool:
        """Autoscale grows pass the credit gate too: the incremental
        EUs are priced at current fleet pressure and debited from the
        tenant's account. Always true with the gate off (and for
        shrinks — releasing capacity is never gated)."""
        if self.admission is None or new_budget <= h.eu_budget:
            return True
        return self.admission.approve_scaleup(
            h.name, new_budget - h.eu_budget, self.now_s,
            self._fleet_state())

    def _autoscale_fabric(self, ft: FabricTenant, ms: float) -> None:
        """Per-core phase-pair autoscaling: TTFT violations grow the
        PREFILL pool on the prefill core, TBT violations the decode
        pool on the decode core — each side judged on its own series
        against its own SLO (hooks without :meth:`decide_phase` skip
        fabric pairs)."""
        decide = getattr(self.autoscaler, "decide_phase", None)
        if decide is None:
            return
        for h, series_name, slo in (
                (ft.prefill, "ttft", ft.prefill.slo_ttft_ms),
                (ft.decode, "tbt", ft.decode.slo_tbt_ms)):
            if h.sim_idx < 0 or slo is None:
                continue
            series = getattr(self._rt(h).stats, series_name)
            key = (h.core_idx, h.sim_idx, series_name)
            cursor = self._autoscale_cursor.get(key, 0)
            recent = [x * ms for x in series[cursor:]]
            new_budget = decide(self, h, recent, slo)
            if new_budget is not None and new_budget != h.eu_budget:
                if not self._approve_scaleup(h, new_budget):
                    continue   # credit gate refused; retry next window
                self._autoscale_cursor[key] = len(series)
                try:
                    self.resize(h, new_budget)
                except ReconfigureError:
                    pass  # the pinned core is full; hold at size

    # ---------------- accounting ----------------
    def report(self,
               handle: Union[TenantHandle, FabricTenant, None] = None
               ) -> List[TenantReport]:
        """Per-request latency accounting for live (and, while their
        handles are kept, deregistered) tenants. Latencies are
        reported in milliseconds (see :class:`TenantReport` for the
        unit convention); throughput is requests per second of
        simulated time since the tenant attached (the 1-cycle clamp
        only guards the no-time-elapsed division).

        Fabric tenants report as ONE merged row per pair (named after
        the pair, counters summed, TTFT from the prefill side, e2e
        latencies from whichever core completed each request); the
        default listing hides the raw per-pool sub-handles — pass one
        explicitly for a per-core view."""
        if isinstance(handle, FabricTenant):
            return [self._fabric_report(handle)]
        if handle is not None:
            handles = [handle]
        else:  # bare-cluster registrations have no runtime to report on
            handles = [h for h in self.cluster.tenants
                       if h.sim_idx >= 0 and not h.fabric_role]
        core = self.cluster.core
        ms = 1e3 / core.freq_hz
        out = []
        for h in handles:
            rt = self._rt(h)
            now = self._sim_of(h).now
            elapsed_s = max(now - h.attached_at, 1.0) / core.freq_hz
            out.append(_tenant_report(
                h, rt.stats, ms, rt.stats.requests_done / elapsed_s,
                queued=rt.in_flight,
                elapsed_cycles=max(now - h.attached_at, 0.0)))
        if handle is None:
            out.extend(self._fabric_report(ft)
                       for ft in self.fabric_tenants)
        if self.admission is not None:
            now_s = self.now_s
            for rep in out:
                acct = self.admission.accounts.get(rep.name)
                if acct is not None:
                    rep.credit = self.admission.balance(rep.name, now_s)
                    rep.admission_deferrals = acct.deferrals
        return out

    # stats where the pair-wise merge is a max, not a sum
    _MERGE_MAX = frozenset({"max_decode_batch", "max_piggyback_batch",
                            "kv_peak_bytes", "kv_peak_segments"})

    def _fabric_report(self, ft: FabricTenant) -> TenantReport:
        """One merged report for a disaggregated phase pair: latency /
        TBT series concatenate (a request completes on exactly one
        core), TTFT comes from the prefill side alone (sampled there),
        scalar counters sum except the peaks (max — the pools hold
        separate ledgers), and ``queued`` counts both pools' in-flight
        requests plus hand-offs still on the wire."""
        core = self.cluster.core
        ms = 1e3 / core.freq_hz
        hp, hd = ft.prefill, ft.decode
        rp, rd = self._rt(hp), self._rt(hd)
        sp, sd = rp.stats, rd.stats
        merged = TenantStats(name=ft.name)
        for f in _dc_fields(TenantStats):
            if f.name == "name":
                continue
            a, b = getattr(sp, f.name), getattr(sd, f.name)
            if isinstance(a, list):
                setattr(merged, f.name, a + b)
            elif f.name in self._MERGE_MAX:
                setattr(merged, f.name, max(a, b))
            else:
                setattr(merged, f.name, a + b)
        merged.ttft = list(sp.ttft)   # sampled on the prefill core only
        shim = TenantHandle(
            name=ft.name, trace=hp.trace,
            eu_budget=hp.eu_budget + hd.eu_budget,
            slo_p95_ms=hd.slo_p95_ms, slo_ttft_ms=hp.slo_ttft_ms,
            slo_tbt_ms=hd.slo_tbt_ms, vnpu=hp.vnpu, plan=hp.plan)
        attached = min(hp.attached_at, hd.attached_at)
        now = max(self._sim_of(hp).now, self._sim_of(hd).now)
        elapsed_s = max(now - attached, 1.0) / core.freq_hz
        rep = _tenant_report(
            shim, merged, ms, merged.requests_done / elapsed_s,
            queued=rp.in_flight + rd.in_flight + ft.in_transit,
            elapsed_cycles=max(now - attached, 0.0))
        rep.n_me = hp.vnpu.config.n_me + hd.vnpu.config.n_me
        rep.n_ve = hp.vnpu.config.n_ve + hd.vnpu.config.n_ve
        return rep

    def latencies_ms(self, handle: Union[TenantHandle, FabricTenant]
                     ) -> List[float]:
        """Completed requests' end-to-end latencies in milliseconds
        (arrival -> completion, queueing included). Fabric pairs merge
        both pools' completions (each request finishes on exactly one
        core)."""
        ms = 1e3 / self.cluster.core.freq_hz
        if isinstance(handle, FabricTenant):
            return [x * ms
                    for x in (self._rt(handle.prefill).stats.latencies
                              + self._rt(handle.decode).stats.latencies)]
        return [x * ms for x in self._rt(handle).stats.latencies]

    def result(self) -> SimResult:
        """Raw simulator snapshot (cycles domain; core 0 — per-core
        snapshots come from ``session.sims[i].result()``)."""
        return self.sim.result()
