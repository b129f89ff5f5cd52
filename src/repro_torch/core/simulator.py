"""Event-driven NPU simulator (§III-G): a policy-agnostic event loop
over μTOp / operator chunks.

Granularity: μTOp events with cycle-accurate durations. An ME μTOp
occupies one ME; a VE μTOp is split into n_y slot-chunks served by
the operation scheduler. HBM bandwidth is shared between tenants with
in-flight memory-demanding μTOps (fair sharing, §III-B). The ME
preemption penalty is the paper's 256 cycles (drain partial sums +
weights of a 128x128 array).

Scheduling disciplines live in :mod:`repro_torch.core.policies` — the
simulator resolves a policy name (or class/instance) through the
registry and delegates every dispatch decision to it. The paper's
four disciplines (``pmt`` / ``v10`` / ``neu10_nh`` / ``neu10``) ship
as built-in registry entries; third parties add more with
``@register_policy``.

Two driving modes:

* **closed loop** (legacy): each tenant re-issues its request the
  moment the previous one completes, until ``n_requests`` — call
  :meth:`Simulator.run`.
* **open loop** (online serving): requests arrive at externally
  injected timestamps (:meth:`Simulator.inject_request`), queue per
  tenant, and latency is measured from *arrival*; tenants can be
  added, removed, and re-sized mid-run — drive with
  :meth:`Simulator.run_until`. The `repro_torch.serve.session` layer builds
  the operator-facing API on top of this.

Requests are *phase chains*: a :class:`TenantSpec` may carry a
:class:`~repro_torch.core.compiler.CompiledRequestPlan` (prefill program +
context-bucketed decode programs). Finishing a phase enqueues the
request's next phase instead of completing it; decode steps from a
tenant's in-flight requests coalesce into shared decode iterations
(continuous batching), and :class:`TenantStats` tracks TTFT / TBT /
end-to-end latency series. A plain single-program spec is the
degenerate one-phase plan — its event sequence is bit-identical to the
pre-phase simulator.

With ``CompiledRequestPlan.iteration_token_budget`` set, iterations
are *budgeted* (SARATHI-SF piggybacking): each one fuses an
adaptively-sized prefill slice with the tenant's live decode batch
into a single program compiled on demand on a quantized grid — see
:meth:`_TenantRT._pick_budgeted` / :meth:`_complete_piggyback` for
the slice sizing and token-accounting rules. Unset, the PR-3 phase
chain engine runs verbatim.

``Simulator(fast_path=...)`` selects between the reference event-loop
implementations and result-identical optimized ones (memoized
dispatch spans, incremental HBM-contention and harvest-squatter
bookkeeping, precomputed μTOp expansion, the tightened neu10 schedule
pass); ``benchmarks/fig25_scaling.py`` pins both the equality and the
speedup.

With ``TenantSpec.kv_policy`` set, KV-cache occupancy is a live
simulator resource: every prefill chunk/slice and decode token
charges its KV bytes against the tenant vNPU's
:class:`~repro_torch.core.vnpu.KVLedger` at the phase boundary, and when
the continuous batch outgrows the tenant's HBM segments a PREMA-style
victim (largest tokens-remaining x bucket-cost estimate) is evicted:
swapped out and later resumed through an HBM re-read program
(``"evict"``), or aborted back to admission (``"reject"``).
``kv_policy=""`` (the default) keeps every path bit-identical to the
static-``hbm_footprint`` engine — the KV goldens pin it.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass, field
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Tuple,
                    Union)

from repro_torch.core.compiler import (DECODE, PIGGYBACK, PREFIX, SWAPIN,
                                 CompiledPhase, CompiledRequestPlan)
from repro_torch.core.neuisa import ME, VE, MuTOpGroup, NeuISAProgram, VLIWProgram
from repro_torch.core.policies import (PolicyLike, pick_eviction_victim,
                                 resolve_policy)
from repro_torch.core.stats import mean as _mean
from repro_torch.core.stats import percentile
from repro_torch.core.vnpu import VNPU
from repro_torch.npu.cost_model import (PIGGYBACK_CHUNK_FLOOR, PIGGYBACK_POS_QUANT,
                                  PIGGYBACK_TOKEN_QUANT, batch_bucket)
from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig

EPS = 1e-9

_ARRIVAL = "arr"  # heap event kind for open-loop request arrivals
_ARRIVAL_K = "arrk"  # arrival carrying a shared-prefix key (payload
                  # side-table, like _MIGRATE — the plain _ARRIVAL
                  # path stays byte-identical when sharing is unused)
_MIGRATE = "mig"  # heap event kind for cross-core decode hand-offs
_ARRIVAL_R = "arrr"  # retried arrival (deadline/fault re-admission):
                  # payload side-table carries (gen_len, prefix_key,
                  # retries, original arrival) — plain arrivals never
                  # touch this path
_WAKE = "wake"    # kick an idle tenant's iteration picker (evacuation
                  # landing on the destination core)
_MIXED = object()  # sentinel: cohort engines span several owners
                  # landing after their fabric transfer delay


def _build_chunk_specs(prog, is_neuisa: bool):
    """Precompute, per group (NeuISA) or op (VLIW), the already-
    filtered (cycles, hbm, name, ...) values `_fill_ready` expands
    into Chunks — pure derived data, identical for every replay of the
    program, cached on the program object by the fast path."""
    specs = []
    if is_neuisa:
        n_y = prog.n_y
        for g in prog.groups:
            mes = [(u.cycles, u.hbm_bytes, u.op_name, 1)
                   for u in g.me_utops
                   if u.cycles > EPS or u.hbm_bytes > EPS]
            ve = None
            u = g.ve_utop
            if u is not None and (u.cycles > EPS or u.hbm_bytes > EPS):
                ve = (u.cycles / n_y, u.hbm_bytes / n_y, u.op_name, n_y,
                      bool(g.me_utops))
            specs.append((mes, ve))
    else:
        for op in prog.ops:
            mes = []
            ve = None
            if op.n_me_static > 0 and (op.me_cycles > EPS
                                       or op.hbm_bytes > EPS):
                mes = [(op.me_cycles, op.hbm_bytes, op.op_name,
                        op.n_me_static)]
            elif op.ve_cycles > EPS or op.hbm_bytes > EPS:
                ve = (op.ve_cycles, op.hbm_bytes, op.op_name, 1, False)
            specs.append((mes, ve))
    return specs


# ----------------------------------------------------------------------
@dataclass(slots=True)
class Chunk:
    """A schedulable unit: one ME μTOp, one VE μTOp slot-chunk, or a
    whole VLIW operator (multi-engine). ``cycles`` is engine cycles of
    work; ``hbm_bytes`` is bytes of HBM traffic; ``penalty`` is
    context-switch cycles added on resume."""

    tenant: int
    kind: str                    # "me" | "ve"
    cycles: float                # per-engine work
    hbm_bytes: float
    op_name: str = ""
    n_engines: int = 1           # VLIW ops seize several engines
    penalty: float = 0.0         # context-switch cycles to add (resume)
    group_key: int = -1          # group (NeuISA) or op (VLIW) index
    from_me_group: bool = False  # VE chunk draining an ME group
    phase: str = ""              # "prefill" | "decode" | "piggyback" | ""
                                 # — visible to SchedulerPolicy dispatch
                                 # decisions
    fused: bool = False          # member of a cross-tenant fused issue
                                 # group (Fig. 6): exempt from reclaim
                                 # preemption while it completes
    n_dispatched: int = 1        # engines the chunk landed on (set by
                                 # dispatch; lets completion skip the
                                 # engine-pool scan for 1-engine μTOps)
    cohort: int = 0              # >1 on the LEAD chunk of a cohort: n
                                 # identical compute-only siblings
                                 # dispatched together under one token
                                 # and one completion event (each
                                 # engine still carries its own chunk;
                                 # set only by the incremental pass)


@dataclass
class TenantSpec:
    """One collocated tenant handed to the :class:`Simulator`: a
    compiled program (or a phase-structured ``plan``), the vNPU whose
    engines it owns/targets, the closed-loop request count, and its
    fair-share ``weight`` (dimensionless priority)."""

    program: Union[NeuISAProgram, VLIWProgram, None] = None
    vnpu: Optional[VNPU] = None
    n_requests: int = 8          # closed-loop target (ignored open loop)
    weight: float = 1.0          # fair-share priority
    # phase-structured requests (prefill -> decode chain); when None,
    # ``program`` runs as a degenerate single-phase plan
    plan: Optional[CompiledRequestPlan] = None
    # live KV-cache accounting policy: "" (off — static hbm_footprint,
    # bit-identical to the ledger-less engine), "evict" (PREMA victim
    # swap-out + HBM re-read resume), or "reject" (victims abort back
    # to admission and restart from scratch)
    kv_policy: str = ""

    def __post_init__(self) -> None:
        if self.program is None and self.plan is None:
            raise ValueError("TenantSpec needs a program or a plan")
        if self.vnpu is None:
            raise ValueError("TenantSpec needs a vnpu")
        if self.kv_policy not in ("", "evict", "reject"):
            raise ValueError(
                f"unknown kv_policy {self.kv_policy!r}; "
                f"use '' (off), 'evict' or 'reject'")


class _Request:
    """One in-flight generation request: its arrival time (cycles),
    target token count, token-emission cursor, and — under chunked
    prefill — how many prefill chunk phases have completed.
    ``prefill_done`` is the token-level ingestion cursor budgeted
    (piggybacked) iterations advance; static chunking counts whole
    phases in ``chunks_done`` instead."""

    __slots__ = ("arrival", "gen_len", "tokens_done", "last_token_t",
                 "chunks_done", "prefill_done", "rid", "ttft_seen",
                 "kv_swapped", "prefix_key", "prefix_ref", "prefix_cached",
                 "deadline", "retries")

    def __init__(self, arrival: float, gen_len: int = 1, rid: int = 0,
                 prefix_key: int = 0):
        self.arrival = arrival
        self.gen_len = max(int(gen_len), 1)
        self.tokens_done = 0
        self.last_token_t = arrival
        self.chunks_done = 0
        self.prefill_done = 0
        self.rid = rid               # KV-ledger allocation key
        self.ttft_seen = False       # first token already sampled (a
                                     # reject-mode restart must not
                                     # re-sample TTFT)
        self.kv_swapped = 0          # bytes to restore on swap-in resume
        self.prefix_key = prefix_key  # shared-prefix group id (0 = none)
        self.prefix_ref = None       # ledger key of the held shared
                                     # entry (None while not admitted)
        self.prefix_cached = 0       # prefix tokens skipped on a hit
                                     # (0 on first-fill: full prefill)
        self.deadline = math.inf     # absolute admission deadline for
                                     # THIS attempt (inf = none)
        self.retries = 0             # re-admissions this request took


@dataclass
class TenantStats:
    """Per-tenant simulation counters.

    Units: every time-valued field (``latencies``, ``completions``,
    ``ttft``, ``tbt``, ``*_work``, ``reclaim_blocked``) is in CYCLES
    of the simulated core clock — divide by ``NPUCoreConfig.freq_hz``
    for seconds (the serve layer's :class:`TenantReport` does this
    once, reporting milliseconds). Token/iteration fields are plain
    counts."""

    name: str
    latencies: List[float] = field(default_factory=list)  # e2e, from arrival
    completions: List[float] = field(default_factory=list)  # finish times
    ttft: List[float] = field(default_factory=list)  # time to first token
    tbt: List[float] = field(default_factory=list)   # time between tokens
    requests_done: int = 0
    tokens: int = 0                  # tokens emitted (1/req + decode steps)
    decode_iterations: int = 0       # shared decode steps executed
    max_decode_batch: int = 0        # peak requests coalesced per step
    prefill_chunks: int = 0          # prefill chunk phases executed
                                     # (0 under monolithic prefill)
    chunk_interleaved_decodes: int = 0  # decode iterations run while a
                                     # same-tenant request sat between
                                     # prefill chunks (SARATHI interleave)
    piggyback_iterations: int = 0    # budgeted iterations that carried a
                                     # prefill slice (0 when the budget
                                     # knob is unset)
    piggyback_decode_tokens: int = 0  # decode tokens emitted riding a
                                     # prefill slice (same iteration)
    max_piggyback_batch: int = 0     # peak decode tokens co-batched with
                                     # one prefill slice
    fused_groups: int = 0            # decode μTOps this tenant co-issued
                                     # into a neighbor's prefill group
    # ---- live KV-cache ledger (all zero with kv_policy unset) ----
    kv_evictions: int = 0            # requests whose KV lost its segments
                                     # under pressure (either kv policy)
    kv_swapins: int = 0              # evicted requests resumed after the
                                     # swap-in HBM re-read ("evict")
    kv_restarts: int = 0             # "reject": victims aborted back to
                                     # admission (re-prefill from token 0)
    kv_rejected: int = 0             # requests dropped outright: their KV
                                     # can never fit the tenant's segments
    kv_truncated: int = 0            # requests force-finished early: no
                                     # co-tenant victim left to evict
    kv_swapped_bytes: float = 0.0    # cumulative bytes swapped out
    # ---- cross-request shared KV prefix (zero with sharing off) ----
    kv_prefix_hits: int = 0          # admissions that found their prefix
                                     # resident (suffix-only prefill)
    kv_shared_bytes: float = 0.0     # cumulative prefix bytes those hits
                                     # did NOT re-charge (re-use volume)
    # ---- cross-tenant HBM borrowing (zero with borrowing off) ----
    kv_borrowed_bytes: float = 0.0   # cumulative bytes granted to this
                                     # tenant from idle peer segments
    kv_reclaimed_bytes: float = 0.0  # cumulative lent bytes pulled back
                                     # when this tenant hit pressure
    # ---- cross-core fabric migration (zero off-fabric) ----
    kv_migrations: int = 0           # prefill->decode hand-offs this
                                     # tenant's requests took to another
                                     # core's decode pool
    kv_migrated_bytes: float = 0.0   # KV bytes those hand-offs moved
                                     # over the inter-core links
    cross_core_hops: int = 0         # fabric hops those hand-offs
                                     # traversed (cumulative)
    kv_migration_rejects: int = 0    # hand-offs refused on DESTINATION
                                     # ledger pressure (request decoded
                                     # locally instead)
    kv_peak_bytes: float = 0.0       # peak ledger occupancy (bytes,
                                     # weights + live KV)
    kv_peak_segments: int = 0        # peak HBM isolation segments occupied
    me_work: float = 0.0
    ve_work: float = 0.0
    harvested_me_work: float = 0.0   # work done on non-owned MEs
    harvested_ve_work: float = 0.0
    reclaim_blocked: float = 0.0     # Table III: stall due to being
                                     # harvested (reclaim ctx windows)
    preemptions: int = 0
    # ---- fault injection / failover (all zero with faults off) ----
    faults_survived: int = 0         # injected faults this tenant rode
                                     # out without losing completed work
    evacuations: int = 0             # whole-vNPU migrations to another
                                     # core after a core fault
    evacuated_bytes: float = 0.0     # live KV bytes those evacuations
                                     # carried over the fabric
    hbm_fault_segments: int = 0      # HBM isolation segments lost to
                                     # segment faults (vNPU shrunk)
    deadline_misses: int = 0         # requests that timed out in the
                                     # admission queue
    retries: int = 0                 # re-admissions scheduled (deadline
                                     # misses + fault aborts with retry
                                     # budget left) — distinct from
                                     # kv_restarts
    retry_successes: int = 0         # retried requests that completed
    retries_exhausted: int = 0       # requests dropped after their
                                     # last retry also failed
    downtime_cycles: float = 0.0     # cycles this tenant spent frozen
                                     # by faults (evacuation transfers,
                                     # suspend-until-recovery gaps)

    def p95(self) -> float:
        """p95 of end-to-end request latency, in cycles."""
        return percentile(self.latencies, 0.95)

    def mean(self) -> float:
        """Mean end-to-end request latency, in cycles."""
        return _mean(self.latencies)

    def ttft_p95(self) -> float:
        """p95 time-to-first-token, in cycles."""
        return percentile(self.ttft, 0.95)

    def tbt_p95(self) -> float:
        """p95 time-between-tokens, in cycles."""
        return percentile(self.tbt, 0.95)


@dataclass
class SimResult:
    """Simulation outcome. ``makespan`` is in CYCLES (like every
    TenantStats series); ``freq_hz`` is the core clock, carried so
    reporting layers convert to wall time exactly once
    (:func:`throughput` already returns requests/SECOND)."""

    policy: str
    makespan: float              # cycles until every tenant hit N reqs
    tenants: List[TenantStats]
    n_me: int
    n_ve: int
    freq_hz: float

    def me_utilization(self) -> float:
        denom = self.n_me * self.makespan
        if denom <= 0:
            return 0.0           # empty open-loop run: no work, no span
        return sum(t.me_work for t in self.tenants) / denom

    def ve_utilization(self) -> float:
        denom = self.n_ve * self.makespan
        if denom <= 0:
            return 0.0
        return sum(t.ve_work for t in self.tenants) / denom

    def throughput(self, idx: int) -> float:
        """requests/sec for tenant idx over the makespan."""
        if self.makespan <= 0 or self.freq_hz <= 0:
            return 0.0
        t = self.tenants[idx]
        return t.requests_done / (self.makespan / self.freq_hz)

    def total_throughput(self) -> float:
        return sum(self.throughput(i) for i in range(len(self.tenants)))


# ----------------------------------------------------------------------
class _Engine:
    __slots__ = ("kind", "eid", "owner", "token", "chunk", "tenant",
                 "start", "end", "harvested")

    def __init__(self, kind: str, eid: int, owner: Optional[int]):
        self.kind = kind
        self.eid = eid
        self.owner = owner       # tenant idx (spatial) or None
        self.token: int = -1     # generation counter; -1 = free
        self.chunk: Optional[Chunk] = None
        self.tenant: int = -1
        self.start = 0.0
        self.end = 0.0
        self.harvested = False

    @property
    def free(self) -> bool:
        return self.token < 0


class _TenantRT:
    """Runtime over a tenant's request plan.

    Requests move waiting -> (prefill iteration(s)) -> decoding ->
    (shared decode iterations) -> done. One *iteration* (a phase
    program execution) is in flight at a time per tenant; decode
    iterations coalesce every in-flight decoding request (continuous
    batching). Under chunked prefill a request's prefill is a CHAIN of
    chunk iterations: after each non-final chunk the request parks in
    ``prefilling`` and, if decodes are live, the tenant yields one
    decode iteration before the next chunk — so a long prompt no
    longer head-of-line blocks the tenant's own token cadence. Closed
    loop: a new request arrives the instant the previous one
    completes. Open loop: requests arrive via :meth:`arrive` and the
    tenant idles between iterations (``in_request`` False)."""

    def __init__(self, idx: int, spec: TenantSpec, core: NPUCoreConfig,
                 open_loop: bool = False, fast_path: bool = True):
        self.idx = idx
        self.spec = spec
        self.core = core
        self.open_loop = open_loop
        self.fast_path = fast_path
        self.removed = False
        if spec.plan is not None:
            self.plan = spec.plan
        else:  # degenerate one-phase plan: seed-identical behavior
            self.plan = CompiledRequestPlan(
                name=spec.program.name,
                prefill=CompiledPhase("", spec.program), gen_len=1)
        self.cur_program = self.plan.prefill.program
        self.is_neuisa = isinstance(self.cur_program, NeuISAProgram)
        self.me_ids = set(spec.vnpu.me_ids)
        self.ve_ids = set(spec.vnpu.ve_ids)
        self.stats = TenantStats(name=self.plan.name)
        self.active_cycles = 0.0          # fair-share bookkeeping
        self.cursor = -1                  # group / op index
        self.outstanding = 0              # chunks of current step in flight
        self.in_request = False           # an iteration is in flight
        self.waiting: Deque[_Request] = deque()   # arrived, not prefilled
        self.prefilling: List[_Request] = []      # between prefill chunks
        self.decoding: List[_Request] = []        # mid-generation
        self.active: List[_Request] = []          # served by the iteration
        self.active_kind = ""                     # phase of the iteration
        self.yield_to_decode = False      # chunk boundary: run one decode
                                          # iteration before the next chunk
        # budgeted (piggybacked) iterations
        self.piggy_req: Optional[_Request] = None  # slice owner this iter
        self.piggy_slice = 0              # prompt tokens this slice ingests
        self.force_prefill = False        # a decode-only iteration just ran
                                          # because the batch ate the whole
                                          # budget: floor the next slice
        # live KV accounting (inert unless the spec sets a kv_policy
        # AND the plan carries per-token KV bytes)
        self.kv_policy = spec.kv_policy
        self.kv_enabled = bool(spec.kv_policy) \
            and self.plan.kv_token_bytes > 0
        if (self.kv_enabled and self.kv_policy == "evict"
                and not self.plan.can_swapin):
            raise ValueError(
                f"tenant plan {self.plan.name!r} has no swap-in builder; "
                f"kv_policy='evict' needs one (compile the plan from a "
                f"trace-layer request_plan)")
        self.swapped: List[_Request] = []  # evicted, awaiting swap-in
        # cross-request shared KV prefix: on when the plan carries a
        # prefix builder AND KV accounting is live (sharing is a
        # ledger feature); requests opt in per-arrival via prefix_key
        self.prefix_enabled = (self.kv_enabled and self.plan.prefix_len > 0
                               and self.plan.can_prefix)
        # cross-tenant HBM borrowing: the serving layer installs a
        # relief callback (needed_bytes -> bytes freed); a failed
        # ledger charge retries ONCE after the hook reclaims lent
        # segments and/or borrows idle peer segments. None (default)
        # keeps every charge path bit-identical.
        self.kv_pressure_hook: Optional[Callable[[float], float]] = None
        # cluster fabric: called when a request finishes prefill and
        # decode steps remain — returning True means the hand-off was
        # taken (the request continues on another core's decode pool);
        # False / None keeps the PR-3 local-decode path bit-identical
        self.migrate_hook: Optional[Callable[["_TenantRT", _Request,
                                              float], bool]] = None
        self._rid = itertools.count()      # per-request ledger keys
        self._t = 0.0                      # time of the current pick
        # deadline/retry admission (inert at the 0 defaults: no sweep
        # runs, no deadline is stamped — bit-identical to the
        # pre-fault engine)
        self.deadline_cycles = 0.0         # per-attempt admission
                                           # deadline (0 = none)
        self.max_retries = 0               # re-admission budget
        # serving-layer callback that schedules the re-admission of a
        # timed-out / fault-aborted request (backoff + re-injection);
        # None drops the request after counting the miss
        self.retry_hook: Optional[Callable[[_Request, float],
                                           None]] = None
        # failover: an evacuated tenant stays parked until its bulk
        # state transfer lands (the session's inject_wake un-parks it);
        # 0.0 never freezes — bit-identical to the pre-fault engine
        self.frozen_until = 0.0
        self.ready_me: List[Chunk] = []
        self.ready_ve: List[Chunk] = []
        # incremental scheduling: the simulator swaps in its shared
        # dirty set at add_tenant so ready-queue growth marks the
        # tenant without a callback (standalone _TenantRT construction
        # in tests keeps the private default)
        self._dirty_sink: set = set()
        self.loop_remaining: Dict[int, int] = {}
        self.done = False                 # reached n_requests (keeps running)
        self.finished_at = math.inf

    # ---------------- request / phase lifecycle ----------------
    @property
    def in_flight(self) -> int:
        """Requests admitted but not completed."""
        n = (len(self.waiting) + len(self.prefilling)
             + len(self.decoding) + len(self.swapped))
        if self.in_request:
            if self.active_kind == PIGGYBACK:
                n += 1   # the slice owner; co-riders stay in `decoding`
            elif self.active_kind not in (DECODE, SWAPIN):
                n += len(self.active)
            elif self.active_kind == SWAPIN:
                n += 1   # the resuming request left every queue
        return n

    def _context_of(self, req: _Request) -> int:
        """KV context of the request's NEXT decode step."""
        return self.plan.prompt_len + req.tokens_done + 1

    def _new_request(self, arrival: float, gen_len: int,
                     prefix_key: int = 0) -> _Request:
        req = _Request(arrival, gen_len, rid=next(self._rid),
                       prefix_key=prefix_key)
        if self.deadline_cycles > 0:
            req.deadline = arrival + self.deadline_cycles
        return req

    def start_request(self, t: float, arrival: Optional[float] = None,
                      gen_len: Optional[int] = None,
                      prefix_key: int = 0) -> None:
        """Admit one request (closed-loop kick / legacy entry point)."""
        self.waiting.append(self._new_request(
            t if arrival is None else arrival,
            self.plan.gen_len if gen_len is None else gen_len,
            prefix_key=prefix_key))
        if not self.in_request:
            self._start_iteration(t)

    def _start_iteration(self, t: float) -> None:
        """Pick the tenant's next unit of work. With an
        ``iteration_token_budget`` set, every iteration is *budgeted*:
        a prefill slice sized to the live decode load piggybacks the
        tenant's decode tokens in one fused program
        (:meth:`_pick_budgeted`). Otherwise the PR-3 phase chain
        rules apply verbatim (:meth:`_pick_phase`): a decode iteration
        if a prefill chunk just yielded, else the next prefill chunk
        of the request mid-prefill, else a waiting request's (first)
        prefill, else one shared decode step over every in-flight
        decoding request. KV-accounted tenants route through the
        ledger-aware variants (:meth:`_pick_phase_kv`, or the gated
        checks inside :meth:`_pick_budgeted`)."""
        self._t = t
        if t < self.frozen_until:
            return   # evacuation transfer in flight: stay parked
        if self.deadline_cycles > 0 and self.waiting:
            self._sweep_deadlines(t)
        budgeted = (self.plan.iteration_token_budget > 0
                    and self.plan.can_piggyback)
        if budgeted:
            picked = self._pick_budgeted()
        elif self.kv_enabled:
            picked = self._pick_phase_kv()
        else:
            picked = self._pick_phase()
        if not picked:
            return
        self.in_request = True
        self.cursor = -1
        self.loop_remaining = {}
        self._advance(t)

    def _sweep_deadlines(self, t: float) -> None:
        """Drop admission-queue requests whose per-attempt deadline
        lapsed (deadline/retry admission — only requests still WAITING
        time out; work in flight always runs to completion). Each miss
        either re-enters admission through the serving layer's retry
        hook (bounded budget, exponential backoff) or is dropped."""
        expired = [r for r in self.waiting if r.deadline <= t]
        if not expired:
            return
        led = self._kv_led()
        st = self.stats
        for req in expired:
            self.waiting.remove(req)
            if led is not None:
                # waiting requests hold no KV by invariant; lenient
                # release keeps that true even across future churn
                led.release(req.rid)
                self._kv_prefix_release(led, req)
            st.deadline_misses += 1
            self.retry_or_drop(req, t)

    def retry_or_drop(self, req: _Request, t: float) -> None:
        """Route a timed-out or fault-aborted request back to
        admission when retry budget remains (the serving layer's hook
        schedules the backoff + re-injection); count the exhaustion
        otherwise. With no hook installed the request just drops."""
        hook = self.retry_hook
        if hook is None:
            return
        if req.retries < self.max_retries:
            hook(req, t)
        else:
            self.stats.retries_exhausted += 1

    def arrive_retry(self, t: float, gen_len: Optional[int] = None,
                     prefix_key: int = 0, retries: int = 1,
                     orig_arrival: float = 0.0,
                     ttft_seen: bool = False) -> None:
        """A re-admission lands after its backoff: end-to-end latency
        still spans the ORIGINAL arrival, the per-attempt deadline
        restarts from now, and a first token already emitted by a
        fault-aborted attempt is never re-sampled into TTFT."""
        if self.removed:
            return
        req = self._new_request(orig_arrival,
                                self.plan.gen_len if gen_len is None
                                else gen_len,
                                prefix_key=prefix_key)
        req.retries = retries
        req.ttft_seen = ttft_seen
        if self.deadline_cycles > 0:
            req.deadline = t + self.deadline_cycles
        if retries > 0:
            # retries == 0 is a re-sequenced arrival (a pending arrival
            # replayed after a suspend gap keeps its original timestamp
            # this way) — not a re-admission, so it doesn't count
            self.stats.retries += 1
        self.waiting.append(req)
        if not self.in_request:
            self._start_iteration(t)

    def abort_iteration(self, t: float) -> List[_Request]:
        """Cancel the in-flight iteration (core fault): every served
        request lands back in a queue with its ledger charges
        consistent. Decode riders keep their KV and stay in
        ``decoding`` — only the step's un-emitted token is lost; a
        swap-in resumer returns to the FRONT of ``swapped`` with its
        bytes released again; a prefill / prefix / piggyback owner
        loses the attempt's charges, resets its cursors, and parks at
        the front of ``waiting``. Returns the requests whose attempt
        was lost (fault-abort retry candidates)."""
        if not self.in_request:
            return []
        led = self._kv_led()
        lost: List[_Request] = []
        kind = self.active_kind
        if kind == DECODE:
            pass
        elif kind == SWAPIN:
            req = self.active[0]
            if led is not None:
                req.kv_swapped = led.release(req.rid)
            self.swapped.insert(0, req)
        else:
            req = self.piggy_req if kind == PIGGYBACK else self.active[0]
            if led is not None:
                led.release(req.rid)
                self._kv_prefix_release(led, req)
            req.tokens_done = 0
            req.prefill_done = 0
            req.chunks_done = 0
            self.waiting.appendleft(req)
            lost.append(req)
        self.piggy_req = None
        self.piggy_slice = 0
        self.active = []
        self.active_kind = ""
        self.in_request = False
        self.outstanding = 0
        self.ready_me.clear()
        self.ready_ve.clear()
        return lost

    def _pick_phase(self) -> bool:
        """PR-3 iteration selection (budget unset) — bit-identical to
        the pre-budget engine. Returns False when the tenant idles."""
        if not self.decoding:
            self.yield_to_decode = False   # nothing to yield to
        pick_decode = self.decoding and (
            self.yield_to_decode or not (self.prefilling or self.waiting))
        if not pick_decode and (self.prefilling or self.waiting):
            if self.prefilling:
                req = self.prefilling.pop(0)
            else:
                req = self.waiting.popleft()
            if req.prefill_done:
                # the budget knob was disabled while this request was
                # mid-slice: the unset engine only has whole-prompt /
                # whole-chunk programs, so ingestion RESTARTS from
                # token 0 (partial KV dropped, cost paid explicitly —
                # see ServingSession.set_iteration_token_budget)
                req.prefill_done = 0
            self.active = [req]
            phases = self.plan.prefill_phases()
            ph = phases[min(req.chunks_done, len(phases) - 1)]
            self.active_kind = ph.kind
            self.cur_program = ph.program
        elif self.decoding:
            self._begin_decode()
        else:
            return False
        return True

    # ---------------- live KV-cache ledger ----------------
    def _kv_led(self):
        """The tenant vNPU's live ledger, or None when KV accounting
        is off (re-read per call: a live resize swaps the vNPU — and
        its migrated ledger — under the runtime)."""
        if not self.kv_enabled:
            return None
        v = self.spec.vnpu
        return None if v is None else v.kv_ledger

    def _kv_charge(self, led, req: _Request, nbytes: float) -> bool:
        """Charge ``nbytes`` of KV growth to ``req``; mirrors the
        ledger's peak occupancy into the tenant stats. A failed charge
        retries ONCE after the serving layer's pressure hook (reclaim
        lent segments / borrow idle peer segments) frees bytes."""
        if nbytes <= 0:
            return True
        if not led.alloc(req.rid, nbytes):
            # retired (zero-holder, retained) prefix entries are the
            # cheapest victims: no live request loses state
            if led.retired:
                led.evict_retired(nbytes - led.available, now=self._t)
            if led.alloc(req.rid, nbytes):
                self._kv_mark_peaks(led)
                return True
            hook = self.kv_pressure_hook
            if hook is None or hook(nbytes - led.available) <= 0:
                return False
            if not led.alloc(req.rid, nbytes):
                return False
        self._kv_mark_peaks(led)
        return True

    def _kv_mark_peaks(self, led) -> None:
        st = self.stats
        if led.peak_bytes > st.kv_peak_bytes:
            st.kv_peak_bytes = led.peak_bytes
        if led.peak_segments > st.kv_peak_segments:
            st.kv_peak_segments = led.peak_segments

    # ---------------- cross-request shared KV prefix ----------------
    def _kv_prefix_bytes(self) -> float:
        return self.plan.prefix_len * self.plan.kv_token_bytes

    def _kv_prefix_attach(self, led, req: _Request) -> Optional[str]:
        """Transactionally take a shared-prefix reference for ``req``'s
        admission attempt. Returns ``"hit"`` (prefix resident: bump the
        refcount, the prefill skips the cached tokens and the rid
        charge covers only the suffix), ``"fill"`` (first holder: the
        prefix bytes charge all-or-nothing into the shared entry, the
        request runs full prefill but its rid still carries only the
        suffix), or None (no room to first-fill even after pressure
        relief — the caller proceeds unshared). The caller MUST undo a
        successful attach with :meth:`_kv_prefix_release` if the rest
        of the admission fails, so a parked request never pins the
        sole reference to an entry nobody is using. Hit stats are the
        caller's job (counted once, on the attempt that admits)."""
        key = req.prefix_key
        pbytes = self._kv_prefix_bytes()
        if led.shared_refs(key) > 0 or key in led.retired:
            # resident OR retained with zero holders: both are hits —
            # the retained entry's bytes never left
            led.acquire_shared(key, pbytes)
            req.prefix_ref = key
            req.prefix_cached = self.plan.prefix_len
            return "hit"
        if not led.acquire_shared(key, pbytes):
            if led.retired:
                led.evict_retired(pbytes - led.available, now=self._t)
            if not led.acquire_shared(key, pbytes):
                hook = self.kv_pressure_hook
                if hook is None or hook(pbytes - led.available) <= 0:
                    return None
                if not led.acquire_shared(key, pbytes):
                    return None
        req.prefix_ref = key
        req.prefix_cached = 0
        self._kv_mark_peaks(led)
        return "fill"

    def _kv_prefix_release(self, led, req: _Request) -> float:
        """Drop ``req``'s shared-prefix reference (no-op when it holds
        none). Returns the bytes freed (non-zero only on the LAST
        release)."""
        if req.prefix_ref is None or led is None:
            return 0.0
        freed = led.release_shared(req.prefix_ref, now=self._t)
        req.prefix_ref = None
        req.prefix_cached = 0
        return freed

    def _kv_phase_tokens(self, req: _Request) -> int:
        """Prompt tokens the request's NEXT prefill phase ingests
        (whole prompt when monolithic; this chunk's share when
        chunked) — the prefill-side KV write charged at admission."""
        phases = self.plan.prefill_phases()
        i = min(req.chunks_done, len(phases) - 1)
        prev = phases[i - 1].context if i > 0 else 0
        return max(phases[i].context - prev, 0)

    def _kv_evict_one(self, t: float,
                      exclude: Optional[_Request] = None) -> bool:
        """Free one victim's KV segments under pressure. The victim is
        the PREMA-style pick (largest tokens-remaining x bucket-cost
        service estimate — see
        :func:`repro_torch.core.policies.pick_eviction_victim`); under
        ``"evict"`` its KV swaps out (HBM re-read on resume), under
        ``"reject"`` it aborts back to admission and restarts from
        token 0. Retired (zero-holder, retained) prefix entries go
        FIRST — freeing one costs no live request its state. Returns
        False when no candidate exists."""
        led = self._kv_led()
        if led is not None and led.retired \
                and led.evict_retired(1, now=t) > 0:
            return True
        cands = [r for r in self.decoding if r is not exclude]
        if not cands:
            return False
        refs_of = None
        if self.prefix_enabled:
            # shared-prefix holders whose entry other live requests
            # still reference go LAST: evicting them cannot free the
            # shared segments (the refcount keeps them resident)
            def refs_of(r):
                return (led.shared_refs(r.prefix_ref)
                        if r.prefix_ref is not None else 0)
        victim = pick_eviction_victim(cands, self.plan, self._context_of,
                                      shared_refs_of=refs_of)
        self.decoding.remove(victim)
        freed = led.release(victim.rid)
        st = self.stats
        st.kv_evictions += 1
        if self.kv_policy == "evict":
            if (victim.prefix_ref is not None
                    and led.shared_refs(victim.prefix_ref) <= 1):
                # sole holder: the shared entry swaps out with it (the
                # resume recharges prefix + suffix through the rid;
                # sharing for this key restarts at the next first-fill)
                freed += self._kv_prefix_release(led, victim)
            victim.kv_swapped = freed
            st.kv_swapped_bytes += freed
            self.swapped.append(victim)
        else:
            st.kv_restarts += 1
            self._kv_prefix_release(led, victim)
            victim.tokens_done = 0
            victim.prefill_done = 0
            victim.chunks_done = 0
            self.waiting.appendleft(victim)
        return True

    def _kv_admit_decode(self, t: float) -> None:
        """Charge one token of KV growth per decoding request (the
        token the next shared iteration emits). When the batch's
        growth outgrows the tenant's segments, evict victims until
        the remainder fits; a lone request that cannot grow is
        force-finished (single-request OOM) rather than deadlocked."""
        led = self._kv_led()
        if led is None or not self.decoding:
            return
        per = self.plan.kv_token_bytes
        charged = set()
        idx = 0
        while idx < len(self.decoding):
            req = self.decoding[idx]
            if req.rid in charged or self._kv_charge(led, req, per):
                charged.add(req.rid)
                idx += 1
                continue
            if self._kv_evict_one(t, exclude=req):
                idx = 0   # indices shifted; `charged` skips re-charges
                continue
            self.decoding.pop(idx)
            self.stats.kv_truncated += 1
            self._complete_request(req, t)

    def _kv_try_swapin(self, t: float):
        """Resume the longest-parked evicted request when its KV fits
        again, with one decode round of headroom so the resume does
        not instantly re-trigger the eviction it came from. Returns
        True (swap-in iteration set up), None (a permanently
        unfittable request was dropped — caller retries), or False
        (nothing to resume / still no room)."""
        if not self.swapped:
            return False
        led = self._kv_led()
        req = self.swapped[0]
        need = req.kv_swapped
        if need > led.capacity - led.reserved:
            # a shrink-resize left this context permanently unfittable
            self.swapped.pop(0)
            self.stats.kv_truncated += 1
            self._complete_request(req, t)
            return None
        headroom = (len(self.decoding) + 1) * self.plan.kv_token_bytes
        headroom = min(headroom, max(led.capacity - led.reserved - need, 0))
        if not led.fits(need + headroom):
            if not led.retired:
                return False
            led.evict_retired(need + headroom - led.available, now=t)
            if not led.fits(need + headroom):
                return False
        self.swapped.pop(0)
        self._kv_charge(led, req, need)
        req.kv_swapped = 0
        ph = self.plan.swapin_phase(self.plan.prompt_len + req.tokens_done)
        self.active = [req]
        self.active_kind = SWAPIN
        self.cur_program = ph.program
        return True

    def _kv_admit_prefill(self):
        """Admission under the ledger: start the next prefill
        chunk/prompt only if its KV write fits. Returns True
        (iteration set up), None (an unfittable request was dropped —
        caller retries), or False (blocked on memory / nothing to
        admit; FIFO order is preserved)."""
        if not (self.prefilling or self.waiting):
            return False
        led = self._kv_led()
        from_prefilling = bool(self.prefilling)
        req = (self.prefilling.pop(0) if from_prefilling
               else self.waiting.popleft())
        if req.prefill_done:
            # budget knob disabled mid-slice: ingestion restarts from
            # token 0 (same rule as _pick_phase) — the partial KV is
            # dropped, so its ledger share (and any shared-prefix
            # reference the slices held) frees too
            req.prefill_done = 0
            led.release(req.rid)
            self._kv_prefix_release(led, req)
        tokens = self._kv_phase_tokens(req)
        attach = None
        if (self.prefix_enabled and req.prefix_key
                and not self.plan.chunked and req.chunks_done == 0):
            attach = self._kv_prefix_attach(led, req)
            if attach is not None:
                # the prefix bytes live in the shared entry (first-fill
                # charged them there just now, or a hit found them
                # resident): the rid carries only the unshared suffix
                tokens -= self.plan.prefix_len
        need = tokens * self.plan.kv_token_bytes
        if self._kv_charge(led, req, need):
            self.active = [req]
            if attach == "hit":
                self.stats.kv_prefix_hits += 1
                self.stats.kv_shared_bytes += self._kv_prefix_bytes()
                ph = self.plan.prefix_phase(req.prefix_cached)
            else:
                phases = self.plan.prefill_phases()
                ph = phases[min(req.chunks_done, len(phases) - 1)]
            self.active_kind = ph.kind
            self.cur_program = ph.program
            return True
        # cumulative fit check: can the request's UNSHARED bytes (plus
        # the prefix share a first-fill would hold) ever fit? With no
        # shared reference this is the whole prompt — the pre-sharing
        # rule verbatim.
        cum = self.plan.kv_prompt_bytes
        if attach == "hit":
            cum = need
        if cum > led.capacity - led.reserved:
            # the request can never fit this tenant's segments
            # (checked cumulatively, not per chunk — a request whose
            # chunks fit one at a time but whose total cannot would
            # otherwise wedge mid-prefill holding partial KV):
            # admission reject, surfaced through kv_rejected
            led.release(req.rid)
            self._kv_prefix_release(led, req)
            self.stats.kv_rejected += 1
            return None
        # blocked on memory: undo the attach (a parked request must
        # not pin the sole reference) and keep FIFO order
        self._kv_prefix_release(led, req)
        if from_prefilling:
            self.prefilling.insert(0, req)
        else:
            self.waiting.appendleft(req)
        return False

    def _pick_phase_kv(self) -> bool:
        """Ledger-aware iteration selection (KV accounting on, budget
        unset): the PR-3 phase rules extended with swap-in resumes,
        prompt-KV admission gating, and decode-growth charging with
        PREMA eviction. KV-disabled tenants never enter here — their
        scheduling stays bit-identical (:meth:`_pick_phase`)."""
        t = self._t
        for _ in range(100_000):
            if not self.decoding:
                self.yield_to_decode = False   # nothing to yield to
            pick_decode = self.decoding and (
                self.yield_to_decode
                or not (self.prefilling or self.waiting or self.swapped))
            if not pick_decode:
                got = self._kv_try_swapin(t)
                if got:
                    return True
                if got is None:
                    continue
                got = self._kv_admit_prefill()
                if got:
                    return True
                if got is None:
                    continue
            if self.decoding:
                self._kv_admit_decode(t)
                if self.decoding:
                    self._begin_decode()
                    return True
                continue   # batch dissolved under pressure: re-pick
            return False
        raise RuntimeError("KV admission livelock")   # pragma: no cover

    def _begin_decode(self) -> None:
        """Set up one shared decode iteration over every in-flight
        decoding request. The step's cost is the largest live context
        bucket: the batched KV stream is paced by the longest
        sequence."""
        ctx = max(self._context_of(r) for r in self.decoding)
        phase = self.plan.decode_phase_for(ctx)
        self.active = list(self.decoding)
        self.active_kind = DECODE
        self.cur_program = phase.program
        self.yield_to_decode = False

    def _pick_budgeted(self) -> bool:
        """Adaptive per-iteration token budget (SARATHI-SF
        piggybacking): one iteration serves a prefill slice of
        ``budget - live decode batch`` prompt tokens AND the decode
        batch, as one fused program — decoding requests keep their
        token cadence through a neighbor request's prefill instead of
        waiting out whole chunk iterations.

        Floor/cap rules guarantee progress both ways: when the
        (bucketed) decode batch eats the budget to under
        ``PIGGYBACK_CHUNK_FLOOR`` tokens, ONE decode-only iteration
        runs and the next slice is floored — prefill always advances
        every other iteration; the slice is capped at the remaining
        prompt (the final slice may be partial). Program cost is
        looked up on the quantized grid (slice tokens, position,
        batch bucket, per-rider context buckets) while token
        bookkeeping stays exact.

        KV-accounted tenants additionally charge the ledger here:
        riders' decode growth first (with PREMA eviction under
        pressure), then the slice's prompt-KV write — a slice shrinks
        to the bytes available (never below the floor; with no room
        for even a floored slice the prompt parks and the decode
        cadence continues; a prompt whose TOTAL KV can never fit is
        rejected). Returns False when the tenant idles."""
        t = self._t
        led = self._kv_led()
        for _ in range(100_000):   # bounded: each retry dropped or
            if led is not None:    # evicted a request
                got = self._kv_try_swapin(t)
                if got:
                    return True
                if got is None:
                    continue       # a parked request dropped: re-pick
            if not (self.prefilling or self.waiting):
                if not self.decoding:
                    return False
                if led is not None:
                    self._kv_admit_decode(t)
                    if not self.decoding:
                        continue   # batch dissolved: re-pick
                self._begin_decode()    # no prompt left to slice
                return True
            budget = self.plan.iteration_token_budget
            if led is not None and self.decoding:
                # every budgeted iteration below serves the live batch
                # (fused or decode-only): charge its growth now
                self._kv_admit_decode(t)
            batch = len(self.decoding)
            bb = batch_bucket(batch)
            slice_ = budget - bb
            if (batch and slice_ < PIGGYBACK_CHUNK_FLOOR
                    and not self.force_prefill):
                # over-subscribed: the decode batch alone fills the
                # budget
                self.force_prefill = True
                self._begin_decode()
                return True
            self.force_prefill = False
            from_prefilling = bool(self.prefilling)
            if from_prefilling:
                req = self.prefilling.pop(0)
            else:
                req = self.waiting.popleft()
            attach = None
            if (self.prefix_enabled and req.prefix_key and led is not None
                    and req.prefill_done == 0 and req.prefix_ref is None):
                attach = self._kv_prefix_attach(led, req)
                if attach == "hit":
                    # resident prefix: slices start past the cached
                    # tokens (the quantized piggyback grid prices the
                    # suffix at its true kv_prior position)
                    req.prefill_done = req.prefix_cached
            shared_skip = (self.plan.prefix_len
                           if req.prefix_ref is not None else 0)
            remaining = max(self.plan.prompt_len - req.prefill_done, 1)
            slice_ = min(max(slice_, min(PIGGYBACK_CHUNK_FLOOR, remaining)),
                         remaining)
            if led is not None:
                per = self.plan.kv_token_bytes
                floor_tok = min(PIGGYBACK_CHUNK_FLOOR, remaining)
                cum = self.plan.kv_prompt_bytes
                if attach == "hit":
                    cum = (self.plan.prompt_len - shared_skip) * per
                if cum > led.capacity - led.reserved:
                    # the request's unshared bytes can never fit
                    # (cumulative check, like _kv_admit_prefill):
                    # reject
                    led.release(req.rid)
                    self._kv_prefix_release(led, req)
                    self.stats.kv_rejected += 1
                    continue
                # tokens below the shared boundary are already paid in
                # the shared entry: they cost the rid nothing, so the
                # slice fit is free tokens + what the available bytes
                # cover (identical to the pre-sharing rule when no
                # reference is held)
                free_tok = max(shared_skip - req.prefill_done, 0)
                fit = (free_tok + int(led.available // per)
                       if per > 0 else slice_)
                if fit < floor_tok and led.retired:
                    # retained zero-holder entries give way before a
                    # prompt parks
                    led.evict_retired(
                        (floor_tok - free_tok) * per - led.available, now=t)
                    fit = (free_tok + int(led.available // per)
                           if per > 0 else slice_)
                if fit < floor_tok:
                    # no memory for even a floored slice: the prompt
                    # waits for admission (dropping a just-taken
                    # reference so it never pins the sole holder);
                    # decode cadence keeps running
                    if attach is not None:
                        self._kv_prefix_release(led, req)
                        if attach == "hit":
                            req.prefill_done = 0
                    if from_prefilling:
                        self.prefilling.insert(0, req)
                    else:
                        self.waiting.appendleft(req)
                    if self.decoding:
                        self._begin_decode()
                        return True
                    return False
                slice_ = min(slice_, fit)
                lo = req.prefill_done
                chargeable = max(lo + slice_ - max(lo, shared_skip), 0)
                self._kv_charge(led, req, chargeable * per)
                if attach == "hit":
                    self.stats.kv_prefix_hits += 1
                    self.stats.kv_shared_bytes += self._kv_prefix_bytes()
            final = req.prefill_done + slice_ >= self.plan.prompt_len
            q = PIGGYBACK_TOKEN_QUANT
            cost_tokens = -(-slice_ // q) * q
            pq = PIGGYBACK_POS_QUANT
            pos = -(-req.prefill_done // pq) * pq if req.prefill_done else 0
            phase = self._piggyback_phase_for(cost_tokens, pos, final)
            self.active = [req] + (list(self.decoding)
                                   if self.decoding else [])
            self.piggy_req = req
            self.piggy_slice = slice_
            self.active_kind = PIGGYBACK
            self.cur_program = phase.program
            self.yield_to_decode = False
            return True
        raise RuntimeError("KV admission livelock")   # pragma: no cover

    def _piggyback_phase_for(self, cost_tokens: int, pos: int,
                             final: bool) -> CompiledPhase:
        """Fused-phase lookup for the live decode batch. Riders are
        costed at their OWN context bucket: the batch is grouped per
        bucket and each group's decode share priced there, so a
        small-context rider no longer pays the largest live bucket's
        KV stream. A single-bucket batch keeps the legacy
        (batch-bucket, ctx) cache key — those programs stay
        byte-identical to the pre-grouping engine."""
        if not self.decoding:
            return self.plan.piggyback_phase(cost_tokens, pos, 0, 0, final)
        per: Dict[int, int] = {}
        for r in self.decoding:
            c = self.plan.decode_phase_for(self._context_of(r)).context
            per[c] = per.get(c, 0) + 1
        bb = batch_bucket(len(self.decoding))
        if len(per) == 1:
            ctx = next(iter(per))
            return self.plan.piggyback_phase(cost_tokens, pos, bb, ctx,
                                             final)
        groups = tuple((batch_bucket(n), c) for c, n in sorted(per.items()))
        return self.plan.piggyback_phase(cost_tokens, pos, 0, 0, final,
                                         decode_groups=groups)

    def _on_iteration_complete(self, t: float) -> None:
        """A phase program finished: emit tokens, advance each served
        request's phase chain, then start the next iteration. A
        non-final prefill chunk emits no token — the request parks in
        ``prefilling`` and live decodes get one iteration first."""
        if self.active_kind == DECODE:
            self.stats.decode_iterations += 1
            self.stats.max_decode_batch = max(
                self.stats.max_decode_batch, len(self.active))
            if self.prefilling:
                # a same-tenant request is sitting between prefill
                # chunks: this decode interleaved into its prefill
                self.stats.chunk_interleaved_decodes += 1
            finished = []
            for req in self.active:
                req.tokens_done += 1
                self.stats.tokens += 1
                self.stats.tbt.append(t - req.last_token_t)
                req.last_token_t = t
                if req.tokens_done >= req.gen_len:
                    finished.append(req)
            for req in finished:
                self.decoding.remove(req)
                self._complete_request(req, t)
        elif self.active_kind == PIGGYBACK:
            self._complete_piggyback(t)
        elif self.active_kind == SWAPIN:
            # KV restored (the re-read program just paid the HBM
            # cost): the request rejoins the continuous batch; its
            # next token's TBT sample carries the full eviction gap
            req = self.active[0]
            self.stats.kv_swapins += 1
            self.decoding.append(req)
        else:
            req = self.active[0]
            req.chunks_done += 1
            if self.plan.chunked:
                self.stats.prefill_chunks += 1
            if req.chunks_done < self.plan.n_prefill_chunks:
                # chunk hand-off: prompt not fully ingested, no token
                self.prefilling.append(req)
                if self.decoding:
                    self.yield_to_decode = True
            else:
                if not req.ttft_seen:
                    # a reject-mode restart re-runs prefill; only the
                    # FIRST first-token samples TTFT
                    self.stats.ttft.append(t - req.arrival)
                    req.ttft_seen = True
                self.stats.tokens += 1
                req.tokens_done = 1       # prefill emits the first token
                req.last_token_t = t
                if req.gen_len > 1 and self.plan.has_decode:
                    # fabric hand-off point: a disaggregated tenant's
                    # decode pool may live on another core (hook True
                    # = migrated; rejected hand-offs decode locally)
                    if not (self.migrate_hook is not None
                            and self.migrate_hook(self, req, t)):
                        self.decoding.append(req)
                else:
                    self._complete_request(req, t)
        self.active = []
        self.in_request = False
        self._start_iteration(t)

    def _complete_piggyback(self, t: float) -> None:
        """A budgeted iteration finished. Token accounting rules:
        every co-riding decode request's token lands NOW (one TBT
        sample each — piggybacked tokens are decode tokens, whatever
        program carried them); the slice owner's ingestion cursor
        advances by the exact slice, and only the slice that completes
        the prompt emits the first token (one TTFT sample, measured
        from arrival — co-riders never touch TTFT)."""
        req = self.piggy_req
        riders = [r for r in self.active if r is not req]
        st = self.stats
        st.prefill_chunks += 1
        st.piggyback_iterations += 1
        if riders:
            st.piggyback_decode_tokens += len(riders)
            st.max_piggyback_batch = max(st.max_piggyback_batch,
                                         len(riders))
        finished = []
        for r in riders:
            r.tokens_done += 1
            st.tokens += 1
            st.tbt.append(t - r.last_token_t)
            r.last_token_t = t
            if r.tokens_done >= r.gen_len:
                finished.append(r)
        for r in finished:
            self.decoding.remove(r)
            self._complete_request(r, t)
        req.prefill_done += self.piggy_slice
        if req.prefill_done >= self.plan.prompt_len:
            if not req.ttft_seen:
                st.ttft.append(t - req.arrival)
                req.ttft_seen = True
            st.tokens += 1
            req.tokens_done = 1      # the final slice emits token 1
            req.last_token_t = t
            if req.gen_len > 1 and self.plan.has_decode:
                # same fabric hand-off point as the monolithic path
                if not (self.migrate_hook is not None
                        and self.migrate_hook(self, req, t)):
                    self.decoding.append(req)
            else:
                self._complete_request(req, t)
        else:
            self.prefilling.insert(0, req)   # same request continues
        self.piggy_req = None
        self.piggy_slice = 0

    def _complete_request(self, req: _Request, t: float) -> None:
        if self.kv_enabled:
            led = self._kv_led()
            if led is not None:
                led.release(req.rid)   # exact free of the request's KV
                self._kv_prefix_release(led, req)
        if req.retries > 0:
            self.stats.retry_successes += 1
        self.stats.latencies.append(t - req.arrival)
        self.stats.completions.append(t)
        self.stats.requests_done += 1
        if not self.open_loop:
            if (self.stats.requests_done >= self.spec.n_requests
                    and not self.done):
                self.done = True
                self.finished_at = t
            # closed loop: the next request arrives immediately
            self.waiting.append(self._new_request(t, self.plan.gen_len))

    # ---------------- program stepping ----------------
    def _advance(self, t: float) -> None:
        """Move to the next non-empty group/op; refill ready queues."""
        while True:
            nxt = self._next_cursor()
            if nxt is None:
                self._on_iteration_complete(t)
                return
            self.cursor = nxt
            if self._fill_ready():
                return

    def _next_cursor(self) -> Optional[int]:
        prog = self.cur_program
        if self.is_neuisa:
            n = len(prog.groups)
            if self.cursor < 0:
                return 0 if n else None
            # loop control (uTop.nextGroup). The per-group loop target
            # is static program structure, so the fast path derives it
            # once per program (cached like `_chunk_specs`) instead of
            # walking every μTOp of the group on each replay.
            if self.fast_path:
                tbl = getattr(prog, "_next_tbl", None)
                if tbl is None:
                    tbl = [next((u.next_group for u in g.all_utops()
                                 if u.next_group is not None), None)
                           for g in prog.groups]
                    prog._next_tbl = tbl
                tgt = tbl[self.cursor]
            else:
                g = prog.groups[self.cursor]
                tgt = next((u.next_group for u in g.all_utops()
                            if u.next_group is not None), None)
            if tgt is not None:
                trips = self.loop_remaining.get(
                    self.cursor, prog.loop_trips.get(self.cursor, 1))
                if trips > 1:
                    self.loop_remaining[self.cursor] = trips - 1
                    return tgt
            nxt = self.cursor + 1
            return nxt if nxt < n else None
        n = len(prog.ops)
        nxt = self.cursor + 1
        return nxt if nxt < n else None

    def _fill_ready(self) -> bool:
        """Expand current group/op into ready chunks. False if empty.
        Under the fast path, the per-group (filtered μTOp values) are
        precomputed once per program — they are pure derived data, so
        caching them on the shared program object is safe — and each
        replay only constructs the Chunk objects."""
        prog = self.cur_program
        phase = self.active_kind
        made = 0
        if self.fast_path:
            specs = getattr(prog, "_chunk_specs", None)
            if specs is None:
                specs = _build_chunk_specs(prog, self.is_neuisa)
                prog._chunk_specs = specs
            me_specs, ve_spec = specs[self.cursor]
            cursor, idx = self.cursor, self.idx
            # positional construction (field order matches the Chunk
            # dataclass) — this is the hottest allocation site in the
            # simulator, one Chunk per μTOp replay
            append_me = self.ready_me.append
            for cycles, hbm, name, n_eng in me_specs:
                append_me(Chunk(idx, ME, cycles, hbm, name, n_eng,
                                0.0, cursor, False, phase))
                made += 1
            if ve_spec is not None:
                cycles, hbm, name, slots, from_me = ve_spec
                append_ve = self.ready_ve.append
                for _ in range(slots):
                    append_ve(Chunk(idx, VE, cycles, hbm, name, 1,
                                    0.0, cursor, from_me, phase))
                    made += 1
            self.outstanding = made
            if made:
                self._dirty_sink.add(self.idx)
            return made > 0
        if self.is_neuisa:
            g: MuTOpGroup = prog.groups[self.cursor]
            for u in g.me_utops:
                if u.cycles > EPS or u.hbm_bytes > EPS:
                    self.ready_me.append(Chunk(
                        self.idx, ME, u.cycles, u.hbm_bytes, u.op_name,
                        group_key=self.cursor, phase=phase))
                    made += 1
            if g.ve_utop is not None and (
                    g.ve_utop.cycles > EPS or g.ve_utop.hbm_bytes > EPS):
                n_y = prog.n_y
                for _ in range(n_y):
                    self.ready_ve.append(Chunk(
                        self.idx, VE, g.ve_utop.cycles / n_y,
                        g.ve_utop.hbm_bytes / n_y, g.ve_utop.op_name,
                        group_key=self.cursor,
                        from_me_group=bool(g.me_utops), phase=phase))
                    made += 1
        else:
            op = prog.ops[self.cursor]
            if op.n_me_static > 0 and (op.me_cycles > EPS or op.hbm_bytes > EPS):
                self.ready_me.append(Chunk(
                    self.idx, ME, op.me_cycles, op.hbm_bytes, op.op_name,
                    n_engines=op.n_me_static, group_key=self.cursor,
                    phase=phase))
                made += 1
                # drain VE work is folded into the op span (pipelined)
            elif op.ve_cycles > EPS or op.hbm_bytes > EPS:
                self.ready_ve.append(Chunk(
                    self.idx, VE, op.ve_cycles, op.hbm_bytes, op.op_name,
                    group_key=self.cursor, phase=phase))
                made += 1
        self.outstanding = made
        if made:
            self._dirty_sink.add(self.idx)
        return made > 0

    def chunk_done(self, t: float) -> None:
        self.outstanding -= 1
        if self.outstanding <= 0 and not self.ready_me and not self.ready_ve:
            self._advance(t)

    def arrive(self, t: float, gen_len: Optional[int] = None,
               prefix_key: int = 0) -> None:
        """Open-loop request arrival at time t; ``gen_len`` overrides
        the plan's default generation length for this request.
        ``prefix_key`` != 0 marks the request as sharing its prompt
        prefix with every other request carrying the same key."""
        if self.removed:
            return
        self.start_request(t, arrival=t, gen_len=gen_len,
                           prefix_key=prefix_key)

    # ---------------- cluster-fabric migration ----------------
    def clone_inbound(self, req: _Request) -> _Request:
        """Materialize the migrated-in copy of ANOTHER core's request
        (cross-core prefill->decode hand-off): a fresh ledger rid on
        THIS tenant, with the arrival timestamp and token cursors
        preserved so end-to-end latency still spans the original
        arrival and the first decode token's TBT sample carries the
        fabric transfer gap."""
        m = _Request(req.arrival, req.gen_len, rid=next(self._rid),
                     prefix_key=req.prefix_key)
        m.tokens_done = req.tokens_done
        m.last_token_t = req.last_token_t
        m.ttft_seen = req.ttft_seen     # TTFT sampled on the prefill core
        return m

    def admit_migrated(self, t: float, req: _Request) -> None:
        """A request that finished prefill on another core joins this
        tenant's continuous decode batch (its KV was charged to this
        vNPU's ledger at hand-off time — see the session's migration
        hook). Dropped silently if the tenant was deregistered while
        the transfer was in flight (the ledger clear on removal
        already released the charge)."""
        if self.removed:
            return
        self.decoding.append(req)
        if not self.in_request:
            self._start_iteration(t)


# ----------------------------------------------------------------------
class Simulator:
    """Deterministic event-driven simulator for one physical NPU core
    shared by collocated vNPU tenants, under any registered
    :class:`~repro_torch.core.policies.SchedulerPolicy`."""

    # heap compaction floor: below this many stale entries a sweep
    # costs more than the lazy pops it saves (tests shrink it to
    # exercise compaction on small runs)
    HEAP_COMPACT_MIN = 64

    def __init__(
        self,
        tenants: Sequence[TenantSpec] = (),
        policy: PolicyLike = "neu10",
        core: NPUCoreConfig = DEFAULT_CORE,
        hbm_scale: float = 1.0,
        fair_slice: float = 50_000.0,   # cycles of service imbalance
        max_events: int = 20_000_000,
        fast_path: bool = True,
        incremental: bool = True,
    ):
        """``fast_path`` enables the wall-clock optimizations that are
        *result-identical* by construction: memoized per-(chunk shape,
        mem-pressure) dispatch durations, incremental HBM-contention
        bookkeeping instead of an engine scan per dispatch, and the
        tightened ``neu10`` schedule pass. ``False`` runs the
        reference implementations — kept so benchmarks/tests can
        prove byte-for-byte SimResult equality and measure the
        speedup (``fig25_scaling``'s fast-path row).

        ``incremental`` additionally enables dirty-set scheduling when
        the policy opts in with ``schedule_incremental`` (see
        ``docs/architecture.md`` "Event engine"): the schedule pass is
        skipped outright while nothing marked a tenant dirty, runs
        through the policy's incremental hook otherwise, and the event
        loop/dispatch layers are fused into one frame. Policies
        without the hook (``pmt``/``v10``) silently fall back to the
        full pass per event. Result-identical by the same A/B proof
        (``fig25``'s ``sched_incremental`` row + the churn property
        test); requires ``fast_path``."""
        self.policy_obj = resolve_policy(policy)
        self.policy = self.policy_obj.name or type(self.policy_obj).__name__
        self.core = core
        self.hbm_scale = hbm_scale
        self.fair_slice = fair_slice
        self.max_events = max_events
        self.fast_path = fast_path
        self._span_memo: Dict[Tuple, float] = {}
        self._bw_inflight: Dict[int, int] = {}   # id(chunk) -> tenant
        self._bw_per_tenant: Dict[int, int] = {}  # tenant -> bw chunks
        self._bpc = core.hbm_bytes_per_cycle * hbm_scale  # bytes/cycle
        # fast path: engines per owner currently running a FOREIGN
        # tenant's chunk (harvest squatters) — lets the reclaim pass
        # skip its engine scan when an owner has nothing to reclaim
        self._squat: Dict[int, int] = {}
        self.now = 0.0
        self.tenants: List[_TenantRT] = []
        # maintained active-tenant cache (tenants minus removed, in
        # index order) — the incremental pass iterates it every event,
        # so it is kept up to date by add/remove instead of rebuilt
        self._act: List[_TenantRT] = []
        self.mes = [_Engine(ME, i, None) for i in range(core.n_me)]
        self.ves = [_Engine(VE, i, None) for i in range(core.n_ve)]
        self._heap: List[Tuple[float, int, str, int, int]] = []
        self._seq = itertools.count()
        self._tok = itertools.count()
        # in-flight cross-core hand-offs keyed by token: the payload
        # is (request clone, optional landing callback)
        self._mig_payloads: Dict[int, Tuple["_Request",
                                            Optional[Callable]]] = {}
        # prefix-keyed arrivals keyed by token: (gen_len, prefix_key)
        # — plain arrivals keep riding the _ARRIVAL token slot
        self._arr_payloads: Dict[int, Tuple[int, int]] = {}
        # retried arrivals keyed by token: (gen_len, prefix_key,
        # retries, original arrival, ttft_seen)
        self._retry_payloads: Dict[int, Tuple[int, int, int, float,
                                              bool]] = {}
        self._events = 0
        # lazy-deletion heap hygiene: count of stale entries (preempted
        # or cancelled tokens) still sitting in the heap; compacted
        # away past HEAP_COMPACT_MIN once they outnumber live entries
        self._stale = 0
        # incremental scheduling state: the shared dirty set (tenant
        # indices; -1 = global change such as an unowned engine
        # freeing) and the per-owner free-engine index the incremental
        # pass consumes instead of scanning pools
        self.incremental = incremental
        self._dirty: set = set()
        self._free_me_own: Dict[Optional[int], List[_Engine]] = {}
        self._free_ve_own: Dict[Optional[int], List[_Engine]] = {}
        # free-engine counters per pool (mirrors of the index) — one
        # integer check gates the harvest section of the pass
        self._nfree_me = 0
        self._nfree_ve = 0
        self._inc_fn = getattr(self.policy_obj, "schedule_incremental", None)
        self._inc = bool(incremental and fast_path
                         and self._inc_fn is not None)
        if self._inc:
            self._rebuild_free_index()
        self.policy_obj.on_attach(self)
        for s in tenants:
            self.add_tenant(s)

    # ------------------------------------------------------------------
    # dynamic tenant control plane
    # ------------------------------------------------------------------
    def active_tenants(self) -> List[_TenantRT]:
        return [rt for rt in self.tenants if not rt.removed]

    def add_tenant(self, spec: TenantSpec, open_loop: bool = False) -> int:
        """Attach a tenant (possibly mid-run). Closed-loop tenants
        start their request train immediately; open-loop tenants idle
        until :meth:`inject_request`. Returns the tenant index."""
        idx = len(self.tenants)
        rt = _TenantRT(idx, spec, self.core, open_loop=open_loop,
                       fast_path=self.fast_path)
        rt._dirty_sink = self._dirty   # before any ready-queue fill
        # a late joiner starts from the lowest live fair-share counter,
        # not zero — otherwise it would starve everyone until it
        # "caught up" on service it never queued for
        live = [r.active_cycles for r in self.active_tenants()]
        if live:
            rt.active_cycles = min(live)
        self.tenants.append(rt)
        self._act.append(rt)
        if self.policy_obj.spatial:
            self._claim_engines(rt)
            if self.fast_path:
                # a mid-run joiner can take ownership of engines still
                # running a departed neighbor's harvested chunks (the
                # deregister released ownership, not the work) — the
                # squatter counts must see them, like resize does
                self._recount_squat()
            if self._inc:
                # ownership keys the free-engine index; claiming moved
                # engines between owner buckets
                self._rebuild_free_index()
                self._dirty.add(-1)
        if not open_loop:
            rt.start_request(self.now)
        self.policy_obj.on_tenant_added(self, rt)
        return idx

    def remove_tenant(self, idx: int) -> None:
        """Detach a tenant mid-run: cancel its in-flight chunks (the
        context is discarded, not drained — vNPU deallocation cleans
        the engines), release engine ownership, drop queued work."""
        rt = self.tenants[idx]
        if rt.removed:
            return
        cancelled: set = set()   # distinct tokens -> stale heap entries
        for e in self.mes + self.ves:
            if not e.free and e.chunk is not None and e.tenant == idx:
                # one heap entry per token (VLIW multi-engine ops and
                # incremental cohorts share a token across engines)
                cancelled.add(e.token)
                self._unsquat(e, idx)
                e.token = -1       # pending completion event goes stale
                e.chunk = None
                e.tenant = -1
                e.harvested = False
            if e.owner == idx:
                e.owner = None
        self._squat.pop(idx, None)   # released engines reclaim nothing
        if cancelled:
            self._stale += len(cancelled)
            self._maybe_compact()
        if self._inc:
            # cancelled engines freed and ownership released: the
            # free-engine index is rebuilt, and everyone may now
            # harvest the released engines
            self._rebuild_free_index()
            self._dirty.add(-1)
        rt.ready_me.clear()
        rt.ready_ve.clear()
        rt.waiting.clear()
        rt.prefilling.clear()
        rt.decoding.clear()
        rt.swapped.clear()
        if rt.kv_enabled:
            led = rt._kv_led()
            if led is not None:
                # mid-run churn: every per-request allocation releases
                # with the tenant (the vNPU's reserved weights free
                # when the control plane destroys the vNPU itself)
                led.clear()
        rt.active = []
        rt.piggy_req = None
        rt.piggy_slice = 0
        rt.in_request = False
        rt.removed = True
        self._act = [r for r in self.tenants if not r.removed]
        if self._bw_per_tenant.pop(idx, None) is not None:
            # cancelled chunks left the engines above: drop their
            # bandwidth-contention entries too
            for cid in [c for c, ten in self._bw_inflight.items()
                        if ten == idx]:
                del self._bw_inflight[cid]
        rt.done = True
        rt.finished_at = min(rt.finished_at, self.now)
        self.policy_obj.on_tenant_removed(self, rt)
        self._schedule(self.now)

    def update_tenant_vnpu(self, idx: int, vnpu: VNPU) -> None:
        """Re-size a live tenant onto a reconfigured vNPU (paper
        hypercall (2) taking effect mid-run). In-flight chunks finish
        where they run; ownership moves to the new engine set."""
        rt = self.tenants[idx]
        if rt.removed:
            raise ValueError(f"tenant {idx} was deregistered")
        rt.spec.vnpu = vnpu
        rt.me_ids = set(vnpu.me_ids)
        rt.ve_ids = set(vnpu.ve_ids)
        if self.policy_obj.spatial:
            for e in self.mes + self.ves:
                if e.owner == idx:
                    e.owner = None
            self._claim_engines(rt)
            self._recount_squat()   # ownership moved under live chunks
            if self._inc:
                self._rebuild_free_index()
                self._dirty.add(-1)
        self._schedule(self.now)

    def _claim_engines(self, rt: _TenantRT) -> None:
        for pool, ids in ((self.mes, rt.me_ids), (self.ves, rt.ve_ids)):
            for e in pool:
                if e.eid in ids:
                    if e.owner is not None and e.owner != rt.idx:
                        raise ValueError(
                            f"engine {e.kind}{e.eid} already owned by "
                            f"tenant {e.owner}; vNPU mapping conflict")
                    e.owner = rt.idx

    def inject_request(self, idx: int, at: float,
                       gen_len: Optional[int] = None,
                       prefix_key: int = 0) -> None:
        """Open-loop arrival: tenant ``idx`` receives a request at
        cycle ``at`` (>= now). ``gen_len`` overrides the tenant plan's
        default generation length for this request (generation-length
        distributions sample it per request at the serving layer).
        ``prefix_key`` != 0 marks the request's prompt prefix as
        shared with every other same-key request (refcounted in the
        tenant's KV ledger); the tenant's plan must carry a prefix
        builder. Key-less arrivals take the original event path
        byte-for-byte."""
        rt = self.tenants[idx]
        if not rt.open_loop:
            raise ValueError(f"tenant {idx} is closed-loop")
        if rt.removed:
            raise ValueError(f"tenant {idx} was deregistered")
        if at < self.now - EPS:
            raise ValueError(f"arrival at {at} is in the past (now={self.now})")
        if gen_len is not None and gen_len < 1:
            raise ValueError(f"gen_len must be >= 1, got {gen_len}")
        if gen_len is not None and gen_len > 1 and not rt.plan.has_decode:
            raise ValueError(
                f"tenant {idx} has no decode phases; gen_len={gen_len} "
                f"would be silently truncated to 1 token")
        if prefix_key:
            if not rt.prefix_enabled:
                raise ValueError(
                    f"tenant {idx} has no shared-prefix support "
                    f"(plan prefix_len=0 or KV accounting off); "
                    f"prefix_key={prefix_key} would be silently ignored")
            key = next(self._tok)
            self._arr_payloads[key] = (
                -1 if gen_len is None else int(gen_len), int(prefix_key))
            heapq.heappush(self._heap,
                           (max(at, self.now), next(self._seq), _ARRIVAL_K,
                            idx, key))
            return
        heapq.heappush(self._heap,
                       (max(at, self.now), next(self._seq), _ARRIVAL, idx,
                        -1 if gen_len is None else int(gen_len)))

    def inject_migration(self, idx: int, at: float, req: "_Request",
                         on_land: Optional[Callable[[float], None]] = None,
                         ) -> None:
        """Cluster-fabric hand-off: a request that finished prefill on
        ANOTHER core's simulator joins tenant ``idx``'s decode batch
        at cycle ``at`` (hand-off time + the priced link transfer).
        ``req`` must be this tenant's own clone
        (:meth:`_TenantRT.clone_inbound`) — its KV charge happened at
        hand-off. ``on_land`` fires when the transfer lands (the
        serving session's in-transit accounting)."""
        rt = self.tenants[idx]
        if rt.removed:
            raise ValueError(f"tenant {idx} was deregistered")
        if at < self.now - EPS:
            raise ValueError(
                f"migration landing at {at} is in the past (now={self.now})")
        key = next(self._tok)
        self._mig_payloads[key] = (req, on_land)
        heapq.heappush(self._heap,
                       (max(at, self.now), next(self._seq), _MIGRATE, idx,
                        key))

    def inject_retry(self, idx: int, at: float,
                     gen_len: Optional[int] = None, prefix_key: int = 0,
                     retries: int = 1, orig_arrival: float = 0.0,
                     ttft_seen: bool = False) -> None:
        """Deadline/fault re-admission: tenant ``idx`` re-receives a
        request at cycle ``at`` (arrival + backoff). The request lands
        carrying its retry count and ORIGINAL arrival timestamp so
        end-to-end latency spans every attempt."""
        rt = self.tenants[idx]
        if rt.removed:
            raise ValueError(f"tenant {idx} was deregistered")
        if at < self.now - EPS:
            raise ValueError(
                f"retry at {at} is in the past (now={self.now})")
        key = next(self._tok)
        self._retry_payloads[key] = (
            -1 if gen_len is None else int(gen_len), int(prefix_key),
            int(retries), float(orig_arrival), bool(ttft_seen))
        heapq.heappush(self._heap,
                       (max(at, self.now), next(self._seq), _ARRIVAL_R,
                        idx, key))

    def inject_wake(self, idx: int, at: float) -> None:
        """Kick tenant ``idx``'s iteration picker at cycle ``at`` (an
        evacuated vNPU resumes once its bulk transfer lands). No-op if
        an iteration is already in flight when the event fires."""
        heapq.heappush(self._heap,
                       (max(at, self.now), next(self._seq), _WAKE, idx, 0))

    def abort_tenant(self, idx: int, t: float) -> List["_Request"]:
        """Fault-abort tenant ``idx``'s in-flight iteration: cancel its
        chunks on the engines (pending completion events go stale, like
        :meth:`remove_tenant`) and restitute every served request to a
        queue with its ledger charges consistent
        (:meth:`_TenantRT.abort_iteration`). The tenant stays attached.
        Returns the requests whose attempt was lost."""
        rt = self.tenants[idx]
        cancelled: set = set()
        for e in self.mes + self.ves:
            if not e.free and e.chunk is not None and e.tenant == idx:
                cancelled.add(e.token)
                self._unsquat(e, idx)
                e.token = -1
                e.chunk = None
                e.tenant = -1
                e.harvested = False
        if cancelled:
            self._stale += len(cancelled)
            self._maybe_compact()
            if self._inc:
                # cancelled engines freed: co-tenants may harvest them
                self._rebuild_free_index()
                self._dirty.add(-1)
        lost = rt.abort_iteration(t)
        self._schedule(self.now)
        return lost

    def extract_tenant_events(self, idx: int
                              ) -> List[Tuple[float, str, object]]:
        """Remove every pending arrival / retry / migration / wake
        event addressed to tenant ``idx`` from the heap (failover: the
        events follow the tenant to the simulator it evacuates to).
        Returns ``[(t, kind, payload)]`` sorted by time — the payload
        is the kind's side-table tuple (the ``gen_len`` token slot for
        plain arrivals; wakes are dropped, the re-attach re-kicks)."""
        fault_kinds = (_ARRIVAL, _ARRIVAL_K, _ARRIVAL_R, _MIGRATE, _WAKE)
        keep, out = [], []
        for ev in self._heap:
            t, _, kind, eid, token = ev
            if kind not in fault_kinds or eid != idx:
                keep.append(ev)
                continue
            if kind == _ARRIVAL:
                out.append((t, _ARRIVAL, token))
            elif kind == _ARRIVAL_K:
                out.append((t, _ARRIVAL_K, self._arr_payloads.pop(token)))
            elif kind == _ARRIVAL_R:
                out.append((t, _ARRIVAL_R, self._retry_payloads.pop(token)))
            elif kind == _MIGRATE:
                out.append((t, _MIGRATE, self._mig_payloads.pop(token)))
        if len(keep) != len(self._heap):
            self._heap = keep
            heapq.heapify(self._heap)
        out.sort(key=lambda e: e[0])
        return out

    def replay_tenant_events(self, idx: int,
                             events: Sequence[Tuple[float, str, object]]
                             ) -> None:
        """Re-inject events extracted by :meth:`extract_tenant_events`
        onto tenant ``idx`` of THIS simulator (the failover
        destination). Times earlier than ``now`` clamp forward."""
        for t, kind, payload in events:
            at = max(t, self.now)
            if kind == _ARRIVAL:
                g = payload
                self.inject_request(idx, at,
                                    gen_len=None if g < 0 else g)
            elif kind == _ARRIVAL_K:
                g, pk = payload
                self.inject_request(idx, at,
                                    gen_len=None if g < 0 else g,
                                    prefix_key=pk)
            elif kind == _ARRIVAL_R:
                g, pk, n, orig, seen = payload
                self.inject_retry(idx, at,
                                  gen_len=None if g < 0 else g,
                                  prefix_key=pk, retries=n,
                                  orig_arrival=orig, ttft_seen=seen)
            elif kind == _MIGRATE:
                req, on_land = payload
                self.inject_migration(idx, at, req, on_land=on_land)

    @property
    def next_event_at(self) -> float:
        """Cycle time of the earliest pending event (inf when idle) —
        the cluster-level lockstep driver advances whichever core's
        simulator is globally earliest."""
        return self._heap[0][0] if self._heap else math.inf

    # ------------------------------------------------------------------
    # event loop
    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        """Closed-loop batch run: simulate until every closed-loop
        tenant has completed its ``n_requests``. Open-loop tenants
        (which never 'finish') don't gate termination — drive those
        with :meth:`run_until` instead."""
        closed = [rt for rt in self.tenants if not rt.open_loop]
        if not closed:
            raise ValueError(
                "run() needs at least one closed-loop tenant; "
                "open-loop simulations are driven with run_until()")
        self._schedule(self.now)
        if self._inc:
            self._drain_fast(math.inf, closed)
        else:
            while self._heap:
                t = self._step()
                if t is None:
                    continue
                if all(rt.done for rt in closed):
                    break
                self._schedule(t)
                self._check_liveness(t)
        makespan = max((rt.finished_at for rt in closed), default=self.now)
        if not all(rt.done for rt in closed):
            makespan = self.now
        return self._result(max(makespan, EPS))

    def run_until(self, t_end: float = math.inf) -> float:
        """Open-loop driver: process events up to ``t_end`` cycles
        (inclusive); returns the new simulation time. With no bound,
        drains every injected arrival and all in-flight work."""
        self._schedule(self.now)
        if self._inc:
            self._drain_fast(t_end, None)
        else:
            while self._heap and self._heap[0][0] <= t_end + EPS:
                t = self._step()
                if t is None:
                    continue
                self._schedule(t)
                self._check_liveness(t)
        if math.isfinite(t_end) and t_end > self.now:
            self.now = t_end
        return self.now

    def _drain_fast(self, t_end: float, closed) -> None:
        """Incremental-path event loop: event semantics identical to
        ``_step``/``_schedule``/``_check_liveness`` (stale pops skip
        scheduling without advancing ``now``; same-time events batch
        within EPS; ``closed`` — run()'s termination list, None for
        run_until — is checked before scheduling), with the call
        layers flattened and the schedule pass gated on the dirty
        set."""
        heap = self._heap
        pop = heapq.heappop
        mes, ves = self.mes, self.ves
        sched = self._inc_fn
        dirty = self._dirty
        complete = self._complete
        apply_ev = self._apply
        max_events = self.max_events
        bound = t_end + EPS
        while heap and heap[0][0] <= bound:
            self._events += 1
            if self._events > max_events:
                raise RuntimeError("simulator exceeded max_events")
            t, _, kind, eid, token = pop(heap)
            if kind == ME:
                eng = mes[eid]
            elif kind == VE:
                eng = ves[eid]
            else:
                apply_ev(kind, eid, token, t)
                eng = None
            if eng is not None:
                if eng.token != token:
                    self._stale -= 1
                    continue
                complete(eng, t)
            self.now = t
            tb = t + EPS
            while heap and heap[0][0] <= tb:
                t2, _, k2, e2, tok2 = pop(heap)
                if k2 == ME:
                    eng = mes[e2]
                elif k2 == VE:
                    eng = ves[e2]
                else:
                    apply_ev(k2, e2, tok2, t2)
                    continue
                if eng.token == tok2:
                    complete(eng, t2)
                else:
                    self._stale -= 1
            if closed is not None:
                for rt in closed:
                    if not rt.done:
                        break
                else:
                    return
            if dirty:
                snap = set(dirty)
                dirty.clear()
                sched(self, t, snap)
            if not heap:
                self._check_liveness(t)

    def _step(self) -> Optional[float]:
        """Pop and apply the next event (plus its same-time batch).
        Returns the event time, or None for a stale token."""
        self._events += 1
        if self._events > self.max_events:
            raise RuntimeError("simulator exceeded max_events")
        t, _, kind, eid, token = heapq.heappop(self._heap)
        if not self._apply(kind, eid, token, t):
            return None
        self.now = t
        # batch any same-time events before rescheduling
        while self._heap and self._heap[0][0] <= t + EPS:
            t2, _, k2, e2, tok2 = heapq.heappop(self._heap)
            self._apply(k2, e2, tok2, t2)
        return t

    def _apply(self, kind: str, eid: int, token: int, t: float) -> bool:
        if kind == _ARRIVAL:
            # the token slot carries the per-request gen_len (-1: default)
            self.tenants[eid].arrive(t, gen_len=None if token < 0 else token)
            return True
        if kind == _ARRIVAL_K:
            g, pk = self._arr_payloads.pop(token)
            self.tenants[eid].arrive(t, gen_len=None if g < 0 else g,
                                     prefix_key=pk)
            return True
        if kind == _ARRIVAL_R:
            g, pk, n, orig, seen = self._retry_payloads.pop(token)
            self.tenants[eid].arrive_retry(
                t, gen_len=None if g < 0 else g, prefix_key=pk,
                retries=n, orig_arrival=orig, ttft_seen=seen)
            return True
        if kind == _WAKE:
            rt = self.tenants[eid]
            if not rt.removed and not rt.in_request:
                rt._start_iteration(t)
            return True
        if kind == _MIGRATE:
            req, on_land = self._mig_payloads.pop(token)
            rt = self.tenants[eid]
            rt.admit_migrated(t, req)
            if not rt.removed:
                self.policy_obj.on_request_migrated(self, rt, req)
            if on_land is not None:
                on_land(t)
            return True
        eng = (self.mes if kind == ME else self.ves)[eid]
        if eng.token != token:
            self._stale -= 1
            return False  # stale (preempted / cancelled)
        self._complete(eng, t)
        return True

    def _check_liveness(self, t: float) -> None:
        if not self._heap:
            pending = [rt.idx for rt in self.active_tenants()
                       if rt.ready_me or rt.ready_ve]
            if pending:
                raise RuntimeError(
                    f"scheduler deadlock at t={t}: tenants {pending} have "
                    f"ready work but nothing is in flight")

    def _result(self, makespan: float) -> SimResult:
        return SimResult(
            policy=self.policy,
            makespan=makespan,
            tenants=[rt.stats for rt in self.tenants],
            n_me=self.core.n_me,
            n_ve=self.core.n_ve,
            freq_hz=self.core.freq_hz,
        )

    def result(self) -> SimResult:
        """Snapshot of the stats so far (open-loop sessions)."""
        return self._result(max(self.now, EPS))

    # ------------------------------------------------------------------
    def _complete(self, eng: _Engine, t: float) -> None:
        chunk, tenant = eng.chunk, eng.tenant
        inc = self._inc
        if chunk is None:
            # context-switch drain window finished
            token = eng.token
            for e in self.mes + self.ves:
                if e.token == token:
                    e.token = -1
                    if inc:
                        self._free_idx_add(e)
                        self._dirty.add(-1 if e.owner is None else e.owner)
            return
        if chunk.cohort > 1:
            # incremental cohort: n identical compute-only siblings
            # under one token/event — replay per-chunk completion in
            # engine order (== dispatch order == the order the
            # reference's n consecutive events would complete in)
            self._complete_cohort(eng.token, chunk.kind, tenant, t)
            return
        squat = self._squat
        if chunk.n_dispatched == 1:     # single-engine μTOp fast path
            if squat:
                # inlined _unsquat (hot path)
                ow = eng.owner
                if ow is not None and ow != tenant:
                    ns = squat.get(ow, 0) - 1
                    if ns <= 0:
                        squat.pop(ow, None)
                    else:
                        squat[ow] = ns
            eng.token = -1
            eng.chunk = None
            if inc:
                self._free_idx_add(eng)
                self._dirty.add(-1 if eng.owner is None else eng.owner)
        else:
            for e in self._engines_of(chunk):
                if squat:
                    self._unsquat(e, tenant)
                e.token = -1
                e.chunk = None
                if inc:
                    self._free_idx_add(e)
                    self._dirty.add(-1 if e.owner is None else e.owner)
        if self._bw_inflight:
            self._bw_unregister(chunk)
        rt = self.tenants[tenant]
        st = rt.stats
        cycles = chunk.cycles
        if chunk.kind == ME:
            st.me_work += cycles
            # note: a VLIW ME op's fused VE-drain work rides inside the
            # op span without occupying modeled VE engines, so it is
            # NOT counted as VE work — utilization stats are physical
            # occupancy for every policy (conservation-exact).
            if eng.harvested:
                st.harvested_me_work += cycles
        else:
            st.ve_work += cycles
            if eng.harvested:
                st.harvested_ve_work += cycles
        # fairness bookkeeping counts ACTIVE (compute) cycles, like the
        # paper's per-vNPU performance counters (§III-E) — an
        # HBM-stalled tenant accrues little and keeps its priority,
        # which is precisely V10's Fig. 27 pathology.
        rt.active_cycles += (cycles if chunk.n_engines <= 1
                             else cycles / chunk.n_engines)
        # inlined chunk_done (hot path)
        rt.outstanding -= 1
        if rt.outstanding <= 0 and not rt.ready_me and not rt.ready_ve:
            rt._advance(t)

    def _complete_cohort(self, token: int, kind: str, tenant: int,
                         t: float) -> None:
        """Finish every member of a dispatch cohort (see
        ``Chunk.cohort``): each engine carries its OWN chunk, so the
        per-chunk accounting below is exactly what the reference's n
        separate completion events do, in the same (engine-id) order.
        Cohort chunks are compute-only (never bandwidth-registered),
        single-engine, and run un-harvested on the owner's own engines
        (so no squatter bookkeeping applies)."""
        pool = self.mes if kind == ME else self.ves
        rt = self.tenants[tenant]
        st = rt.stats
        dirty = self._dirty
        is_me = kind == ME
        n = 0
        freed = []
        for e in pool:
            if e.token != token:
                continue
            cycles = e.chunk.cycles
            e.token = -1
            e.chunk = None
            freed.append(e)
            if is_me:
                st.me_work += cycles
            else:
                st.ve_work += cycles
            rt.active_cycles += cycles
            n += 1
        # batched free-index merge: members normally share one owner
        # (they were dispatched off one owner bucket), and that bucket
        # is normally empty now (the members WERE its contents) — one
        # dict store replaces n shift inserts. A mid-flight resize can
        # break either assumption; fall back to per-member inserts.
        ow = freed[0].owner
        for e in freed:
            if e.owner != ow:
                ow = _MIXED
                break
        if ow is not _MIXED:
            d = self._free_me_own if is_me else self._free_ve_own
            lst = d.get(ow)
            if lst:
                for e in freed:
                    eid = e.eid
                    i = len(lst)
                    while i and lst[i - 1].eid > eid:
                        i -= 1
                    lst.insert(i, e)
            else:
                d[ow] = freed   # already in eid (pool-scan) order
            if is_me:
                self._nfree_me += n
            else:
                self._nfree_ve += n
            dirty.add(-1 if ow is None else ow)
        else:
            for e in freed:
                self._free_idx_add(e)
                dirty.add(-1 if e.owner is None else e.owner)
        # batched chunk_done: intermediate members can never trigger
        # _advance (outstanding still counts their in-flight siblings),
        # so one decrement + one check is state-identical to n calls
        rt.outstanding -= n
        if rt.outstanding <= 0 and not rt.ready_me and not rt.ready_ve:
            rt._advance(t)

    def _engines_of(self, chunk: Chunk,
                    eng: Optional[_Engine] = None) -> List[_Engine]:
        if eng is not None and chunk.n_dispatched == 1:
            return [eng]   # single-engine μTOp: no pool scan needed
        pool = self.mes if chunk.kind == ME else self.ves
        return [e for e in pool if e.chunk is chunk]

    # ------------------------------------------------------------------
    def _duration(self, chunk: Chunk, n_dispatched: int) -> float:
        rt = self.tenants[chunk.tenant]
        if self.fast_path:
            # the overwhelmingly common case — a compute-only μTOp —
            # IS its span; skip the key build entirely
            if rt.is_neuisa and chunk.hbm_bytes <= 0:
                return chunk.cycles + chunk.penalty
            pressure = (self._mem_pressure(chunk.tenant)
                        if chunk.hbm_bytes > 0 else (1, 1))
            # memoized per-(chunk shape, mem-pressure) span: identical
            # chunk shapes recur thousands of times per run (one per
            # μTOp replay), so the arithmetic is computed once per
            # key. VLIW ME spans also read ops[chunk.group_key] off
            # the live program — the (program id, group index) pair
            # stands in for that dereference in the key.
            key = (chunk.kind, chunk.cycles, chunk.hbm_bytes,
                   chunk.n_engines, n_dispatched, pressure, rt.is_neuisa,
                   (id(rt.cur_program), chunk.group_key)
                   if not rt.is_neuisa and chunk.kind == ME else None)
            span = self._span_memo.get(key)
            if span is None:
                span = self._span(chunk, rt, n_dispatched, pressure)
                self._span_memo[key] = span
            return span + chunk.penalty
        pressure = (self._mem_pressure(chunk.tenant)
                    if chunk.hbm_bytes > 0 else (1, 1))
        return self._span(chunk, rt, n_dispatched, pressure) + chunk.penalty

    def _span(self, chunk: Chunk, rt: _TenantRT, n_dispatched: int,
              pressure: Tuple[int, int]) -> float:
        if rt.is_neuisa:
            # μTOps are single-engine units (a VE μTOp was pre-split
            # into n_y slot chunks)
            span = chunk.cycles
        elif chunk.kind == ME:
            # VLIW op: rate fixed by its compiled-in ME count (Fig. 9 —
            # extra engines seized but unusable); drain VE work is
            # pipelined inside the op span.
            span = chunk.cycles / max(chunk.n_engines, 1)
            op = rt.cur_program.ops[chunk.group_key]
            frac = min(chunk.cycles / max(op.me_cycles, EPS), 1.0)
            span = max(span, op.ve_cycles * frac / max(rt.cur_program.n_y, 1))
        else:
            # VLIW VE op addresses every VE slot granted at dispatch
            span = chunk.cycles / max(n_dispatched, 1)
        if chunk.hbm_bytes > 0:
            # two-level fair sharing (computed at dispatch): HBM BW is
            # split across tenants with in-flight DMA (§III-B "fair
            # sharing of HBM bandwidth"), then across THIS tenant's
            # own in-flight memory chunks — so partitioning one
            # operator into μTOps never manufactures bandwidth.
            n_ten, n_mine = pressure
            bw = (self.core.hbm_bytes_per_cycle * self.hbm_scale
                  / n_ten / n_mine)
            span = max(span, chunk.hbm_bytes / bw)
        return span

    def _mem_pressure(self, tenant: int) -> Tuple[int, int]:
        """Max-min fair HBM sharing: only BANDWIDTH-BOUND in-flight
        chunks contend (a compute-bound neighbor's trickle of weight
        streaming doesn't halve a decode tenant's BW — §V-F: the
        collocated LLM 'suffers negligible overhead'). The fast path
        reads the incrementally-maintained per-tenant contender
        counts; the reference path recomputes them with an engine
        scan — same answer, proven equal by the fig25 fast-path
        row."""
        if self.fast_path:
            per = self._bw_per_tenant
            return (len(per) + (0 if tenant in per else 1),
                    1 + per.get(tenant, 0))
        bpc = self.core.hbm_bytes_per_cycle * self.hbm_scale
        tenants = {tenant}
        mine = 1  # the chunk being dispatched
        seen = set()
        for e in self.mes + self.ves:
            c = e.chunk
            if c is None or c.hbm_bytes <= 0 or id(c) in seen:
                continue
            seen.add(id(c))
            # compute-bound chunks are not HBM contenders. Ties DO
            # count: memory-paced μTOp chunks sit exactly at the
            # boundary, and exempting them would let k sibling chunks
            # stream at k x BW.
            if c.hbm_bytes / bpc < c.cycles:
                continue
            tenants.add(e.tenant)
            if e.tenant == tenant:
                mine += 1
        return len(tenants), mine

    def _bw_unregister(self, chunk: Chunk) -> None:
        ten = self._bw_inflight.pop(id(chunk), None)
        if ten is not None:
            n = self._bw_per_tenant[ten] - 1
            if n <= 0:
                del self._bw_per_tenant[ten]
            else:
                self._bw_per_tenant[ten] = n

    def _unsquat(self, eng: _Engine, tenant: int) -> None:
        """Engine stops running a chunk: drop its squatter entry if it
        was running a foreign tenant's work on an owned engine."""
        owner = eng.owner
        if owner is not None and owner != tenant and self._squat:
            n = self._squat.get(owner, 0) - 1
            if n <= 0:
                self._squat.pop(owner, None)
            else:
                self._squat[owner] = n

    def _recount_squat(self) -> None:
        """Rebuild the squatter counts from engine state (ownership
        was reassigned with chunks in flight — rare)."""
        self._squat.clear()
        for e in self.mes + self.ves:
            if (e.chunk is not None and e.owner is not None
                    and e.owner != e.tenant):
                self._squat[e.owner] = self._squat.get(e.owner, 0) + 1

    # ------------------------------------------------------------------
    # policy-facing dispatch API (stable for third-party policies)
    # ------------------------------------------------------------------
    def dispatch(self, chunk: Chunk, engines: List[_Engine], t: float,
                 harvested: bool = False) -> None:
        """Start ``chunk`` on one or more free engines at time ``t``."""
        if len(engines) == 1:
            # single source of truth for the 1-engine case
            self._dispatch1(chunk, engines[0], t, harvested)
            return
        token = next(self._tok)
        n = len(engines)
        dur = self._duration(chunk, n)
        chunk.n_dispatched = n
        end = t + dur
        fast = self.fast_path
        inc = self._inc
        for e in engines:
            if inc:
                self._free_idx_remove(e)
            e.token = token
            e.chunk = chunk
            e.tenant = chunk.tenant
            e.start = t
            e.end = end
            e.harvested = harvested
            if fast and e.owner is not None and e.owner != chunk.tenant:
                self._squat[e.owner] = self._squat.get(e.owner, 0) + 1
        if fast:
            self._bw_register(chunk)
        lead = engines[0]
        heapq.heappush(
            self._heap, (end, next(self._seq), lead.kind, lead.eid, token))

    def _dispatch1(self, chunk: Chunk, e: _Engine, t: float,
                   harvested: bool = False) -> None:
        """Single-engine dispatch (same semantics as
        ``dispatch(chunk, [e], t, harvested)``, which delegates here —
        the hot schedule pass calls it directly to skip the list
        plumbing, and the common compute-only μTOp duration is
        inlined)."""
        token = next(self._tok)
        fast = self.fast_path
        if (fast and chunk.hbm_bytes <= 0
                and self.tenants[chunk.tenant].is_neuisa):
            dur = chunk.cycles + chunk.penalty
        else:
            dur = self._duration(chunk, 1)
            if fast:
                self._bw_register(chunk)
        chunk.n_dispatched = 1
        if self._inc:
            self._free_idx_remove(e)
        e.token = token
        e.chunk = chunk
        e.tenant = chunk.tenant
        e.start = t
        end = t + dur
        e.end = end
        e.harvested = harvested
        if fast and e.owner is not None and e.owner != chunk.tenant:
            self._squat[e.owner] = self._squat.get(e.owner, 0) + 1
        heapq.heappush(
            self._heap, (end, next(self._seq), e.kind, e.eid, token))

    def _bw_register(self, chunk: Chunk) -> None:
        """Incremental HBM-contention bookkeeping (fast path): the
        chunk is a bandwidth contender iff it is memory-paced (ties
        count — see :meth:`_mem_pressure`)."""
        if (chunk.hbm_bytes > 0
                and chunk.hbm_bytes / self._bpc >= chunk.cycles):
            self._bw_inflight[id(chunk)] = chunk.tenant
            self._bw_per_tenant[chunk.tenant] = \
                self._bw_per_tenant.get(chunk.tenant, 0) + 1

    def preempt(self, eng: _Engine, t: float,
                blocked_owner: Optional[int] = None) -> None:
        """Preempt the chunk on `eng` (and sibling engines for VLIW
        ops): remaining work returns to its tenant's ready queue with
        the context-switch penalty; engines drain for ctx cycles.
        ``blocked_owner``: tenant reclaiming its engine — it eats the
        drain window (Table III 'blocked because harvested')."""
        chunk = eng.chunk
        if chunk.cohort:
            # members carry 1, the lead carries n: either way the
            # engine shares its completion token with siblings, and
            # preempting one would orphan the rest. Unreachable from
            # the in-tree policies (cohorts run on the owner's OWN
            # engines, which reclaim never targets) — fail loudly for
            # third-party policies instead of hanging.
            raise RuntimeError(
                "cannot preempt a cohort member: cohorts run on owner "
                "engines, which policies must not reclaim")
        engines = self._engines_of(chunk, eng)
        if self._bw_inflight:
            self._bw_unregister(chunk)
        # VE state is tiny vs the 256-cycle systolic drain (§III-G)
        ctx = float(self.core.ctx_switch_cycles if chunk.kind == ME else 32)
        # VLIW ops span every ME: their contexts drain serially through
        # the shared SRAM port — V10 "needs to preempt the entire
        # operator from ALL MEs" (§V-C), Neu10 only the harvested one.
        ctx *= len(engines)
        frac_done = (t - eng.start) / max(eng.end - eng.start, EPS)
        frac_done = min(max(frac_done, 0.0), 1.0)
        rt = self.tenants[eng.tenant]
        remaining = Chunk(
            chunk.tenant, chunk.kind, chunk.cycles * (1 - frac_done),
            chunk.hbm_bytes * (1 - frac_done), chunk.op_name,
            n_engines=chunk.n_engines, penalty=ctx,
            group_key=chunk.group_key, from_me_group=chunk.from_me_group,
            phase=chunk.phase)
        (rt.ready_me if chunk.kind == ME else rt.ready_ve).insert(0, remaining)
        rt.stats.preemptions += 1
        if blocked_owner is not None:
            self.tenants[blocked_owner].stats.reclaim_blocked += ctx
        # account the completed fraction as useful work
        if chunk.kind == ME:
            rt.stats.me_work += chunk.cycles * frac_done
            if eng.harvested:
                rt.stats.harvested_me_work += chunk.cycles * frac_done
        else:
            rt.stats.ve_work += chunk.cycles * frac_done
        rt.active_cycles += chunk.cycles * frac_done / max(chunk.n_engines, 1)
        # engines drain their state for ctx cycles
        token = next(self._tok)
        for e in engines:
            self._unsquat(e, chunk.tenant)
            e.token = token
            e.chunk = None
            e.tenant = -1
            e.start = t
            e.end = t + ctx
            e.harvested = False
        heapq.heappush(
            self._heap,
            (t + ctx, next(self._seq), engines[0].kind, engines[0].eid,
             token))
        # the preempted chunk's pending completion entry is now stale
        # (engines carry the drain token); its remaining work landed
        # back on the tenant's ready queue
        self._stale += 1
        if self._inc:
            self._dirty.add(chunk.tenant)
        self._maybe_compact()

    # back-compat aliases (pre-registry internal names)
    _dispatch = dispatch
    _preempt = preempt

    # ------------------------------------------------------------------
    # incremental scheduling plumbing (see docs/architecture.md,
    # "Event engine")
    # ------------------------------------------------------------------
    def mark_dirty(self, idx: int = -1) -> None:
        """Force the next schedule pass to run. Third-party policies
        using ``schedule_incremental`` must call this whenever they
        stash enabling state OUTSIDE the ready queues / engine pools
        (those are marked automatically); ``idx`` is the affected
        tenant, -1 for a global change."""
        self._dirty.add(idx)

    def _rebuild_free_index(self) -> None:
        """Recompute the per-owner free-engine index from engine state
        (ownership changed — tenant add/remove/resize)."""
        me: Dict[Optional[int], List[_Engine]] = {}
        for e in self.mes:
            if e.token < 0:
                me.setdefault(e.owner, []).append(e)
        ve: Dict[Optional[int], List[_Engine]] = {}
        for e in self.ves:
            if e.token < 0:
                ve.setdefault(e.owner, []).append(e)
        self._free_me_own = me
        self._free_ve_own = ve
        self._nfree_me = sum(len(v) for v in me.values())
        self._nfree_ve = sum(len(v) for v in ve.values())

    def _free_idx_add(self, e: _Engine) -> None:
        """Engine freed: insert into its owner's bucket keeping eid
        order (buckets are at most pool-sized, so a shift insert beats
        re-sorting)."""
        if e.kind == ME:
            d = self._free_me_own
            self._nfree_me += 1
        else:
            d = self._free_ve_own
            self._nfree_ve += 1
        lst = d.get(e.owner)
        if lst is None:
            d[e.owner] = [e]
            return
        eid = e.eid
        i = len(lst)
        while i and lst[i - 1].eid > eid:
            i -= 1
        lst.insert(i, e)

    def _free_idx_remove(self, e: _Engine) -> None:
        """Engine goes busy: drop it from its owner's bucket."""
        if e.kind == ME:
            self._free_me_own[e.owner].remove(e)
            self._nfree_me -= 1
        else:
            self._free_ve_own[e.owner].remove(e)
            self._nfree_ve -= 1

    def _maybe_compact(self) -> None:
        if (self._stale >= self.HEAP_COMPACT_MIN
                and self._stale * 2 >= len(self._heap)):
            self._compact_heap()

    def _compact_heap(self) -> None:
        """Sweep lazily-deleted entries (stale engine tokens) out of
        the event heap. Pop ORDER of surviving entries is unchanged —
        the heap orders on the (t, seq) prefix, which compaction
        preserves — so results are identical; only ``max_events``
        accounting changes (stale pops no longer count).

        Compaction mutates ``self._heap`` IN PLACE: the event loop and
        scheduling passes bind local aliases to the heap list, and a
        compaction can fire mid-pass (``preempt`` during a reclaim).
        Rebinding to a fresh list would split pushes and pops across
        two heaps and silently drop live events."""
        mes, ves = self.mes, self.ves
        keep = []
        for ev in self._heap:
            kind = ev[2]
            if kind == ME:
                if mes[ev[3]].token != ev[4]:
                    continue
            elif kind == VE:
                if ves[ev[3]].token != ev[4]:
                    continue
            keep.append(ev)
        self._heap[:] = keep
        heapq.heapify(self._heap)
        self._stale = 0

    def _schedule(self, t: float) -> None:
        if self._inc:
            d = self._dirty
            if not d:
                return
            # snapshot-and-clear keeps the set OBJECT alive (tenant
            # sinks hold a reference); marks made during the pass
            # (reclaim preemptions) land in the live set and trigger
            # the next one
            snap = set(d)
            d.clear()
            self._inc_fn(self, t, snap)
        else:
            self.policy_obj.schedule(self, t)


# ----------------------------------------------------------------------
def run_collocation(
    specs: Sequence[TenantSpec],
    policy: PolicyLike,
    core: NPUCoreConfig = DEFAULT_CORE,
    hbm_scale: float = 1.0,
) -> SimResult:
    return Simulator(specs, policy=policy, core=core,
                     hbm_scale=hbm_scale).run()
