"""NeuISA compiler (§III-D "Compiler support").

Lowers a WorkloadTrace (operator list) into

* a ``NeuISAProgram``: each ME-bearing operator is partitioned into
  up to n_x ME μTOps (ROLLER-style tile partitioning — here the tile
  counts come from the cost model, which uses the same 128-aligned
  tiling as the Pallas kernels in ``repro/kernels``); each μTOp is
  compiled "for a fictional NPU with one ME and n_y VEs". Fused VE
  epilogues ride in the group's VE μTOp (pipelined with the MEs).
  Operators whose tiling cut the reduction dimension get a trailing
  VE-reduce group — the Fig. 16 overhead case (no ME/VE pipelining
  across the group boundary).

* a ``VLIWProgram``: the baseline lowering where each operator's
  instruction stream statically couples n_me_static MEs (what PMT/V10
  schedule).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.neuisa import (
    ME,
    VE,
    MuTOp,
    MuTOpGroup,
    NeuISAProgram,
    VLIWOp,
    VLIWProgram,
)
from repro_torch.npu.cost_model import (PIGGYBACK_POS_QUANT, Operator, RequestPlan,
                                  WorkloadTrace)
from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig


class _SnippetTable:
    """Deduplicates μTOp code snippets (§III-D code-inflation note):
    μTOps that execute the same code (same op, same tile shape) share
    one snippet; only the μTOp index register differs."""

    def __init__(self):
        self._table: Dict[Tuple, int] = {}

    def get(self, key: Tuple) -> int:
        if key not in self._table:
            self._table[key] = len(self._table)
        return self._table[key]


def compile_neuisa(
    trace: WorkloadTrace,
    core: NPUCoreConfig = DEFAULT_CORE,
    n_x: Optional[int] = None,
    n_y: Optional[int] = None,
) -> NeuISAProgram:
    n_x = n_x or core.n_me
    n_y = n_y or core.n_ve
    snip = _SnippetTable()
    groups: List[MuTOpGroup] = []

    for op in trace.ops:
        if op.kind == "me":
            p = max(1, min(n_x, op.n_tiles))
            me_share = op.me_cycles / p
            hbm_share = op.hbm_bytes / p
            sid = snip.get((op.name.split("_")[0], "me", round(me_share, 3)))
            g = MuTOpGroup(op_name=op.name)
            for i in range(p):
                g.me_utops.append(
                    MuTOp(ME, me_share, hbm_share, op.name, sid)
                )
            if op.reduction_split:
                # drain VE work stays fused; the cross-partition SUM
                # must wait for every partial -> its own group.
                drain = max(op.ve_cycles - _reduce_cycles(op, p, core), 0.0)
                if drain > 0:
                    g.ve_utop = MuTOp(
                        VE, drain, 0.0, op.name,
                        snip.get((op.name, "ve_drain")),
                    )
                groups.append(g)
                groups.append(
                    MuTOpGroup(
                        ve_utop=MuTOp(
                            VE, _reduce_cycles(op, p, core), 0.0,
                            f"{op.name}:reduce",
                            snip.get((op.name, "ve_reduce")),
                        ),
                        op_name=f"{op.name}:reduce",
                    )
                )
            else:
                if op.ve_cycles > 0:
                    g.ve_utop = MuTOp(
                        VE, op.ve_cycles, 0.0, op.name,
                        snip.get((op.name, "ve_fused")),
                    )
                groups.append(g)
        else:  # ve / mem operator -> one VE μTOp group
            groups.append(
                MuTOpGroup(
                    ve_utop=MuTOp(
                        VE, op.ve_cycles, op.hbm_bytes, op.name,
                        snip.get((op.name.split("_")[0], "ve",
                                  round(op.ve_cycles, 3))),
                    ),
                    op_name=op.name,
                )
            )

    prog = NeuISAProgram(
        name=trace.name, groups=groups, n_x=n_x, n_y=n_y,
        source_ops=len(trace.ops),
    )
    prog.validate()
    return prog


def _reduce_cycles(op: Operator, p: int, core: NPUCoreConfig) -> float:
    """VE cycles to sum p partial outputs ((p-1) adds per element)."""
    return op.out_elems * max(p - 1, 0) / core.ve_elems_per_cycle


def compile_vliw(
    trace: WorkloadTrace,
    core: NPUCoreConfig = DEFAULT_CORE,
    max_mes: Optional[int] = None,
    n_x: Optional[int] = None,
    n_y: Optional[int] = None,
) -> VLIWProgram:
    """Baseline lowering: the compiler bakes the ME count into the
    instruction stream (Fig. 9's rigidity).

    ``max_mes`` is the ME count the program is compiled FOR — the
    tenant's vNPU size. Under V10's temporal sharing an op then
    occupies the whole physical array while only exploiting
    ``min(max_mes, n_tiles)`` MEs (the paper's false contention);
    under PMT the whole core is the vNPU, so ``max_mes`` defaults to
    the core width."""
    n_x = n_x or core.n_me
    n_y = n_y or core.n_ve
    cap = max_mes or n_x
    ops: List[VLIWOp] = []
    for op in trace.ops:
        if op.kind == "me":
            p = max(1, min(cap, op.n_tiles))
            ops.append(VLIWOp(op.name, p, op.me_cycles, op.ve_cycles,
                              op.hbm_bytes))
        else:
            ops.append(VLIWOp(op.name, 0, 0.0, op.ve_cycles, op.hbm_bytes))
    return VLIWProgram(name=trace.name, ops=ops, n_x=n_x, n_y=n_y)


# ----------------------------------------------------------------------
# phase-aware compilation: one program per (phase, context bucket)
# ----------------------------------------------------------------------
AnyProgram = Union[NeuISAProgram, VLIWProgram]

PREFILL = "prefill"
DECODE = "decode"
PIGGYBACK = "piggyback"   # one fused prefill-chunk + decode-batch program
SWAPIN = "swapin"         # KV restore of an evicted (swapped) request
PREFIX = "prefix"         # suffix-only prefill over a shared resident prefix


@dataclass
class CompiledPhase:
    """One phase of a compiled request: the program the scheduler
    replays for it, plus the context it was compiled at (``context``
    is in TOKENS: the decode bucket ceiling, or — for a prefill chunk
    — the prompt tokens ingested once this chunk completes).
    ``est_cycles`` is the phase trace's ideal-parallel lower bound on
    the full core (cycles) — the per-step service estimate
    PREMA-style eviction victim selection multiplies by
    tokens-remaining."""

    kind: str                    # "prefill" | "decode" | "" (legacy)
    program: AnyProgram
    context: int = 0
    est_cycles: float = 0.0


@dataclass
class CompiledRequestPlan:
    """Compiled :class:`~repro_torch.npu.cost_model.RequestPlan`: the
    prefill program(s) plus one decode program per context bucket.
    The simulator walks a request's phase chain through these; a plan
    without decode phases is the degenerate single-phase case (seed
    behavior).

    Chunked prefill (``RequestPlan.prefill_chunk_tokens``) compiles
    one program per chunk into ``prefill_chunks`` (ingestion order);
    ``prefill`` is then the first chunk. Monolithic plans leave
    ``prefill_chunks`` empty — :meth:`prefill_phases` abstracts over
    both shapes.

    Piggybacked iterations (``iteration_token_budget`` > 0) cannot be
    pre-compiled — the (slice tokens, position, decode batch) mix is
    only known at iteration start — so :meth:`piggyback_phase` builds
    and compiles them on demand through the shared
    :class:`ProgramCache`, memoizing per quantized key: slice tokens
    (rounded up to ``PIGGYBACK_TOKEN_QUANT``), prior-context position
    (rounded up to ``PIGGYBACK_POS_QUANT``), decode-batch bucket
    (power of two) and decode-context bucket. The cache therefore
    holds a bounded program set per (model shape, budget, ISA),
    shared across requests and tenants like every other phase
    program."""

    name: str
    prefill: CompiledPhase
    decode: List[CompiledPhase] = field(default_factory=list)
    prompt_len: int = 0          # tokens
    gen_len: int = 1             # default tokens generated per request
    prefill_chunks: List[CompiledPhase] = field(default_factory=list)
    # adaptive piggybacked iterations (0 = off); `_piggyback` is the
    # on-demand (build trace -> compile via shared cache) factory set
    # by compile_request_plan for plans that carry a builder
    iteration_token_budget: int = 0
    _piggyback: Optional[Callable[..., AnyProgram]] = \
        field(default=None, repr=False, compare=False)
    _piggy_memo: Dict[Tuple, CompiledPhase] = \
        field(default_factory=dict, repr=False, compare=False)
    # live KV-cache accounting (bytes; 0 disables the ledger path) —
    # see RequestPlan.kv_token_bytes. `_swapin` builds the HBM
    # re-read program an evicted request replays on resume, one per
    # decode context bucket through the shared cache.
    kv_token_bytes: float = 0.0
    weight_bytes: float = 0.0
    _swapin: Optional[Callable[[int], AnyProgram]] = \
        field(default=None, repr=False, compare=False)
    _swapin_memo: Dict[int, CompiledPhase] = \
        field(default_factory=dict, repr=False, compare=False)
    # cross-request shared KV prefix (0 = off); `_prefix` builds the
    # suffix-only prefill program for a quantized cached-token count
    prefix_len: int = 0
    _prefix: Optional[Callable[[int], AnyProgram]] = \
        field(default=None, repr=False, compare=False)
    _prefix_memo: Dict[int, CompiledPhase] = \
        field(default_factory=dict, repr=False, compare=False)

    @property
    def has_decode(self) -> bool:
        return bool(self.decode)

    @property
    def chunked(self) -> bool:
        return bool(self.prefill_chunks)

    @property
    def n_prefill_chunks(self) -> int:
        """Prefill phases per request (1 when monolithic)."""
        return len(self.prefill_chunks) or 1

    def prefill_phases(self) -> List[CompiledPhase]:
        """The prefill phase chain a request walks, in order."""
        return list(self.prefill_chunks) or [self.prefill]

    def decode_phase_for(self, context: int) -> CompiledPhase:
        """Decode phase covering a step at ``context`` tokens; clamps
        to the largest precompiled bucket for out-of-coverage
        requests."""
        if not self.decode:
            raise ValueError(
                f"plan {self.name!r} has no decode phases")
        for ph in self.decode:
            if context <= ph.context:
                return ph
        return self.decode[-1]   # clamp: out-of-coverage contexts

    @property
    def can_piggyback(self) -> bool:
        """True when on-demand piggyback programs are available."""
        return self._piggyback is not None

    def piggyback_phase(self, chunk_tokens: int, kv_prior: int,
                        decode_batch: int, decode_ctx: int,
                        final: bool = False,
                        decode_groups: Optional[Tuple[Tuple[int, int], ...]]
                        = None) -> CompiledPhase:
        """Fused (prefill slice + decode batch) phase for one budgeted
        iteration, compiled on first use and memoized. Callers pass
        QUANTIZED arguments (the simulator quantizes; see the class
        docstring) — the exact token bookkeeping stays with the
        runtime, these programs are the cost proxy.

        ``decode_groups`` (``((batch_bucket, ctx_bucket), ...)``,
        sorted) costs each rider's decode share at ITS OWN context
        bucket instead of the largest live bucket — the simulator
        passes it whenever the live batch straddles buckets; the
        legacy single-bucket arguments stay the calling convention
        (and cache key) when it doesn't, so single-bucket programs
        are byte-identical to the pre-grouping compiler. The memo
        stays bounded either way: group tuples are drawn from the
        finite (bucket x batch-bucket) grid.

        ``context`` on the returned phase is the prompt tokens
        ingested once the slice completes (cost-grid tokens, not
        exact)."""
        if self._piggyback is None:
            raise ValueError(
                f"plan {self.name!r} was compiled without a piggyback "
                f"builder (non-generative RequestPlan)")
        key = (chunk_tokens, kv_prior, decode_batch, decode_ctx, final,
               decode_groups)
        ph = self._piggy_memo.get(key)
        if ph is None:
            ph = CompiledPhase(
                PIGGYBACK,
                self._piggyback(chunk_tokens, kv_prior, decode_batch,
                                decode_ctx, final,
                                decode_groups=decode_groups),
                context=kv_prior + chunk_tokens)
            self._piggy_memo[key] = ph
        return ph

    @property
    def kv_prompt_bytes(self) -> float:
        """KV bytes the whole prompt writes (the cumulative
        prefill-side charge; admission must test THIS against the KV
        budget, not a single chunk's share)."""
        return self.prompt_len * self.kv_token_bytes

    @property
    def can_swapin(self) -> bool:
        """True when on-demand KV-restore programs are available."""
        return self._swapin is not None

    def swapin_phase(self, context: int) -> CompiledPhase:
        """KV-restore phase for an evicted request resuming at
        ``context`` tokens, compiled per decode bucket on first use
        (the re-read is costed at the bucket ceiling, like every
        decode-side program; the ledger's byte bookkeeping stays
        exact)."""
        if self._swapin is None:
            raise ValueError(
                f"plan {self.name!r} was compiled without a swap-in "
                f"builder (no live KV accounting)")
        bucket = (self.decode_phase_for(context).context
                  if self.decode else context)
        ph = self._swapin_memo.get(bucket)
        if ph is None:
            ph = CompiledPhase(SWAPIN, self._swapin(bucket),
                               context=bucket)
            self._swapin_memo[bucket] = ph
        return ph

    @property
    def can_prefix(self) -> bool:
        """True when on-demand shared-prefix programs are available."""
        return self._prefix is not None

    def prefix_phase(self, cached_tokens: int) -> CompiledPhase:
        """Suffix-only prefill phase for a request whose leading
        ``cached_tokens`` are already resident in a shared ledger
        entry. The cached count quantizes DOWN to the
        ``PIGGYBACK_POS_QUANT`` grid (never skipping tokens the cost
        proxy didn't pay for), so the memo holds one program per grid
        point; the ledger's byte bookkeeping stays exact."""
        if self._prefix is None:
            raise ValueError(
                f"plan {self.name!r} was compiled without a prefix "
                f"builder (no shared-prefix support)")
        q = PIGGYBACK_POS_QUANT
        cached = max(min(int(cached_tokens), self.prompt_len - 1), 0)
        cached = (cached // q) * q
        ph = self._prefix_memo.get(cached)
        if ph is None:
            ph = CompiledPhase(PREFIX, self._prefix(cached),
                               context=self.prompt_len)
            self._prefix_memo[cached] = ph
        return ph


class ProgramCache:
    """Per-(phase, context-bucket) compiled-program cache (§III-D).

    Decode programs at context 512 / 1k / 2k / ... are identical for
    every request — and for every tenant serving the same model shape —
    so they compile once. Keyed by (isa, trace name, op count, work
    totals, core): trace names embed model:phase:bNsM, and the ME/VE/
    HBM totals (cycles, cycles, bytes) fingerprint the content so a
    rebuilt or hand-scaled trace that reuses a name cannot collide
    with another shape's program. Prefill chunk traces embed their
    prior-context offset (…:bNkP+C), so a chunk program likewise
    compiles once per (model shape, chunk size, position, ISA) and is
    shared by every request and tenant with that shape. Piggybacked
    iteration traces embed their full quantized mix
    (...:piggy:bNkP+C[f]+dB@CTX — slice tokens, position,
    decode-batch bucket, decode-context bucket), so the budgeted path
    adds one program per quantized grid point, not per live
    iteration.
    """

    def __init__(self) -> None:
        self._cache: Dict[Tuple, AnyProgram] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._cache)

    def compile(self, trace: WorkloadTrace, core: NPUCoreConfig,
                isa: str = "neuisa") -> AnyProgram:
        """Compile ``trace`` for ``isa`` (``"neuisa"`` μTOp groups or
        ``"vliw"`` whole operators), returning the cached program when
        an identical (name, op count, cycle/byte totals, core) build
        exists."""
        key = (isa, trace.name, len(trace.ops), trace.totals(), core)
        prog = self._cache.get(key)
        if prog is not None:
            self.hits += 1
            return prog
        self.misses += 1
        prog = (compile_neuisa(trace, core) if isa == "neuisa"
                else compile_vliw(trace, core))
        self._cache[key] = prog
        return prog


def compile_request_plan(
    plan: RequestPlan,
    core: NPUCoreConfig = DEFAULT_CORE,
    isa: str = "neuisa",
    cache: Optional[ProgramCache] = None,
) -> CompiledRequestPlan:
    """Lower a phase-structured request into per-phase programs,
    reusing ``cache`` across buckets / requests / tenants."""
    cache = cache if cache is not None else ProgramCache()
    chunks: List[CompiledPhase] = []
    if plan.prefill_chunks:
        # one program per chunk position — the cache collapses these
        # across requests/tenants of the same (shape, chunk size, ISA)
        ingested = 0
        step = plan.prefill_chunk_tokens or plan.prompt_len
        for tr in plan.prefill_chunks:
            ingested = min(ingested + step, plan.prompt_len)
            chunks.append(CompiledPhase(PREFILL,
                                        cache.compile(tr, core, isa),
                                        context=ingested))
        prefill = chunks[0]
    else:
        prefill = CompiledPhase(PREFILL,
                                cache.compile(plan.prefill, core, isa),
                                context=plan.prompt_len)
    decode = [CompiledPhase(DECODE, cache.compile(tr, core, isa),
                            context=ctx,
                            est_cycles=tr.ideal_cycles(core.n_me, core.n_ve))
              for ctx, tr in plan.decode]
    piggyback = None
    if plan.piggyback_builder is not None:
        builder = plan.piggyback_builder

        def piggyback(chunk_tokens: int, kv_prior: int, decode_batch: int,
                      decode_ctx: int, final: bool,
                      decode_groups=None) -> AnyProgram:
            tr = builder(chunk_tokens, kv_prior, decode_batch, decode_ctx,
                         final, decode_groups=decode_groups)
            return cache.compile(tr, core, isa)

    swapin = None
    if plan.swapin_builder is not None:
        swapin_builder = plan.swapin_builder

        def swapin(context: int) -> AnyProgram:
            return cache.compile(swapin_builder(context), core, isa)

    prefix = None
    if plan.prefix_builder is not None and plan.prefix_len > 0:
        prefix_builder = plan.prefix_builder

        def prefix(cached: int) -> AnyProgram:
            return cache.compile(prefix_builder(cached), core, isa)

    return CompiledRequestPlan(
        name=plan.name, prefill=prefill, decode=decode,
        prompt_len=plan.prompt_len, gen_len=plan.gen_len,
        prefill_chunks=chunks,
        iteration_token_budget=plan.iteration_token_budget,
        _piggyback=piggyback,
        kv_token_bytes=plan.kv_token_bytes,
        weight_bytes=plan.weight_bytes,
        _swapin=swapin,
        prefix_len=plan.prefix_len if plan.prefix_builder is not None else 0,
        _prefix=prefix,
    )


def neuisa_overhead_terms(trace: WorkloadTrace,
                          core: NPUCoreConfig = DEFAULT_CORE
                          ) -> Tuple[float, float]:
    """Analytic single-tenant makespans (VLIW vs NeuISA) used by the
    Fig. 16 benchmark; the simulator measures the same quantity
    dynamically."""
    n_x, n_y = core.n_me, core.n_ve
    t_vliw = t_neu = 0.0
    for op in trace.ops:
        p = max(1, min(n_x, op.n_tiles))
        me = op.me_cycles / p
        ve = op.ve_cycles / n_y
        hbm = op.hbm_bytes / core.hbm_bytes_per_cycle
        t_vliw += max(me, ve, hbm)
        if op.reduction_split:
            red = _reduce_cycles(op, p, core) / n_y
            t_neu += max(me, ve - red, hbm) + red
        else:
            t_neu += max(me, ve, hbm)
    return t_vliw, t_neu
